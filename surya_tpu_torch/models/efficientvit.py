"""EfficientViT-large semantic segmentation for text-line detection, in PyTorch.

Counterpart of surya_tpu/models/efficientvit.py, with the same structure and
parameter names: stem (stride 2) + 4 stages (each stride 2); stages 1-2 are
FusedMBConv stacks, stage 3 an MBConv stack, stage 4 interleaves LiteMLA
linear attention with MBConv; a SegFormer-style decode head fuses the four
stage outputs at 1/4 resolution into 2 logit channels (text + vertical).

The JAX model is NHWC with HWIO kernels; this one is NCHW with OIHW kernels
(``nn.load_jax_params`` transposes). The decode head's per-stage ``linear_c``
(a linear over the channels of an NHWC map) is applied as a 1x1 convolution
with the linear's weight. Convolutions and matmuls are plain PyTorch calls:
the JAX package leaves them to XLA, outside any Pallas kernel. Inference
batch-norm is folded into a per-channel scale and bias.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from surya_tpu_torch import nn as pnn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class EfficientViTConfig:
    num_classes: int = 2
    num_channels: int = 3
    widths: Tuple[int, ...] = (32, 64, 128, 256, 512)
    head_dim: int = 32
    depths: Tuple[int, ...] = (1, 1, 1, 6, 6)
    strides: Tuple[int, ...] = (2, 2, 2, 2, 2)
    layer_norm_eps: float = 1e-6
    decoder_layer_hidden_size: int = 128
    decoder_hidden_size: int = 512
    image_size: Tuple[int, int] = (896, 896)  # (height, width) processor size


_ACT = {None: lambda x: x, "hardswish": pnn.hardswish}


class ConvNormAct(nn.Module):
    """Conv (torch padding) + optional folded batch-norm + activation; the
    JAX leaf {"conv": {...}, "norm": {...}}."""

    def __init__(self, in_ch, out_ch, k, stride=1, groups=1, bias=False, norm=True, act=None):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, k, stride, pnn.torch_conv_padding(k, stride), groups=groups, bias=bias)
        self.norm = pnn.FoldedBatchNorm(out_ch) if norm else None
        self.act = _ACT[act]

    def forward(self, x):
        y = self.conv(x)
        if self.norm is not None:
            y = self.norm(y)
        return self.act(y)


class ConvBlock(nn.Module):
    """expand_ratio=1 "large" block of the stem: two 3x3 convs."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv1 = ConvNormAct(in_ch, in_ch, 3, act="hardswish")
        self.conv2 = ConvNormAct(in_ch, out_ch, 3)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class FusedMBConv(nn.Module):
    def __init__(self, in_ch, out_ch, expand, k=3, stride=1):
        super().__init__()
        mid = round(in_ch * expand)
        self.spatial_conv = ConvNormAct(in_ch, mid, k, stride, act="hardswish")
        self.point_conv = ConvNormAct(mid, out_ch, 1)

    def forward(self, x):
        return self.point_conv(self.spatial_conv(x))


class MBConv(nn.Module):
    """fewer_norm variant: bias on the first two convs, norm only on the point conv."""

    def __init__(self, in_ch, out_ch, expand, k=3, stride=1):
        super().__init__()
        mid = round(in_ch * expand)
        self.inverted_conv = ConvNormAct(in_ch, mid, 1, bias=True, norm=False, act="hardswish")
        self.depth_conv = ConvNormAct(mid, mid, k, stride, groups=mid, bias=True, norm=False, act="hardswish")
        self.point_conv = ConvNormAct(mid, out_ch, 1)

    def forward(self, x):
        return self.point_conv(self.depth_conv(self.inverted_conv(x)))


class LiteMLA(nn.Module):
    """Multi-scale linear attention. The qkv channels are head-major (channel
    h*3d+j holds q, k or v of head h), and so are those of the aggregated
    branch, so their concatenation splits into 2*heads heads of 3d channels."""

    def __init__(self, ch, head_dim, eps: float = 1e-5):
        super().__init__()
        heads = ch // head_dim
        total = heads * head_dim
        self.head_dim, self.eps = head_dim, eps
        self.qkv = ConvNormAct(ch, 3 * total, 1, norm=False)
        self.aggreg_dw = nn.Conv2d(3 * total, 3 * total, 5, padding=pnn.torch_conv_padding(5),
                                   groups=3 * total, bias=False)
        self.aggreg_pw = nn.Conv2d(3 * total, 3 * total, 1, groups=3 * heads, bias=False)
        self.proj = ConvNormAct(2 * total, ch, 1)

    def forward(self, x):
        B, _, H, W = x.shape
        qkv = self.qkv(x)
        multi = torch.cat([qkv, self.aggreg_pw(self.aggreg_dw(qkv))], dim=1)  # B, 2*3*total, H, W
        d = self.head_dim
        n_heads = multi.shape[1] // (3 * d)
        h = multi.reshape(B, n_heads, 3 * d, H * W).transpose(2, 3)  # B, heads, HW, 3d
        q, k, v = h.split(d, dim=-1)
        # fp32 island (the reference casts to float)
        q, k = F.relu(q).float(), F.relu(k).float()
        v = F.pad(v.float(), (0, 1), value=1.0)
        kv = torch.matmul(k.transpose(2, 3), v)  # d x (d+1)
        out = torch.matmul(q, kv)
        out = (out[..., :-1] / (out[..., -1:] + self.eps)).to(x.dtype)
        return self.proj(out.transpose(2, 3).reshape(B, n_heads * d, H, W))


class EViTBlock(nn.Module):
    def __init__(self, ch, head_dim):
        super().__init__()
        self.attn = LiteMLA(ch, head_dim)
        self.mlp = MBConv(ch, ch, 6, 3)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp(x)


class _Stem(nn.Module):
    def __init__(self, config: EfficientViTConfig):
        super().__init__()
        w0 = config.widths[0]
        self.depth = config.depths[0]
        self.in_conv = ConvNormAct(config.num_channels, w0, 3, config.strides[0], act="hardswish")
        for d in range(self.depth):
            setattr(self, f"res{d}", ConvBlock(w0, w0))

    def forward(self, x):
        x = self.in_conv(x)
        for d in range(self.depth):
            x = x + getattr(self, f"res{d}")(x)
        return x


class _Stage(nn.Module):
    """blocks[0] = {"down": ...}; then {"fused"|"mb"|"vit": ...} per block."""

    def __init__(self, i: int, in_ch: int, width: int, depth: int, stride: int, head_dim: int):
        super().__init__()
        vit_stage, fewer_norm = i >= 3, i >= 2
        if fewer_norm:
            down = MBConv(in_ch, width, 24 if vit_stage else 16, 3, stride)
        else:
            down = FusedMBConv(in_ch, width, 16, 3, stride)
        blocks = [nn.ModuleDict({"down": down})]
        for _ in range(depth):
            if vit_stage:
                blocks.append(nn.ModuleDict({"vit": EViTBlock(width, head_dim)}))
            elif fewer_norm:
                blocks.append(nn.ModuleDict({"mb": MBConv(width, width, 4, 3)}))
            else:
                blocks.append(nn.ModuleDict({"fused": FusedMBConv(width, width, 4, 3)}))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        x = self.blocks[0]["down"](x)
        for block in self.blocks[1:]:
            kind, mod = next(iter(block.items()))
            x = mod(x) if kind == "vit" else x + mod(x)  # an EViT block adds its own residuals
        return x


class _Head(nn.Module):
    def __init__(self, config: EfficientViTConfig):
        super().__init__()
        dl, dh = config.decoder_layer_hidden_size, config.decoder_hidden_size
        self.linear_c = nn.ModuleList(nn.Linear(w, dl) for w in config.widths[1:])
        self.linear_fuse = nn.Conv2d(4 * dl, dh, 1, bias=False)
        self.batch_norm = pnn.FoldedBatchNorm(dh)
        self.classifier = nn.Conv2d(dh, config.num_classes, 1)

    def forward(self, feats: List[torch.Tensor]):
        target_hw = feats[0].shape[-2:]
        fused = []
        for f, lin in zip(feats, self.linear_c):
            h = F.conv2d(f, lin.weight[:, :, None, None], lin.bias)  # the JAX linear over NHWC channels
            if h.shape[-2:] != target_hw:
                h = pnn.bilinear_resize(h, target_hw)
            fused.append(h)
        x = self.linear_fuse(torch.cat(fused[::-1], dim=1))
        return self.classifier(F.relu(self.batch_norm(x)))


class EfficientViT(nn.Module):
    """Submodule names follow surya_tpu efficientvit.init_params' pytree."""

    def __init__(self, config: EfficientViTConfig):
        super().__init__()
        self.config = config
        self.stem = _Stem(config)
        w = config.widths
        self.stages = nn.ModuleList(
            _Stage(i, w[i], w[i + 1], config.depths[i + 1], config.strides[i + 1], config.head_dim)
            for i in range(len(w) - 1)
        )
        self.head = _Head(config)

    def forward_logits(self, pixel_values):
        """pixel_values: [B, 3, H, W] float in [0, 1]. Returns the raw
        decode-head logits at 1/4 resolution [B, num_classes, H/4, W/4]."""
        # the constants are made on the device: a copy from pageable host
        # memory would make the host wait for the stream
        mean, std = (
            torch.cat([torch.full((1,), c, dtype=pixel_values.dtype, device=pixel_values.device) for c in cs])
            for cs in (IMAGENET_MEAN, IMAGENET_STD)
        )
        x = self.stem((pixel_values - mean[:, None, None]) / std[:, None, None])
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return self.head(feats)

    def apply_heat(self, pixel_values):
        """Sigmoid heatmaps (float32) at the decode head's 1/4 resolution."""
        return torch.sigmoid(self.forward_logits(pixel_values).float())


# -- checkpoint conversion ----------------------------------------------------

def convert_torch(tensors, config: EfficientViTConfig) -> dict:
    """The upstream torch checkpoint (EfficientViTForSemanticSegmentation's
    state dict) as surya_tpu efficientvit.init_params' pytree, numpy leaves
    in the JAX layout (surya_tpu efficientvit.convert_torch). Backbone BN
    uses eps=layer_norm_eps, the decode head's BN torch's default 1e-5."""
    from surya_tpu_torch.common.weights import TensorBag

    bag = tensors if isinstance(tensors, TensorBag) else TensorBag(tensors)
    eps = config.layer_norm_eps

    def cna(prefix, norm=True):
        p = {"conv": bag.conv(f"{prefix}.conv")}
        if norm:
            p["norm"] = bag.batchnorm(f"{prefix}.norm", eps=eps)
        return p

    def fused_mbconv(prefix):
        return {"spatial_conv": cna(f"{prefix}.spatial_conv"), "point_conv": cna(f"{prefix}.point_conv")}

    def mbconv(prefix):
        return {
            "inverted_conv": cna(f"{prefix}.inverted_conv", norm=False),
            "depth_conv": cna(f"{prefix}.depth_conv", norm=False),
            "point_conv": cna(f"{prefix}.point_conv"),
        }

    def lite_mla(prefix):
        return {
            "qkv": cna(f"{prefix}.qkv", norm=False),
            "aggreg_dw": bag.conv(f"{prefix}.aggreg.0.0"),
            "aggreg_pw": bag.conv(f"{prefix}.aggreg.0.1"),
            "proj": cna(f"{prefix}.proj"),
        }

    stem = {"in_conv": cna("vit.stem.in_conv")}
    for d in range(config.depths[0]):
        pfx = f"vit.stem.res{d}.main"
        stem[f"res{d}"] = {"conv1": cna(f"{pfx}.conv1"), "conv2": cna(f"{pfx}.conv2")}

    stages = []
    for i, depth in enumerate(config.depths[1:]):
        vit_stage = i >= 3
        fewer_norm = i >= 2
        blocks = []
        down_pfx = f"vit.stages.{i}.blocks.0.main"
        blocks.append({"down": mbconv(down_pfx) if fewer_norm else fused_mbconv(down_pfx)})
        for b in range(1, depth + 1):
            pfx = f"vit.stages.{i}.blocks.{b}"
            if vit_stage:
                blocks.append({"vit": {
                    "attn": lite_mla(f"{pfx}.context_module.main"),
                    "mlp": mbconv(f"{pfx}.local_module.main"),
                }})
            elif fewer_norm:
                blocks.append({"mb": mbconv(f"{pfx}.main")})
            else:
                blocks.append({"fused": fused_mbconv(f"{pfx}.main")})
        stages.append({"blocks": blocks})

    head = {
        "linear_c": [bag.linear(f"decode_head.linear_c.{k}.proj") for k in range(4)],
        "linear_fuse": bag.conv("decode_head.linear_fuse", bias=False),
        "batch_norm": bag.batchnorm("decode_head.batch_norm", eps=1e-5),
        "classifier": bag.conv("decode_head.classifier"),
    }
    bag.warn_unused("detection")
    return {"stem": stem, "stages": stages, "head": head}


def install_blob_detector(det) -> None:
    """Replace a DetectionPredictor's heatmap tail with a line detector
    driven by input darkness, on top of a bias-blanked classifier, keeping
    the full forward's cost (surya_tpu efficientvit.install_blob_detector):
    random weights give no coherent maps. The darkness (1 - the channel
    minimum) is max-pooled 4x4 to head resolution, then over 3 rows x 9
    columns (stride 1, -inf padding, as JAX's "SAME" window), and added x14
    to logit channel 0."""
    with torch.no_grad():
        for model in det.models():
            model.head.classifier.bias.fill_(-6.0)

    def apply_heat(model, x):
        logits = model.forward_logits(x).float()
        dark = 1.0 - x.float().amin(dim=1, keepdim=True)
        blob = F.max_pool2d(F.max_pool2d(dark, 4, 4), (3, 9), stride=1, padding=(1, 4))
        return torch.sigmoid(torch.cat([logits[:, :1] + 14.0 * blob, logits[:, 1:]], dim=1))

    det._apply_heat = apply_heat
