"""Layers shared by the port's models (counterpart of surya_tpu/nn).

Linear layers are ``torch.nn.Linear`` and convolutions ``torch.nn.Conv2d``
on NCHW tensors. The port's modules carry the names of the JAX package's
parameter pytrees, so ``load_jax_params`` carries JAX weights over by path
(JAX linear kernels are [in, out] and are transposed; JAX conv kernels are
HWIO and become OIHW). RMSNorm keeps the fp32 island of the JAX version;
inference batch-norm is folded into a per-channel scale and bias, as there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


class GemmaRMSNorm(nn.Module):
    """The ADETR decoder's RMSNorm (surya_tpu nn.gemma_rmsnorm): the variance
    clamped below at eps, scaled by (1 + weight) with the weight stored as
    zeros, the result clamped to the input dtype's range and NaNs zeroed."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(torch.clamp(xf.square().mean(-1, keepdim=True), min=self.eps))
        y = y * (1.0 + self.weight.float())
        info = torch.finfo(x.dtype)
        return torch.clamp(y, info.min, info.max).nan_to_num(nan=0.0).to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis in fp32, the result in the input dtype
    (surya_tpu nn.layernorm; its leaves scale/bias are weight/bias here)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(), self.bias.float(), self.eps)
        return y.to(x.dtype)


class FoldedBatchNorm(nn.Module):
    """Inference batch-norm folded to a per-channel scale (``weight``) and
    bias, over the channels of an NCHW tensor (surya_tpu nn.bn_fold)."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        return x * self.weight.to(x.dtype)[:, None, None] + self.bias.to(x.dtype)[:, None, None]


class QuantLinear(nn.Module):
    """Weight-only int8 linear (surya_tpu nn.linear on a ``kernel_q`` leaf):
    an int8 weight [out, in] and one float32 scale an output channel, both
    buffers, and the bias where the linear has one. The forward rounds as the
    JAX package does: the product with the weight converted to the input's
    dtype, then times the scale rounded to that dtype, then the bias. Module
    casts (``model.to(dtype=...)``) leave the int8 weight and the float32
    scale as they are."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight_q", torch.zeros((out_features, in_features), dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def _apply(self, fn, recurse=True):
        scale = self.scale
        super()._apply(fn, recurse)
        if self.scale.dtype != torch.float32:  # a dtype cast: keep the unrounded scale
            self.scale = scale.to(device=self.scale.device)
        return self

    def forward(self, x):
        y = F.linear(x, self.weight_q.to(x.dtype)) * self.scale.to(x.dtype)
        return y if self.bias is None else y + self.bias


def quantize_linear(linear: nn.Linear) -> QuantLinear:
    """Symmetric per-output-channel int8 of a linear's weight, as surya_tpu's
    nn.quantize_linear computes it: in float32 from the weight as it is (so
    after any cast to the model dtype), the scale the channel's max |w| over
    127, the values w / max(scale, 1e-8) rounded half to even, no clip; the
    raw scale is stored."""
    w = linear.weight.detach().float()
    scale = w.abs().amax(dim=1) / 127.0
    with torch.device(w.device):
        q = QuantLinear(linear.in_features, linear.out_features, bias=linear.bias is not None)
    with torch.no_grad():
        q.weight_q.copy_(torch.round(w / torch.clamp(scale, min=1e-8)[:, None]).to(torch.int8))
        q.scale.copy_(scale)
        if linear.bias is not None:
            q.bias = nn.Parameter(linear.bias.detach().clone(), requires_grad=linear.bias.requires_grad)
    return q


def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def torch_conv_padding(kernel_size: int, stride: int = 1, dilation: int = 1) -> int:
    """The symmetric padding of torch Conv2d(padding=((s-1)+d*(k-1))//2),
    which surya_tpu's nn.torch_conv_padding spells out for JAX."""
    return ((stride - 1) + dilation * (kernel_size - 1)) // 2


def bilinear_resize(x, out_hw: Tuple[int, int]):
    """NCHW bilinear resize with align_corners=False. surya_tpu's
    bilinear_resize is jax.image.resize(..., "bilinear"); the detection head
    only ever upsamples with it, and there it equals F.interpolate without
    antialiasing (half-pixel centres; at the border jax renormalises the
    weights over the in-range pixels, which is torch's clamp to the edge)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False, antialias=False)


def init_normal_(module: nn.Module, generator: torch.Generator, std: float = 0.02) -> None:
    """Random init mirroring the JAX package's initializers: every Linear and
    Conv2d weight and Embedding table ~ N(0, std^2), biases 0, norm scales 1
    (a Gemma RMSNorm's stored weight 0, since it scales by 1 + weight)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)
            elif isinstance(m, GemmaRMSNorm):
                m.weight.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, FoldedBatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


# JAX leaf name -> PyTorch parameter or buffer name
_JAX_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
_JAX_LEAF_QUANT = {"kernel_q": "weight_q", "scale": "scale", "bias": "bias"}  # in a QuantLinear


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*prefix, str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, (*prefix, str(i)))
    else:
        yield prefix, tree


def _submodule(module: nn.Module, path) -> Optional[nn.Module]:
    try:
        return module.get_submodule(".".join(path))
    except AttributeError:
        return None


def load_jax_params(module: nn.Module, tree) -> None:
    """Copy a JAX parameter pytree (numpy leaves) into `module`, whose
    submodules carry the pytree's names: ``blocks/0/attn/qkv/kernel`` goes
    to ``blocks.0.attn.qkv.weight``, transposed, since JAX linear kernels
    are [in, out]; a 4-D (HWIO) conv kernel becomes OIHW. In a QuantLinear,
    ``kernel_q`` goes to ``weight_q`` (transposed, int8) and ``scale`` to
    ``scale``. Floating leaves are taken in float32 and land in the
    tensor's dtype; integer leaves must have the tensor's dtype. Raises
    unless every leaf lands on a parameter or buffer of the same shape and
    every parameter and buffer receives a leaf."""
    tensors = {**dict(module.named_parameters()), **dict(module.named_buffers())}
    seen = set()
    for path, leaf in _leaves(tree):
        *mods, leaf_name = path
        table = _JAX_LEAF_QUANT if isinstance(_submodule(module, mods), QuantLinear) else _JAX_LEAF
        key = ".".join([*mods, table.get(leaf_name, leaf_name)])
        if key not in tensors:
            raise KeyError(f"JAX leaf {'/'.join(path)} has no parameter {key} in the port's model")
        target = tensors[key]
        value = np.asarray(leaf)
        if target.is_floating_point():
            value = value.astype(np.float32)
        elif value.dtype != torch.empty(0, dtype=target.dtype).numpy().dtype:
            raise TypeError(f"{key}: {target.dtype} tensor vs JAX leaf of {value.dtype}")
        if leaf_name in ("kernel", "kernel_q"):
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
        value = torch.from_numpy(np.array(value))  # a writable copy
        if tuple(target.shape) != tuple(value.shape):
            raise ValueError(f"{key}: parameter {tuple(target.shape)} vs JAX leaf {tuple(value.shape)}")
        with torch.no_grad():
            target.copy_(value)
        seen.add(key)
    missing = sorted(set(tensors) - seen)
    if missing:
        raise KeyError(f"no JAX leaf for parameters or buffers {missing}")
