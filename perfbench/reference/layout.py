"""Plain PyTorch reference of Surya's layout model (surya v0.14.6's layout
checkpoint): a DonutSwin encoder and the ADETR box decoder. It imports
nothing of the program under test.

Each tile is run alone, in float32: the encoder as the Swin papers define
it (windowed attention with relative position bias, every second block on
windows shifted by half a window, patch merging between stages), the
decoder as one causal pass over the box tokens served for the tile, fed back
as the decoder feeds them, with the cross-attention over the encoder's
tokens. Its tensors are named as the program's checkpoint names them
(``param_shapes``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import cv2
import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from perfbench.reference.precision import matmul

BOX_FIELDS = ("cx", "cy", "w", "h", "xskew", "yskew")
CORNER_FIELDS = ("x1", "y1", "x2", "y2", "x3", "y3", "x4", "y4")


def stage_dims(e: dict) -> List[int]:
    return [e["embed_dim"] * 2**i for i in range(len(e["depths"]))]


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    e, d = cfg["encoder"], cfg["decoder"]
    dims = stage_dims(e)
    win = e["window_size"]
    shapes = {
        "encoder.position_embeddings": (e["encoder_length"], dims[-1]),
        "encoder.patch_embed.weight": (e["embed_dim"], 3, e["patch_size"], e["patch_size"]),
        "encoder.patch_embed.bias": (e["embed_dim"],),
        "encoder.embed_norm.weight": (e["embed_dim"],), "encoder.embed_norm.bias": (e["embed_dim"],),
    }
    for s, (depth, dim) in enumerate(zip(e["depths"], dims)):
        heads, kvh = e["num_heads"][s], e["num_kv_heads"][s]
        for i in range(depth):
            b = f"encoder.stages.{s}.blocks.{i}."
            shapes.update({
                b + "norm1.weight": (dim,), b + "norm1.bias": (dim,), b + "norm2.weight": (dim,), b + "norm2.bias": (dim,),
                b + "attn.rel_bias": ((2 * win - 1) ** 2, heads),
                b + "attn.query.weight": (dim, dim), b + "attn.query.bias": (dim,),
                b + "attn.key.weight": (dim * kvh // heads, dim), b + "attn.key.bias": (dim * kvh // heads,),
                b + "attn.value.weight": (dim * kvh // heads, dim), b + "attn.value.bias": (dim * kvh // heads,),
                b + "attn.proj.weight": (dim, dim), b + "attn.proj.bias": (dim,),
                b + "mlp.fc1.weight": (4 * dim, dim), b + "mlp.fc1.bias": (4 * dim,),
                b + "mlp.fc2.weight": (dim, 4 * dim), b + "mlp.fc2.bias": (dim,),
            })
        if s < len(dims) - 1:
            b = f"encoder.stages.{s}.downsample."
            shapes.update({b + "norm.weight": (4 * dim,), b + "norm.bias": (4 * dim,),
                           b + "reduction.weight": (2 * dim, 4 * dim)})
    h, inter = d["hidden_size"], d["intermediate_size"]
    hd = h // d["num_attention_heads"]
    kv = d["num_key_value_heads"] * hd
    for li in range(d["num_hidden_layers"]):
        b = f"decoder.layers.{li}."
        for n in ("cross_pre_norm", "temporal_pre_norm", "channel_pre_norm"):
            shapes[b + n + ".weight"] = (h,)
        shapes.update({b + "mlp_block.gate_proj.weight": (inter, h), b + "mlp_block.up_proj.weight": (inter, h),
                       b + "mlp_block.down_proj.weight": (h, inter)})
        for blk, kv_in in (("cross_attn_block", d["encoder_hidden_size"]), ("temporal_block", h)):
            shapes.update({f"{b}{blk}.q_proj.weight": (h, h), f"{b}{blk}.k_proj.weight": (kv, kv_in),
                           f"{b}{blk}.v_proj.weight": (kv, kv_in), f"{b}{blk}.o_proj.weight": (h, h),
                           f"{b}{blk}.o_proj.bias": (h,)})
    shapes["decoder.final_norm.weight"] = (h,)
    for f in BOX_FIELDS + CORNER_FIELDS:
        shapes[f"embedder.{f}_embed.weight"] = (cfg["vocab_size"], h)
    shapes.update({
        "embedder.label_embed.weight": (cfg["label_count"], h),
        "pre_output_norm.weight": (h,), "pre_output_norm.bias": (h,),
        "lm_head.weight": (cfg["label_count"], h), "bbox_head.weight": (6, h), "bbox_head.bias": (6,),
    })
    return shapes


# -- inputs ----------------------------------------------------------------------

def tiles(page: Image.Image, cfg: dict) -> List[np.ndarray]:
    """A page cut along its long axis into tiles when it exceeds the slicing
    minimum, each squeezed to the encoder's size (LANCZOS4): uint8 [H, W, 3]."""
    s = cfg["slicing"]
    w, h = page.size
    if w > s["min_width"] or h > s["min_height"]:
        if w > h:
            step = max(s["width"], w // s["max_slices"] + 1)
            boxes = [(x, 0, min(x + step, w), h) for x in range(0, w, step)]
        else:
            step = max(s["height"], h // s["max_slices"] + 1)
            boxes = [(0, y, w, min(y + step, h)) for y in range(0, h, step)]
    else:
        boxes = [(0, 0, w, h)]
    size = cfg["encoder"]["image_size"]
    return [cv2.resize(np.asarray(page.crop(b).convert("RGB"), dtype=np.uint8), (size[1], size[0]),
                       interpolation=cv2.INTER_LANCZOS4) for b in boxes]


# -- the encoder ----------------------------------------------------------------

def layer_norm(x, W, name, eps):
    return F.layer_norm(x, x.shape[-1:], W[name + ".weight"], W[name + ".bias"], eps)


def linear(W, name, x, bias=True):
    out = matmul(W, x, name + ".weight")
    return out + W[name + ".bias"] if bias else out


def sincos_2d(h: int, w: int, dim: int) -> torch.Tensor:
    """The stage's 2-D sincos position table, width-major, as the
    checkpoint's model adds it."""
    gw, gh = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32), indexing="ij")
    q = dim // 4
    omega = 1.0 / 10000.0 ** (np.arange(q, dtype=np.float32) / q)
    ow, oh = gw.flatten()[:, None] * omega, gh.flatten()[:, None] * omega
    return torch.from_numpy(np.concatenate([np.sin(ow), np.cos(ow), np.sin(oh), np.cos(oh)], 1))


def window_attention(W, b, x, heads, kvh, win, shift):
    """x [h, w, C]: attention within win x win windows (after a roll by
    -shift), the relative position bias, and -100 between tokens that came
    from different regions of the unrolled map."""
    h, w, C = x.shape
    if shift:
        x = torch.roll(x, (-shift, -shift), (0, 1))
    xw = x.reshape(h // win, win, w // win, win, C).permute(0, 2, 1, 3, 4).reshape(-1, win * win, C)
    D = C // heads
    q = linear(W, b + "attn.query", xw).view(-1, win * win, heads, D).transpose(1, 2)
    k = linear(W, b + "attn.key", xw).view(-1, win * win, kvh, D).transpose(1, 2).repeat(1, heads // kvh, 1, 1)
    v = linear(W, b + "attn.value", xw).view(-1, win * win, kvh, D).transpose(1, 2).repeat(1, heads // kvh, 1, 1)
    yy, xx = np.meshgrid(np.arange(win), np.arange(win), indexing="ij")
    flat = np.stack([yy.ravel(), xx.ravel()])
    rel = flat[:, :, None] - flat[:, None, :] + win - 1
    idx = torch.from_numpy(rel[0] * (2 * win - 1) + rel[1]).to(x.device)
    bias = W[b + "attn.rel_bias"][idx].permute(2, 0, 1)[None]  # [1, heads, L, L]
    if shift:
        region = torch.zeros(h, w)
        cuts = (slice(0, -win), slice(-win, -shift), slice(-shift, None))
        for n, (hs, ws) in enumerate((hs, ws) for hs in cuts for ws in cuts):
            region[hs, ws] = n
        region = region.reshape(h // win, win, w // win, win).permute(0, 2, 1, 3).reshape(-1, win * win)
        bias = bias + torch.where(region[:, None, :] != region[:, :, None], -100.0, 0.0)[:, None].to(x.device)
    att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(D) + bias, -1) @ v
    out = att.transpose(1, 2).reshape(h // win, w // win, win, win, C).permute(0, 2, 1, 3, 4).reshape(h, w, C)
    out = linear(W, b + "attn.proj", out)
    return torch.roll(out, (shift, shift), (0, 1)) if shift else out


def encode(W, cfg: dict, tile: np.ndarray, device) -> torch.Tensor:
    """One uint8 tile [H, W, 3] -> the encoder's tokens [L, hidden]."""
    e = cfg["encoder"]
    eps, win, p = cfg["layer_norm_eps"], e["window_size"], e["patch_size"]
    x = (torch.from_numpy(tile).to(device).float() / 255.0 - 0.5) / 0.5
    x = F.conv2d(x.permute(2, 0, 1)[None], W["encoder.patch_embed.weight"], W["encoder.patch_embed.bias"], stride=p)
    h, w = x.shape[2:]
    x = layer_norm(x[0].flatten(1).T, W, "encoder.embed_norm", eps)
    for s, dim in enumerate(stage_dims(e)):
        x = x + sincos_2d(h, w, dim).to(device)
        for i in range(e["depths"][s]):
            b = f"encoder.stages.{s}.blocks.{i}."
            y = layer_norm(x, W, b + "norm1", eps).reshape(h, w, dim)
            shift = win // 2 if i % 2 else 0
            x = x + window_attention(W, b, y, e["num_heads"][s], e["num_kv_heads"][s], win, shift).reshape(h * w, dim)
            x = x + linear(W, b + "mlp.fc2", F.gelu(linear(W, b + "mlp.fc1", layer_norm(x, W, b + "norm2", eps))))
        if s < len(e["depths"]) - 1:
            xs = x.reshape(h, w, dim)
            x = torch.cat([xs[0::2, 0::2], xs[1::2, 0::2], xs[0::2, 1::2], xs[1::2, 1::2]], -1)
            h, w = h // 2, w // 2
            x = linear(W, f"encoder.stages.{s}.downsample.reduction",
                       layer_norm(x.reshape(h * w, 4 * dim), W, f"encoder.stages.{s}.downsample.norm", eps), False)
    return x + W["encoder.position_embeddings"][: x.shape[0]]


# -- the decoder ----------------------------------------------------------------

def gemma_rms_norm(x, w, eps):
    y = x * torch.rsqrt(torch.clamp(x.square().mean(-1, keepdim=True), min=eps)) * (1.0 + w)
    return y.nan_to_num(nan=0.0)


def embed_boxes(W, cfg: dict, boxes: torch.Tensor) -> torch.Tensor:
    """Box tokens [S, 7] (integers: 6 box values in 0..bbox_size and a class)
    -> the sum of their 7 fields' and their 8 corners' embeddings."""
    size = cfg["bbox_size"]
    cx, cy, w, h, xskew, yskew, label = boxes.long().unbind(-1)
    xs = torch.trunc((xskew - size // 2) / 2).long()
    ys = torch.trunc((yskew - size // 2) / 2).long()
    corners = (cx - w // 2 - xs, cy - h // 2 - ys, cx + w // 2 - xs, cy + h // 2 + ys,
               cx + w // 2 + xs, cy + h // 2 + ys, cx - w // 2 + xs, cy - h // 2 - ys)
    out = W["embedder.label_embed.weight"][label]
    for f, v in zip(BOX_FIELDS, (cx, cy, w, h, xskew, yskew)):
        out = out + W[f"embedder.{f}_embed.weight"][v]
    for f, v in zip(CORNER_FIELDS, corners):
        out = out + W[f"embedder.{f}_embed.weight"][v.clamp(0, size)]
    return out


def decode(W, cfg: dict, enc: torch.Tensor, feeds: torch.Tensor):
    """One causal pass over the box tokens fed at each step [S, 7] (the
    first all BOS) with the tile's encoder tokens enc [L, hidden]. Returns
    (class logits [S, label_count], boxes [S, 6] in 0..bbox_size)."""
    d = cfg["decoder"]
    H, KVH, hs = d["num_attention_heads"], d["num_key_value_heads"], d["hidden_size"]
    D, eps, S = hs // H, d["rms_norm_eps"], feeds.shape[0]
    x = embed_boxes(W, cfg, feeds)
    inv = 1.0 / d["rope_theta"] ** (torch.arange(0, D, 2).float() / D)
    ang = torch.arange(S).float()[:, None] * inv
    ang = torch.cat([ang, ang], -1).to(x.device)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    every = torch.ones(S, enc.shape[0], dtype=torch.bool, device=x.device)

    def rot(t):
        half = t.shape[-1] // 2
        return t * ang.cos() + torch.cat([-t[..., half:], t[..., :half]], -1) * ang.sin()

    def attend(b, q_in, kv_in, mask, rotary):
        q = matmul(W, q_in, b + "q_proj.weight").view(-1, H, D).transpose(0, 1)
        k = matmul(W, kv_in, b + "k_proj.weight").view(-1, KVH, D).transpose(0, 1)
        v = matmul(W, kv_in, b + "v_proj.weight").view(-1, KVH, D).transpose(0, 1)
        if rotary:
            q, k = rot(q), rot(k)
        # query head h reads kv head h // (H / KVH)
        k, v = k.repeat_interleave(H // KVH, 0), v.repeat_interleave(H // KVH, 0)
        logits = (q @ k.transpose(1, 2) / math.sqrt(D)).masked_fill(~mask, float("-inf"))
        out = (torch.softmax(logits, -1) @ v).transpose(0, 1).reshape(-1, hs)
        return linear(W, b + "o_proj", out)

    for li in range(d["num_hidden_layers"]):
        b = f"decoder.layers.{li}."
        raw = x
        cross = attend(b + "cross_attn_block.", gemma_rms_norm(x, W[b + "cross_pre_norm.weight"], eps), enc, every,
                       False) + raw
        t = gemma_rms_norm(cross, W[b + "temporal_pre_norm.weight"], eps)
        res = attend(b + "temporal_block.", t, t, causal, True) + raw
        y = gemma_rms_norm(res, W[b + "channel_pre_norm.weight"], eps)
        x = matmul(W, F.gelu(matmul(W, y, b + "mlp_block.gate_proj.weight"), approximate="tanh")
                   * matmul(W, y, b + "mlp_block.up_proj.weight"), b + "mlp_block.down_proj.weight") + res
    x = layer_norm(gemma_rms_norm(x, W["decoder.final_norm.weight"], eps), W, "pre_output_norm", cfg["layer_norm_eps"])
    return matmul(W, x, "lm_head.weight"), torch.sigmoid(linear(W, "bbox_head", x)) * cfg["bbox_size"]


def header_footer_rule(cfg: dict, box: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """Where a PageHeader or PageFooter box lies outside the page's margins
    (not inside the outer fifth on any side), the model's class is replaced
    by its next best."""
    size, skew = cfg["bbox_size"], cfg["skew_scaler"]
    cx, cy, w, h, xskew, yskew = box.unbind(-1)
    sx = torch.floor((xskew - skew) / 2)
    sy = torch.floor((yskew - skew) / 2)
    sx = torch.where(sx.abs() < 0.001, 0.0, sx)
    sy = torch.where(sy.abs() < 0.001, 0.0, sy)
    x0, y0, x2, y2 = cx - w / 2 - sx, cy - h / 2 - sy, cx + w / 2 + sx, cy + h / 2 + sy
    hf = (cls == cfg["page_footer_class"]) | (cls == cfg["page_header_class"])
    return hf & (y0 < 0.8 * size) & (y2 > 0.2 * size) & (x0 < 0.8 * size) & (x2 > 0.2 * size)
