"""Plain PyTorch reference of Surya's recognition model (the foundation
model of surya v0.14.6's text recognition checkpoint): a Qwen2.5-VL-style
vision encoder and a Qwen2-style decoder that reads the image tokens in its
prompt. It imports nothing of the program under test.

Each line crop is run alone, in float32, without a cache, kernel, window
packing or batching: the encoder attends within each 4x4-cell window (or the
whole image, at the full-attention blocks) directly, and the decoder runs
one causal pass over the prompt and the tokens served for it. Its tensors
are named as the program's checkpoint names them, so one state dict serves
both; ``param_shapes`` lists them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import cv2
import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.precision import matmul

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)
MIN_IMAGE_SIZE = 168


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every tensor of the model at the widths of `cfg` (a configuration
    file's "model" entry), by name."""
    e, d = cfg["encoder"], cfg["decoder"]
    h, eh, v = d["hidden_size"], e["hidden_size"], cfg["vocab_size"]
    pdim = 3 * e["patch_size"] ** 2
    merge_in = eh * e["spatial_merge_size"] ** 2
    kv = d["num_key_value_heads"] * (h // d["num_attention_heads"])
    shapes = {"lm_head_bias": (v,), "vision_encoder.patch_embed.weight": (eh, pdim)}
    for i in range(e["depth"]):
        b = f"vision_encoder.blocks.{i}."
        shapes.update({
            b + "norm1.weight": (eh,), b + "norm2.weight": (eh,),
            b + "attn.qkv.weight": (3 * eh, eh), b + "attn.qkv.bias": (3 * eh,),
            b + "attn.proj.weight": (eh, eh), b + "attn.proj.bias": (eh,),
            b + "mlp.gate_proj.weight": (e["intermediate_size"], eh), b + "mlp.gate_proj.bias": (e["intermediate_size"],),
            b + "mlp.up_proj.weight": (e["intermediate_size"], eh), b + "mlp.up_proj.bias": (e["intermediate_size"],),
            b + "mlp.down_proj.weight": (eh, e["intermediate_size"]), b + "mlp.down_proj.bias": (eh,),
        })
    shapes.update({
        "vision_encoder.merger.ln_q.weight": (eh,),
        "vision_encoder.merger.mlp0.weight": (merge_in, merge_in), "vision_encoder.merger.mlp0.bias": (merge_in,),
        "vision_encoder.merger.mlp2.weight": (e["out_hidden_size"], merge_in),
        "vision_encoder.merger.mlp2.bias": (e["out_hidden_size"],),
    })
    for i in range(d["num_hidden_layers"]):
        b = f"decoder.layers.{i}."
        shapes.update({
            b + "input_layernorm.weight": (h,), b + "post_attention_layernorm.weight": (h,),
            b + "self_attn.q_proj.weight": (h, h), b + "self_attn.q_proj.bias": (h,),
            b + "self_attn.k_proj.weight": (kv, h), b + "self_attn.k_proj.bias": (kv,),
            b + "self_attn.v_proj.weight": (kv, h), b + "self_attn.v_proj.bias": (kv,),
            b + "self_attn.o_proj.weight": (h, h),
            b + "mlp.gate_proj.weight": (d["intermediate_size"], h), b + "mlp.up_proj.weight": (d["intermediate_size"], h),
            b + "mlp.down_proj.weight": (h, d["intermediate_size"]),
        })
    n_embed = cfg["image_embed_encoding_size"]
    shapes.update({
        "decoder.norm.weight": (h,), "token_embed.weight": (v, h),
        "img_w_embed.weight": (n_embed, h), "img_h_embed.weight": (n_embed, h),
        "bbox_head.weight": (6, h), "bbox_head.bias": (6,),
    })
    return shapes


# -- inputs: the crop, its size budget, its patches, its prompt -----------------

def slice_polygon(page: np.ndarray, polygon) -> np.ndarray:
    """The crop of a line's polygon from the page: its bounding box, pixels
    outside a polygon that is not an axis-aligned rectangle whitened."""
    pts = np.asarray(polygon, np.int64)
    x0, y0 = pts.min(0)
    x1, y1 = pts.max(0)
    crop = page[y0:y1, x0:x1].copy()
    if crop.size == 0 or len(pts) < 3:
        return crop
    local = pts - [x0, y0]
    axis_aligned = len(local) == 4 and all(
        local[i][0] == local[(i + 1) % 4][0] or local[i][1] == local[(i + 1) % 4][1] for i in range(4))
    if axis_aligned and {tuple(p) for p in local} == {(0, 0), (x1 - x0, 0), (x1 - x0, y1 - y0), (0, y1 - y0)}:
        return crop
    mask = np.zeros(crop.shape[:2], np.uint8)
    cv2.fillPoly(mask, [local.astype(np.int32)], 1)
    crop[mask == 0] = 255
    return crop


def scale_to_fit(img: np.ndarray, max_size: Tuple[int, int]) -> np.ndarray:
    """Area-preserving rescale into [MIN_IMAGE_SIZE^2, max_size[0] * max_size[1]]
    pixels (LANCZOS4; floor when it shrinks, ceil when it grows)."""
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        return np.zeros((MIN_IMAGE_SIZE, MIN_IMAGE_SIZE, 3), np.uint8)
    area, hi, lo = w * h, max_size[0] * max_size[1], MIN_IMAGE_SIZE**2
    if area > hi:
        s = math.sqrt(hi / area)
        size = (math.floor(w * s), math.floor(h * s))
    elif area < lo:
        s = math.sqrt(lo / area)
        size = (math.ceil(w * s), math.ceil(h * s))
    else:
        return img
    return cv2.resize(img, size, interpolation=cv2.INTER_LANCZOS4)


def fitted_grid(shape, max_size: Tuple[int, int], patch: int, merge: int) -> Tuple[int, int]:
    """The patch grid of a crop of `shape` after scale_to_fit and ``patches``."""
    h, w = int(shape[0]), int(shape[1])
    if h == 0 or w == 0:
        h = w = MIN_IMAGE_SIZE
    area, hi, lo = w * h, max_size[0] * max_size[1], MIN_IMAGE_SIZE**2
    if area > hi:
        s = math.sqrt(hi / area)
        w, h = math.floor(w * s), math.floor(h * s)
    elif area < lo:
        s = math.sqrt(lo / area)
        w, h = math.ceil(w * s), math.ceil(h * s)
    f = patch * merge
    return max(f, math.ceil(h / f) * f) // patch, max(f, math.ceil(w / f) * f) // patch


def patches(img: np.ndarray, patch: int, merge: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """The image resized to whole merged cells (INTER_CUBIC) and cut into
    patches, cell by cell (row-major), each cell's merge x merge patches
    row-major, each patch channel-major, normalized: ([n, 3 p p] float32,
    (patch rows, patch columns))."""
    f = patch * merge
    h, w = img.shape[:2]
    hb, wb = max(f, math.ceil(h / f) * f), max(f, math.ceil(w / f) * f)
    if (hb, wb) != (h, w):
        img = cv2.resize(img, (wb, hb), interpolation=cv2.INTER_CUBIC)
    gh, gw = hb // patch, wb // patch
    x = torch.from_numpy(np.ascontiguousarray(img)).float() / 255.0
    x = (x - torch.tensor(IMAGE_MEAN)) / torch.tensor(IMAGE_STD)
    x = x.reshape(gh // merge, merge, patch, gw // merge, merge, patch, 3)
    x = x.permute(0, 3, 1, 4, 6, 2, 5)  # cell row, cell col, dr, dc, channel, y, x
    return x.reshape(gh * gw, 3 * patch * patch), (gh, gw)


def prompt_ids(cfg: dict, n_image_tokens: int) -> List[int]:
    """<IMAGE> x n, the registers, the OCR-with-boxes task token, <EOI>."""
    t = cfg["tokens"]
    return [t["image"]] * n_image_tokens + t["registers"] + [t["ocr_with_boxes"], t["eoi"]]


# -- the model -----------------------------------------------------------------

def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rope(x, ang):
    return x * ang.cos() + rotate_half(x) * ang.sin()


def linear(W, name, x, bias=True):
    out = matmul(W, x, name + ".weight")
    return out + W[name + ".bias"] if bias else out


def attention(q, k, v, mask):
    """q [H, S, D], k and v [KVH, T, D] (query head h reads kv head h // (H / KVH)),
    mask [S, T] of the keys each query sees."""
    rep = q.shape[0] // k.shape[0]
    k, v = k.repeat_interleave(rep, 0), v.repeat_interleave(rep, 0)
    logits = (q @ k.transpose(1, 2)) / math.sqrt(q.shape[-1])
    logits = logits.masked_fill(~mask, float("-inf"))
    return torch.softmax(logits, -1) @ v


def encode(W, cfg: dict, x: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
    """One image's patches (from ``patches``) -> its image tokens [n / merge^2, hidden]."""
    e = cfg["encoder"]
    m, H, eh = e["spatial_merge_size"], e["num_heads"], e["hidden_size"]
    D = eh // H
    gh, gw = grid
    n = gh * gw
    cell = torch.arange(n) // (m * m)
    cr, cc = cell // (gw // m), cell % (gw // m)
    dr, dc = (torch.arange(n) % (m * m)) // m, torch.arange(n) % m
    ph, pw = cr * m + dr, cc * m + dc
    quarter = D // 4
    inv = 1.0 / e["rope_theta"] ** (torch.arange(0, 2 * quarter, 2).float() / (2 * quarter))
    ang = torch.cat([ph[:, None] * inv, pw[:, None] * inv], -1)
    ang = torch.cat([ang, ang], -1).to(x.device)  # [n, D]
    wc = e["window_size"] // m // e["patch_size"]  # cells a window side
    window = ((cr // wc) * 100000 + cc // wc).to(x.device)
    in_window = window[:, None] == window[None, :]
    whole = torch.ones(n, n, dtype=torch.bool, device=x.device)
    h = matmul(W, x, "vision_encoder.patch_embed.weight")
    for i in range(e["depth"]):
        b = f"vision_encoder.blocks.{i}."
        qkv = linear(W, b + "attn.qkv", rms_norm(h, W[b + "norm1.weight"], 1e-6)).view(n, 3, H, D)
        q, k, v = (qkv[:, j].transpose(0, 1) for j in range(3))
        q, k = rope(q, ang), rope(k, ang)
        mask = whole if i in e["fullatt_block_indexes"] else in_window
        h = h + linear(W, b + "attn.proj", attention(q, k, v, mask).transpose(0, 1).reshape(n, eh))
        y = rms_norm(h, W[b + "norm2.weight"], 1e-6)
        h = h + linear(W, b + "mlp.down_proj", F.silu(linear(W, b + "mlp.gate_proj", y)) * linear(W, b + "mlp.up_proj", y))
    cells = rms_norm(h, W["vision_encoder.merger.ln_q.weight"], 1e-6).reshape(n // (m * m), m * m * eh)
    tokens = linear(W, "vision_encoder.merger.mlp2", F.gelu(linear(W, "vision_encoder.merger.mlp0", cells)))
    # the 2-D learned position of each token, its cell's row and column
    # spread over 0..multiplier
    lh, lw = gh // m, gw // m
    mult = cfg["image_embed_encoding_multiplier"]
    rows = (np.arange(lh) / max(1, lh - 1) * mult).astype(np.int64)
    cols = (np.arange(lw) / max(1, lw - 1) * mult).astype(np.int64)
    hi = torch.from_numpy(np.repeat(rows, lw)).to(x.device)
    wi = torch.from_numpy(np.tile(cols, lh)).to(x.device)
    return tokens + W["img_h_embed.weight"][hi] + W["img_w_embed.weight"][wi]


def logits(W, cfg: dict, image_tokens: torch.Tensor, prompt: List[int], served: List[int]) -> torch.Tensor:
    """One causal pass over the prompt (its <IMAGE> positions taking the
    image tokens in order) and the tokens fed back after each served token
    but the last; returns the logits [len(served), vocab] that chose each
    served token. A first token that is EOS or PAD is fed back as PAD, as
    the decoder's slot state does; later ones as they are (decode pinned)."""
    d, t = cfg["decoder"], cfg["tokens"]
    feeds = list(served[:-1])
    if feeds and feeds[0] in (t["eos"], t["pad"]):
        feeds[0] = t["pad"]
    ids = torch.tensor(prompt + feeds, device=image_tokens.device)
    x = W["token_embed.weight"][ids]
    # the prompt's <IMAGE> positions (a served token of that id is a token)
    img = (ids[: len(prompt)] == t["image"]).nonzero()[:, 0]
    x[img] = image_tokens[: img.numel()]
    S, hs, H, KVH = ids.numel(), d["hidden_size"], d["num_attention_heads"], d["num_key_value_heads"]
    D = hs // H
    inv = 1.0 / d["rope_theta"] ** (torch.arange(0, D, 2).float() / D)
    ang = torch.arange(S).float()[:, None] * inv
    ang = torch.cat([ang, ang], -1).to(x.device)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    eps = d["rms_norm_eps"]
    for i in range(d["num_hidden_layers"]):
        b = f"decoder.layers.{i}."
        y = rms_norm(x, W[b + "input_layernorm.weight"], eps)
        q = linear(W, b + "self_attn.q_proj", y).view(S, H, D).transpose(0, 1)
        k = linear(W, b + "self_attn.k_proj", y).view(S, KVH, D).transpose(0, 1)
        v = linear(W, b + "self_attn.v_proj", y).view(S, KVH, D).transpose(0, 1)
        out = attention(rope(q, ang), rope(k, ang), v, causal).transpose(0, 1).reshape(S, hs)
        x = x + linear(W, b + "self_attn.o_proj", out, bias=False)
        y = rms_norm(x, W[b + "post_attention_layernorm.weight"], eps)
        x = x + linear(W, b + "mlp.down_proj", F.silu(linear(W, b + "mlp.gate_proj", y, False))
                       * linear(W, b + "mlp.up_proj", y, False), False)
    x = rms_norm(x[len(prompt) - 1:], W["decoder.norm.weight"], eps)
    return matmul(W, x, "token_embed.weight") + W["lm_head_bias"]
