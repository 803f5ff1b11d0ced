"""DonutSwin encoder (the layout and table-rec vision backbone), in PyTorch.

Counterpart of surya_tpu/models/donut_swin.py, with the same numbers: window
attention with relative-position bias tables and kv heads widened by tiling
(not interleaving), shifted windows as a roll by (-s, -s) before the window
partition and (+s, +s) after it with the -100 shift bias, the per-stage 2-D
sincos position table with its w-major ordering, the patch merge's
concatenation order, the exact GELU, and the learned position embeddings
added at the end, sliced to the token count. Submodules carry the names of
the JAX parameter pytree, so ``nn.load_jax_params`` carries its weights over.

The window attention runs through ``ops.attention.sdpa`` with an additive
fp32 bias: the JAX package computes it with plain ``jnp`` products, so there
is no TPU kernel on this path.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from surya_tpu_torch import nn as pnn
from surya_tpu_torch.ops import attention as att


@dataclass(frozen=True)
class DonutSwinConfig:
    image_size: Tuple[int, int] = (768, 768)
    patch_size: int = 4
    num_channels: int = 3
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 16, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    num_kv_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    layer_norm_eps: float = 1e-5
    encoder_length: int = 768
    use_positional_embeddings: bool = True

    @property
    def hidden_size(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.image_size[0] // self.patch_size, self.image_size[1] // self.patch_size)

    @property
    def tokens(self) -> int:
        """The encoder's output tokens: the patch grid halved at each merge."""
        n = len(self.depths) - 1
        return (self.grid[0] >> n) * (self.grid[1] >> n)


# the layout and table rec predictors' uint8 pixels -> [-1, 1] (surya_tpu
# layout's jitted generate and table_rec's encode)
IMAGE_MEAN = 0.5
IMAGE_STD = 0.5


def normalize_u8(pixels, dtype):
    """uint8 pages [B, H, W, 1 or 3] -> the encoder's input [B, H, W, 3] in
    dtype: a gray channel broadcast, scaled to [0, 1] and normalised."""
    x = pixels.expand(*pixels.shape[:-1], 3).to(dtype) / 255.0
    return (x - IMAGE_MEAN) / IMAGE_STD


# -- static tables (numpy, as the JAX package builds them) --------------------

def _relative_position_index(window: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)  # [win*win, win*win]


def _shift_mask(height: int, width: int, window: int, shift: int) -> np.ndarray:
    """Additive bias of shifted-window attention: -100 between tokens of
    different pre-shift regions. [nW, win*win, win*win] float32."""
    img = np.zeros((height, width))
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    count = 0
    for hs in slices:
        for ws in slices:
            img[hs, ws] = count
            count += 1
    win = img.reshape(height // window, window, width // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def _sincos_2d(height: int, width: int, dim: int) -> np.ndarray:
    """The 2-D sincos position table, w-major (meshgrid "ij" over (width,
    height)): a transposition quirk of the reference kept for its weights."""
    grid_w, grid_h = np.meshgrid(np.arange(width, dtype=np.float32), np.arange(height, dtype=np.float32), indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / (10000.0 ** (np.arange(pos_dim, dtype=np.float32) / pos_dim))
    out_w = grid_w.flatten()[:, None] * omega[None]
    out_h = grid_h.flatten()[:, None] * omega[None]
    return np.concatenate([np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], axis=1)


_TABLES = {"rel_idx": _relative_position_index, "shift": _shift_mask, "sincos": _sincos_2d}


@functools.lru_cache(maxsize=None)
def _table(device: torch.device, kind: str, *args) -> torch.Tensor:
    """A static table on the device, uploaded once per process (the one
    host sync of a first call)."""
    return torch.from_numpy(np.ascontiguousarray(_TABLES[kind](*args))).to(device)


# -- modules -----------------------------------------------------------------

def _window_partition(x, window: int):
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, C)


def _window_reverse(x, window: int, H: int, W: int, B: int):
    x = x.reshape(B, H // window, W // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


class _SwinAttention(nn.Module):
    def __init__(self, dim: int, n_heads: int, n_kv_heads: int, window: int, bias: bool):
        super().__init__()
        self.n_heads, self.n_kv_heads = n_heads, n_kv_heads
        self.query = nn.Linear(dim, dim, bias=bias)
        self.key = nn.Linear(dim, dim * n_kv_heads // n_heads, bias=bias)
        self.value = nn.Linear(dim, dim * n_kv_heads // n_heads, bias=bias)
        self.proj = nn.Linear(dim, dim)
        self.rel_bias = nn.Parameter(torch.zeros((2 * window - 1) ** 2, n_heads))

    def forward(self, x, bias):
        """x: [windows, win*win, C]; bias: fp32 [windows or 1, heads, win*win, win*win]."""
        NW, L, C = x.shape
        H, kvh = self.n_heads, self.n_kv_heads
        hd = C // H
        q = self.query(x).view(NW, L, H, hd)
        k = self.key(x).view(NW, L, kvh, hd)
        v = self.value(x).view(NW, L, kvh, hd)
        if kvh != H:
            # tiled, not interleaved: query head h reads kv head h % kvh
            k = k.repeat(1, 1, H // kvh, 1)
            v = v.repeat(1, 1, H // kvh, 1)
        return self.proj(att.sdpa(q, k, v, bias=bias).reshape(NW, L, C))


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class _Block(nn.Module):
    def __init__(self, config: DonutSwinConfig, dim: int, stage: int):
        super().__init__()
        eps = config.layer_norm_eps
        self.norm1 = pnn.LayerNorm(dim, eps)
        self.norm2 = pnn.LayerNorm(dim, eps)
        self.attn = _SwinAttention(dim, config.num_heads[stage], config.num_kv_heads[stage], config.window_size,
                                   config.qkv_bias)
        self.mlp = _MLP(dim, int(dim * config.mlp_ratio))

    def forward(self, x, B: int, h: int, w: int, win: int, shift: int, rel_idx, shift_bias):
        dim = x.shape[-1]
        hx = self.norm1(x).reshape(B, h, w, dim)
        if shift:
            hx = torch.roll(hx, (-shift, -shift), dims=(1, 2))
        w2 = win * win
        bias = self.attn.rel_bias[rel_idx].reshape(w2, w2, -1).permute(2, 0, 1).float()[None]
        if shift:
            # the shift bias of every window, tiled over the batch
            bias = bias + shift_bias.repeat(B, 1, 1)[:, None]
        out = _window_reverse(self.attn(_window_partition(hx, win), bias), win, h, w, B)
        if shift:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        x = x + out.reshape(B, h * w, dim)
        return x + self.mlp(self.norm2(x))


class _Downsample(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.norm = pnn.LayerNorm(4 * dim, eps)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, B: int, h: int, w: int):
        xs = x.reshape(B, h, w, -1)
        merged = torch.cat([xs[:, 0::2, 0::2], xs[:, 1::2, 0::2], xs[:, 0::2, 1::2], xs[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(merged.reshape(B, (h // 2) * (w // 2), -1)))


class _Stage(nn.Module):
    def __init__(self, config: DonutSwinConfig, stage: int):
        super().__init__()
        dim = int(config.embed_dim * 2**stage)
        self.blocks = nn.ModuleList(_Block(config, dim, stage) for _ in range(config.depths[stage]))
        last = stage == len(config.depths) - 1
        self.downsample = None if last else _Downsample(dim, config.layer_norm_eps)


class DonutSwin(nn.Module):
    """Submodule names follow surya_tpu donut_swin.init_params' pytree."""

    def __init__(self, config: DonutSwinConfig):
        super().__init__()
        self.config = config
        p = config.patch_size
        self.patch_embed = nn.Conv2d(config.num_channels, config.embed_dim, p, stride=p)
        self.embed_norm = pnn.LayerNorm(config.embed_dim, config.layer_norm_eps)
        self.stages = nn.ModuleList(_Stage(config, i) for i in range(len(config.depths)))
        self.position_embeddings = nn.Parameter(torch.zeros(config.encoder_length, config.hidden_size))

    def forward(self, pixel_values):
        """pixel_values: [B, H, W, 3] normalized. Returns [B, tokens, hidden]
        with the learned position embeddings added."""
        c = self.config
        win = c.window_size
        B = pixel_values.shape[0]
        dev = pixel_values.device
        x = self.patch_embed(pixel_values.permute(0, 3, 1, 2))
        x = self.embed_norm(x.flatten(2).transpose(1, 2))
        rel_idx = _table(dev, "rel_idx", win).reshape(-1)
        for i, stage in enumerate(self.stages):
            dim = int(c.embed_dim * 2**i)
            h, w = c.grid[0] // 2**i, c.grid[1] // 2**i
            if c.use_positional_embeddings:
                x = x + _table(dev, "sincos", h, w, dim).to(x.dtype)[None]
            shift_bias = _table(dev, "shift", h, w, win, win // 2) if len(stage.blocks) > 1 else None
            for bi, block in enumerate(stage.blocks):
                x = block(x, B, h, w, win, 0 if bi % 2 == 0 else win // 2, rel_idx, shift_bias)
            if stage.downsample is not None:
                x = stage.downsample(x, B, h, w)
        return x + self.position_embeddings[: x.shape[1]].to(x.dtype)[None]


def zero_tables_(model: DonutSwin) -> None:
    """Zero the relative-position bias tables and the position embeddings,
    as the JAX package initializes them (nn.init_normal_ leaves them)."""
    with torch.no_grad():
        model.position_embeddings.zero_()
        for stage in model.stages:
            for block in stage.blocks:
                block.attn.rel_bias.zero_()


# -- checkpoint conversion ----------------------------------------------------

def convert_torch(bag, config: DonutSwinConfig, prefix: str = "encoder") -> dict:
    """The upstream torch DonutSwin's tensors as surya_tpu donut_swin's pytree
    (numpy leaves, JAX layout; surya_tpu donut_swin.convert_torch). The
    position embeddings are stored [1, L, D]; the ``relative_position_index``
    buffers are marked used and recomputed (``_table``), not loaded."""
    pre = f"{prefix}." if prefix else ""
    params = {
        "patch_embed": bag.conv(f"{pre}embeddings.patch_embeddings.projection"),
        "embed_norm": bag.layernorm(f"{pre}embeddings.norm"),
        "position_embeddings": bag.raw(f"{pre}position_embeddings")[0],
        "stages": [],
    }
    for i, depth in enumerate(config.depths):
        blocks = []
        for b in range(depth):
            base = f"{pre}encoder.layers.{i}.blocks.{b}"
            blocks.append(
                {
                    "norm1": bag.layernorm(f"{base}.layernorm_before"),
                    "norm2": bag.layernorm(f"{base}.layernorm_after"),
                    "attn": {
                        "query": bag.linear(f"{base}.attention.self.query"),
                        "key": bag.linear(f"{base}.attention.self.key"),
                        "value": bag.linear(f"{base}.attention.self.value"),
                        "proj": bag.linear(f"{base}.attention.output.dense"),
                        "rel_bias": bag.raw(f"{base}.attention.self.relative_position_bias_table"),
                    },
                    "mlp": {
                        "fc1": bag.linear(f"{base}.intermediate.dense"),
                        "fc2": bag.linear(f"{base}.output.dense"),
                    },
                }
            )
        stage = {"blocks": blocks}
        if i < len(config.depths) - 1:
            stage["downsample"] = {
                "norm": bag.layernorm(f"{pre}encoder.layers.{i}.downsample.norm"),
                "reduction": bag.linear(f"{pre}encoder.layers.{i}.downsample.reduction", bias=False),
            }
        params["stages"].append(stage)
    for i, depth in enumerate(config.depths):
        for b in range(depth):
            bag.used.add(f"{pre}encoder.layers.{i}.blocks.{b}.attention.self.relative_position_index")
    return params
