"""Qwen2.5-VL-style windowed vision encoder (recognition), in PyTorch.

Counterpart of surya_tpu/models/qwen_encoder.py. Every raggedness of a packed
batch of line crops is resolved on the host into static index arrays by
``plan_layout`` (numpy, the same arrays as the JAX package's), and the device
runs dense math: patch embed as one matmul, a gather into window order, 8
blocks whose attention is ranged segmented attention (windows for 6 blocks,
whole images for the full-attention blocks 3 and 7) through kernel K1, the
2x2 patch merger, and a gather back to the original token order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from surya_tpu_torch import nn as pnn
from surya_tpu_torch.ops import attention as att
from surya_tpu_torch.ops import flash


@dataclass(frozen=True)
class EncoderConfig:
    depth: int = 8
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 1
    window_size: int = 112
    out_hidden_size: int = 1280
    fullatt_block_indexes: Tuple[int, ...] = (3, 7)
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2

    @property
    def window_cells(self) -> int:
        # merged cells per window side (112 / 2 / 14 = 4)
        return self.window_size // self.spatial_merge_size // self.patch_size

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size**2


FULL_ATTN_Q_CHUNK = flash.PLAN_CHUNK  # rows per attention query chunk


@dataclass
class EncoderLayout:
    """Host-computed static-shape layout plan for one packed batch (numpy).
    Every slot below n_patches is a real patch; cap is the padded capacity."""

    cap: int
    n_patches: int
    n_llm_tokens: int
    patch_gather: np.ndarray  # [cap] raw-layout index per window-order slot
    pos_hw: np.ndarray  # [cap, 2] patch (h, w) within its image, window order
    seg_id: np.ndarray  # [cap] image id per slot (pads: a unique id per chunk)
    win_id: np.ndarray  # [cap] window id per slot (pads: a unique id per chunk)
    unscatter: np.ndarray  # [cap // merge_unit] window-order cell per original-order token
    llm_h_idx: np.ndarray  # [cap // merge_unit] row index into the 2-D learned embedding
    llm_w_idx: np.ndarray  # [cap // merge_unit] column index
    tokens_per_image: List[int]
    kv_starts: np.ndarray  # [cap // 128] full-attention KV window start per query chunk
    kv_range: int  # full-attention KV window length
    win_starts: np.ndarray  # [cap // 128] window-attention KV window start per query chunk
    win_range: int  # window-attention KV window length

    def __post_init__(self):
        # the K1 kernel walks, for each 16 query rows, only the keys from the
        # start of the first row's group run to the end of the last row's: a
        # group split over two runs of slots would lose the other run's keys
        for name in ("seg_id", "win_id"):
            ids = getattr(self, name)
            run_ids = ids[np.concatenate([[True], ids[1:] != ids[:-1]])]
            if np.unique(run_ids).size != run_ids.size:
                raise ValueError(f"{name}: a group id occurs in more than one run of slots")

    @property
    def device_args(self):
        """The arrays the encoder consumes, in VisionEncoder.forward's order."""
        return (
            self.patch_gather, self.pos_hw, self.seg_id, self.win_id,
            self.unscatter, self.kv_starts, self.win_starts,
        )


def _chunk_ranges(group_id: np.ndarray, cap: int, chunk: int, align: int):
    """For each `chunk`-slot query block, the contiguous KV window covering
    every group (image or window) it touches; starts align down to `align`."""
    change = np.flatnonzero(np.diff(group_id.astype(np.int64))) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [cap]])
    run_start = np.repeat(starts, ends - starts)
    run_end = np.repeat(ends, ends - starts)

    n_chunks = cap // chunk
    first = run_start[np.arange(n_chunks) * chunk]
    last = run_end[np.minimum(np.arange(n_chunks) * chunk + chunk, cap) - 1]
    kv_starts = (first // align) * align
    kv_range = max(chunk, int((last - kv_starts).max(initial=0)))
    kv_range = min(cap, -(-kv_range // align) * align)
    return np.minimum(kv_starts, cap - kv_range).astype(np.int32), int(kv_range)


def plan_layout(
    grids: List[Tuple[int, int]],
    config: EncoderConfig,
    cap: int,
    embed_encoding_multiplier: int = 256,
) -> EncoderLayout:
    """Packed window-order layout for per-image patch grids (h, w in patch
    units, multiples of spatial_merge_size). Cell order: window row-group,
    window col-group, row-in-group, col-in-group; edge windows keep their
    true size. Attention grouping is carried by win_id / seg_id."""
    if cap % FULL_ATTN_Q_CHUNK:
        raise ValueError(f"capacity {cap} must be a multiple of {FULL_ATTN_Q_CHUNK}")
    ms = config.spatial_merge_size
    wc = config.window_cells
    mu = config.merge_unit

    gathers, pos_hs, pos_ws, segs, wins, cell_srcs = [], [], [], [], [], []
    raw_base = llm_base = win_counter = 0
    for img_idx, (h, w) in enumerate(grids):
        llm_h, llm_w = h // ms, w // ms
        blocks = []
        for gr in range(-(-llm_h // wc)):
            rows = np.arange(gr * wc, min((gr + 1) * wc, llm_h))
            for gc in range(-(-llm_w // wc)):
                cols = np.arange(gc * wc, min((gc + 1) * wc, llm_w))
                blocks.append((rows[:, None] * llm_w + cols[None, :]).ravel())
        win_sizes = np.array([b.size for b in blocks])
        cell_idx = np.concatenate(blocks)  # original-order cell index, window order

        cell_srcs.append(llm_base + cell_idx)
        # each cell expands to its mu patches (raw order within a cell is (dr, dc))
        gathers.append((raw_base + cell_idx[:, None] * mu + np.arange(mu)[None, :]).ravel())
        r, c = cell_idx // llm_w, cell_idx % llm_w
        dr, dc = np.arange(mu) // ms, np.arange(mu) % ms
        pos_hs.append((r[:, None] * ms + dr[None, :]).ravel())
        pos_ws.append((c[:, None] * ms + dc[None, :]).ravel())
        segs.append(np.full(cell_idx.size * mu, img_idx))
        wins.append(np.repeat(win_counter + np.arange(len(blocks)), win_sizes * mu))
        win_counter += len(blocks)
        raw_base += h * w
        llm_base += llm_h * llm_w

    def cat(parts, pad_value):
        flat = np.concatenate(parts) if parts else np.zeros(0, np.int64)
        out = np.full(cap, pad_value, np.int32)
        out[: flat.size] = flat
        return out

    n_slots = int(sum(g.size for g in gathers))
    if n_slots > cap:
        raise ValueError(f"layout needs {n_slots} slots > capacity {cap}")

    patch_gather = cat(gathers, 0)
    pos_hw = np.stack([cat(pos_hs, 0), cat(pos_ws, 0)], axis=-1)
    # pad slots get a unique group id PER QUERY CHUNK so their attention
    # ranges stay one chunk wide
    pad_ids = -2 - (np.arange(cap) // FULL_ATTN_Q_CHUNK)
    seg_id = cat(segs, 0)
    seg_id[n_slots:] = pad_ids[n_slots:]
    win_id = cat(wins, 0)
    win_id[n_slots:] = pad_ids[n_slots:]

    llm_cap = cap // mu
    cell_src_arr = np.concatenate(cell_srcs) if cell_srcs else np.zeros(0, np.int64)
    unscatter = np.zeros(llm_cap, np.int32)
    unscatter[cell_src_arr] = np.arange(cell_src_arr.size, dtype=np.int32)

    # per-token 2-D learned-embedding indices, original order
    h_idx, w_idx, tokens_per_image = [], [], []
    for h, w in grids:
        llm_h, llm_w = h // ms, w // ms
        rows = np.arange(llm_h) / max(1, llm_h - 1) * embed_encoding_multiplier
        cols = np.arange(llm_w) / max(1, llm_w - 1) * embed_encoding_multiplier
        h_idx.append(np.repeat(rows.astype(np.int32), llm_w))
        w_idx.append(np.tile(cols.astype(np.int32), llm_h))
        tokens_per_image.append(llm_h * llm_w)
    n_llm = int(sum(tokens_per_image))
    llm_h_idx = np.zeros(llm_cap, np.int32)
    llm_w_idx = np.zeros(llm_cap, np.int32)
    if n_llm:
        llm_h_idx[:n_llm] = np.concatenate(h_idx)
        llm_w_idx[:n_llm] = np.concatenate(w_idx)

    kv_starts, kv_range = _chunk_ranges(seg_id, cap, FULL_ATTN_Q_CHUNK, align=512)
    win_starts, win_range = _chunk_ranges(win_id, cap, FULL_ATTN_Q_CHUNK, align=128)

    return EncoderLayout(
        cap=cap, n_patches=raw_base, n_llm_tokens=n_llm,
        patch_gather=patch_gather, pos_hw=pos_hw, seg_id=seg_id, win_id=win_id,
        unscatter=unscatter, llm_h_idx=llm_h_idx, llm_w_idx=llm_w_idx,
        tokens_per_image=tokens_per_image,
        kv_starts=kv_starts, kv_range=kv_range, win_starts=win_starts, win_range=win_range,
    )


# -- model ---------------------------------------------------------------------

class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, bias: bool):
        super().__init__()
        self.gate_proj = nn.Linear(dim, hidden, bias=bias)
        self.up_proj = nn.Linear(dim, hidden, bias=bias)
        self.down_proj = nn.Linear(hidden, dim, bias=bias)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class _Attention(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.qkv = nn.Linear(h, 3 * h)
        self.proj = nn.Linear(h, h)


class _Block(nn.Module):
    def __init__(self, config: EncoderConfig):
        super().__init__()
        h = config.hidden_size
        self.norm1 = pnn.RMSNorm(h)
        self.norm2 = pnn.RMSNorm(h)
        self.attn = _Attention(h)
        self.mlp = _MLP(h, config.intermediate_size, bias=True)


class _Merger(nn.Module):
    def __init__(self, config: EncoderConfig):
        super().__init__()
        merge_in = config.hidden_size * config.merge_unit
        self.ln_q = pnn.RMSNorm(config.hidden_size)
        self.mlp0 = nn.Linear(merge_in, merge_in)
        self.mlp2 = nn.Linear(merge_in, config.out_hidden_size)


class VisionEncoder(nn.Module):
    """Submodule names follow surya_tpu qwen_encoder.init_params' pytree."""

    def __init__(self, config: EncoderConfig):
        super().__init__()
        self.config = config
        self.patch_embed = nn.Linear(config.patch_dim, config.hidden_size, bias=False)
        self.blocks = nn.ModuleList(_Block(config) for _ in range(config.depth))
        self.merger = _Merger(config)

    def rope_tables(self, pos_hw):
        """2-D vision RoPE: angles [freqs(h), freqs(w)] duplicated to head_dim."""
        half = self.config.head_dim // 4  # freqs per axis
        inv_freq = 1.0 / (
            self.config.rope_theta
            ** (torch.arange(0, half * 2, 2, dtype=torch.float32, device=pos_hw.device) / (half * 2))
        )
        fh = pos_hw[:, 0].float()[:, None] * inv_freq
        fw = pos_hw[:, 1].float()[:, None] * inv_freq
        ang = torch.cat([fh, fw], dim=-1)
        ang = torch.cat([ang, ang], dim=-1)  # [cap, head_dim]
        return ang.cos(), ang.sin()

    def _attention(self, attn: _Attention, x, cos, sin, group_id, kv_starts, kv_range: int, use_kernels: bool):
        cfg = self.config
        cap = x.shape[0]
        qkv = attn.qkv(x).view(cap, 3, cfg.num_heads, cfg.head_dim)
        q, k = att.apply_rope(qkv[:, 0], qkv[:, 1], cos[:, None, :], sin[:, None, :])
        attend = flash.segmented_block_attention if use_kernels else flash.segmented_block_attention_reference
        out = attend(q, k, qkv[:, 2], group_id, kv_starts, kv_range)
        return attn.proj(out.reshape(cap, cfg.hidden_size))

    def forward(self, patches, patch_gather, pos_hw, seg_id, win_id, unscatter, kv_starts, win_starts,
                kv_range: int, win_range: int, use_kernels: bool = True):
        """patches: [cap, patch_dim] raw-order (normalized, zero-padded); the
        index arrays and the two range lengths come from plan_layout. Returns
        merged image tokens [cap // merge_unit, out_hidden] in ORIGINAL order;
        rows past n_llm_tokens are garbage the caller masks. use_kernels=False
        runs the plain attention on any device."""
        cfg = self.config
        x = self.patch_embed(patches)[patch_gather.long()]  # raw order -> window order
        cos, sin = self.rope_tables(pos_hw)
        for i, blk in enumerate(self.blocks):
            h = blk.norm1(x)
            if i in cfg.fullatt_block_indexes:
                x = x + self._attention(blk.attn, h, cos, sin, seg_id, kv_starts, kv_range, use_kernels)
            else:
                x = x + self._attention(blk.attn, h, cos, sin, win_id, win_starts, win_range, use_kernels)
            x = x + blk.mlp(blk.norm2(x))
        # 2x2 merge: the cells are contiguous in window order
        m = self.merger
        cells = m.ln_q(x).reshape(-1, cfg.merge_unit * cfg.hidden_size)
        merged = m.mlp2(F.gelu(m.mlp0(cells), approximate="none"))  # exact (erf) GELU
        return merged[unscatter.long()]  # window order -> original order
