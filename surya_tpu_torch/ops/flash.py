"""Encoder segmented attention (K1) and decoder causal prefill attention (K2).

Each public function runs the hand-written CUDA kernel in
``csrc/flash_attn.cu`` for tensors on a CUDA device, and its plain PyTorch
version (``*_reference``) for tensors on the CPU. There is no fallback: a CUDA
input the kernel does not take raises. ``<function>.launches`` counts the
kernel launches; ``segmented_block_attention.launches_by_range`` splits them
by KV window length (the encoder's full-attention and windowed blocks).

K1 replaces surya_tpu/ops/flash.py::segmented_block_attention, K2 replaces
surya_tpu/ops/flash.py::causal_flash_attention. Unlike the Pallas wrapper,
K1 reads q/k/v as [S, H, D] through their row strides (no transpose to
[H, S, D]), and walks for each 16 query rows only the span of keys their
groups can reach instead of the whole window; the kernel finds the spans
itself. That needs each group to be one contiguous run of slots, which
``qwen_encoder.plan_layout`` checks.
"""

from __future__ import annotations

import torch

from surya_tpu_torch.ops import _build
from surya_tpu_torch.ops.attention import NEG_INF, sdpa

PLAN_CHUNK = 128  # query rows per kv_starts entry (qwen_encoder.FULL_ATTN_Q_CHUNK)
SEGMENTED_HEAD_DIM = 80  # the head dims the kernels are built for: recognition encoder
CAUSAL_HEAD_DIM = 128  # and decoder


def _check_cuda(name: str, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices ({t.device} vs {dev})")
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")


def _check_bf16_rows(name: str, t: torch.Tensor) -> None:
    """[..., H, D] bf16 with unit dim stride, heads D apart, 16-byte aligned rows."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: kernel takes bfloat16, got {t.dtype}")
    D = t.shape[-1]
    if t.stride(-1) != 1 or t.stride(-2) != D:
        raise ValueError(f"{name}: need unit dim stride and heads {D} apart, got strides {t.stride()}")
    if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1]):
        raise ValueError(f"{name}: rows must be 16-byte aligned (strides {t.stride()})")


# -- K1: ranged segmented attention over the packed patch sequence -------------

def segmented_block_attention_reference(q, k, v, seg_id, kv_starts, kv_range: int):
    """Plain version of K1: each PLAN_CHUNK-row query chunk attends its
    contiguous KV window [kv_starts[c], + kv_range) (start clamped like a
    dynamic slice), masked by group-id equality; fp32 softmax. Mirrors the
    chunked path of surya_tpu qwen_encoder._ranged_attention."""
    S, H, D = q.shape
    kv_range = min(kv_range, S)
    n = S // PLAN_CHUNK
    starts = kv_starts.long().clamp(0, S - kv_range)
    idx = starts[:, None] + torch.arange(kv_range, device=q.device)  # [n, R]
    qc = q.float().reshape(n, PLAN_CHUNK, H, D)
    logits = torch.einsum("cqhd,ckhd->chqk", qc, k.float()[idx]) * D**-0.5
    mask = seg_id.reshape(n, PLAN_CHUNK)[:, :, None] == seg_id[idx][:, None, :]  # [n, q, R]
    logits = logits.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("chqk,ckhd->cqhd", probs, v.float()[idx])
    return out.reshape(S, H, D).to(q.dtype)


def _check_segmented(name, q, k, v, seg_id, kv_starts, kv_range: int) -> int:
    """Raise for what K1 does not take; returns kv_range clipped to S."""
    S, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if D != SEGMENTED_HEAD_DIM:
        raise ValueError(f"{name}: the kernel is built for head dim {SEGMENTED_HEAD_DIM}, got {D}")
    if S % PLAN_CHUNK:
        raise ValueError(f"{name}: S={S} must be a multiple of {PLAN_CHUNK}")
    kv_range = min(int(kv_range), S)
    if kv_range <= 0:
        raise ValueError(f"{name}: kv_range={kv_range} must be positive")
    for t in (q, k, v):
        _check_bf16_rows(name, t)
    if seg_id.dtype != torch.int32 or kv_starts.dtype != torch.int32:
        raise TypeError(f"{name}: seg_id and kv_starts must be int32")
    if seg_id.shape != (S,) or kv_starts.shape != (S // PLAN_CHUNK,):
        raise ValueError(f"{name}: seg_id {tuple(seg_id.shape)} / kv_starts {tuple(kv_starts.shape)} do not match S={S}")
    return kv_range


def segmented_block_attention(q, k, v, seg_id, kv_starts, kv_range: int):
    """q, k, v: [S, H, D] (post-RoPE; any row stride), seg_id: [S] int32 group
    id per row, each group one contiguous run of rows (padding rows: a unique
    id per 128-row chunk; plan_layout checks this, the kernel relies on it),
    kv_starts: [S / 128] int32 window start per query chunk, kv_range: window
    length. Returns [S, H, D]."""
    if q.device.type == "cpu":
        return segmented_block_attention_reference(q, k, v, seg_id, kv_starts, kv_range)
    name = "segmented_block_attention"
    _check_cuda(name, q, k, v, seg_id, kv_starts)
    kv_range = _check_segmented(name, q, k, v, seg_id, kv_starts, kv_range)
    S, H, D = q.shape
    seg_id, kv_starts = seg_id.contiguous(), kv_starts.contiguous()

    out = torch.empty((S, H, D), dtype=q.dtype, device=q.device)
    lib = _build.library().lib
    with torch.cuda.device(q.device):
        rc = lib.surya_segmented_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), k.stride(0), v.stride(0),
            seg_id.data_ptr(), kv_starts.data_ptr(), out.data_ptr(), S, H, D, kv_range,
            D**-0.5, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, name)
    segmented_block_attention.launches += 1
    by_range = segmented_block_attention.launches_by_range
    by_range[kv_range] = by_range.get(kv_range, 0) + 1
    return out


segmented_block_attention.launches = 0
segmented_block_attention.launches_by_range = {}


# -- K2: causal GQA prefill attention -----------------------------------------

def causal_flash_attention_reference(q, k, v):
    """Plain version of K2: dense causal GQA attention, fp32 softmax (the
    surya_tpu decoder's sdpa path with a tril mask)."""
    L = q.shape[1]
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    return sdpa(q, k, v, mask=causal)


def _check_causal(name, q, k, v) -> None:
    """Raise for what K2 does not take."""
    B, L, H, D = q.shape
    kvh = k.shape[2]
    if k.shape != (B, L, kvh, D) or v.shape != k.shape or H % kvh:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if D != CAUSAL_HEAD_DIM:
        raise ValueError(f"{name}: the kernel is built for head dim {CAUSAL_HEAD_DIM}, got {D}")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        _check_bf16_rows(name, t)


def causal_flash_attention(q, k, v):
    """q: [B, L, H, D], k/v: [B, L, kvh, D] (post-RoPE, right-padded rows).
    Query head h reads kv head h // (H / kvh). Padded query rows produce
    values the caller discards. Returns [B, L, H, D]."""
    if q.device.type == "cpu":
        return causal_flash_attention_reference(q, k, v)
    name = "causal_flash_attention"
    _check_cuda(name, q, k, v)
    _check_causal(name, q, k, v)
    B, L, H, D = q.shape
    out = torch.empty_like(q)
    lib = _build.library().lib
    with torch.cuda.device(q.device):
        rc = lib.surya_causal_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, H, k.shape[2], D,
            D**-0.5, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, name)
    causal_flash_attention.launches += 1
    return out


causal_flash_attention.launches = 0
