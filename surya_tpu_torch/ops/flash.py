"""Encoder segmented attention (K1) and decoder causal prefill attention (K2).

Each public function runs the hand-written CUDA kernel in
``csrc/flash_attn.cu`` for tensors on a CUDA device, and its plain PyTorch
version (``*_reference``) for tensors on the CPU. There is no fallback: a CUDA
input the kernel does not take raises. ``<function>.launches`` counts the
kernel launches; ``segmented_block_attention.launches_by_range`` splits them
by KV window length (the encoder's full-attention and windowed blocks). Both
count through ``common.graphs.count``, so a launch inside a captured program
(recognition's prefill) is counted once for each replay.

K1 replaces surya_tpu/ops/flash.py::segmented_block_attention, K2 replaces
surya_tpu/ops/flash.py::causal_flash_attention. Unlike the Pallas wrapper,
K1 reads q/k/v as [S, H, D] through their row strides (no transpose to
[H, S, D]), and walks for each 64 query rows only the span of keys their
groups can reach instead of the whole window; the kernel finds the spans
itself. That needs each group to be one contiguous run of slots, which
``qwen_encoder.plan_layout`` checks.

Under a mesh (parallel/mesh.py) the ``*_shard_map`` wrappers launch the same
kernels once a shard, at the shard's shapes (K1-mesh, K2-mesh), and count
their launches apart from the single-device wrappers'.
"""

from __future__ import annotations

import torch

from surya_tpu_torch.common import graphs
from surya_tpu_torch.ops import _build
from surya_tpu_torch.ops.attention import NEG_INF, sdpa
from surya_tpu_torch.parallel.mesh import Sharded, kernel_shardable

PLAN_CHUNK = 128  # query rows per kv_starts entry (qwen_encoder.FULL_ATTN_Q_CHUNK)
SEGMENTED_HEAD_DIM = 80  # the head dims the kernels are built for: recognition encoder
CAUSAL_HEAD_DIM = 128  # and decoder
CAUSAL_GROUP = 3  # K2's query heads per kv head, one consumer warpgroup each (12 / 4)
# (head dim, query heads per kv head) K2 is built for: the Qwen2-style
# decoder's and LFM2-MoE's attention layers' (2048 / 32, 32 / 8)
CAUSAL_SHAPES = ((CAUSAL_HEAD_DIM, CAUSAL_GROUP), (64, 4))


def shapes_text(shapes) -> str:
    """A kernel's (head dim, group) pairs, as its refusals name them."""
    return " and ".join(f"head dim {d} with {g} query heads per kv head" for d, g in shapes)


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


def _launch_segmented(name, q, k, v, seg_id, kv_starts, kv_range: int):
    """Check K1's inputs and launch it on q's device and current stream.
    Returns (output, kv_range clipped to S); counts nothing."""
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
    return out, kv_range


def segmented_block_attention(q, k, v, seg_id, kv_starts, kv_range: int):
    """q, k, v: [S, H, D] (post-RoPE; any row stride), seg_id: [S] int32 group
    id per row, each group one contiguous run of rows (padding rows: a unique
    id per 128-row chunk; plan_layout checks this, the kernel relies on it),
    kv_starts: [S / 128] int32 window start per query chunk, kv_range: window
    length. Returns [S, H, D]."""
    if q.device.type == "cpu":
        return segmented_block_attention_reference(q, k, v, seg_id, kv_starts, kv_range)
    out, kv_range = _launch_segmented("segmented_block_attention", q, k, v, seg_id, kv_starts, kv_range)
    graphs.count(segmented_block_attention)
    graphs.count(segmented_block_attention, "launches_by_range", kv_range)
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
    if (D, H // kvh) not in CAUSAL_SHAPES:
        raise ValueError(f"{name}: the kernel is built for {shapes_text(CAUSAL_SHAPES)}, got head dim {D} with "
                         f"{H}/{kvh} heads")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        _check_bf16_rows(name, t)


def _launch_causal(name, q, k, v):
    """Check K2's inputs and launch it on q's device and current stream;
    counts nothing."""
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
    return out


def causal_flash_attention(q, k, v, mesh=None):
    """q: [B, L, H, D], k/v: [B, L, kvh, D] (post-RoPE, right-padded rows).
    Query head h reads kv head h // (H / kvh). Padded query rows produce
    values the caller discards. Returns [B, L, H, D]. With a mesh, q, k, v
    and the result are Sharded (rows over data, heads over model): K2-mesh
    where the mesh divides them, else the gathered batch (see
    causal_flash_attention_shard_map)."""
    if mesh is not None:
        return _causal_on_mesh(q, k, v, mesh)
    if q.device.type == "cpu":
        return causal_flash_attention_reference(q, k, v)
    out = _launch_causal("causal_flash_attention", q, k, v)
    graphs.count(causal_flash_attention)
    return out


causal_flash_attention.launches = 0


# -- the mesh wrappers (surya_tpu/ops/flash.py *_shard_map) ---------------------
# Each runs its kernel once a shard, on the shard's device and current stream,
# with the shard's own shapes; on the CPU each shard runs the plain version.
# ``launches`` counts the kernel launches, ``launches_by_shard`` them by
# shard (d, m), ``launches_gathered`` the single-device launches of the
# gathered path (the dispatcher's, for a mesh that does not divide the batch
# or the heads: the JAX package sends those to its jnp reference), all
# through ``graphs.count`` (a captured launch counts once a replay).

def _count_shard(wrapper, dm) -> None:
    graphs.count(wrapper)
    graphs.count(wrapper, "launches_by_shard", key=dm)


def segmented_block_attention_shard_map(q, k, v, seg_id, kv_starts, kv_range: int, mesh):
    """K1-mesh, replacing surya_tpu/ops/flash.py::segmented_block_attention_
    shard_map: replicated, as there. The packed patch sequence is whole on
    every shard (the encoder is not partitioned), and each shard runs K1
    over all of it. q, k, v ([S, H, D]), seg_id and kv_starts are Sharded
    with no split dimension. Returns the Sharded outputs."""
    out = {}
    for dm in mesh.coords():
        if q[dm].device.type == "cpu":
            out[dm] = segmented_block_attention_reference(q[dm], k[dm], v[dm], seg_id[dm], kv_starts[dm], kv_range)
            continue
        out[dm], _ = _launch_segmented("segmented_block_attention_shard_map", q[dm], k[dm], v[dm], seg_id[dm],
                                       kv_starts[dm], kv_range)
        _count_shard(segmented_block_attention_shard_map, dm)
    return Sharded(mesh, q.spec, out)


def causal_flash_attention_shard_map(q, k, v, mesh):
    """K2-mesh, replacing surya_tpu/ops/flash.py::causal_flash_attention_
    shard_map: prefill rows over data, q and kv heads over model, as the
    column-parallel q/k/v projections leave them; attention is local to a
    shard, so there is no collective here (the row-parallel o_proj after it
    sums). q: Sharded [B, L, H, D], k/v: [B, L, kvh, D], spec (data, None,
    model, None). Returns the Sharded outputs, q's spec."""
    out = {}
    for dm in mesh.coords():
        if q[dm].device.type == "cpu":
            out[dm] = causal_flash_attention_reference(q[dm], k[dm], v[dm])
            continue
        out[dm] = _launch_causal("causal_flash_attention_shard_map", q[dm], k[dm], v[dm])
        _count_shard(causal_flash_attention_shard_map, dm)
    return Sharded(mesh, q.spec, out)


def _causal_on_mesh(q, k, v, mesh):
    """K2 on a mesh: K2-mesh where the mesh divides the rows and the heads,
    else K2 once over the batch gathered to the mesh's first device (the
    plain version on the CPU), its output split back as q is."""
    if kernel_shardable(mesh, q.global_size(0), q.global_size(2), k.global_size(2)):
        return causal_flash_attention_shard_map(q, k, v, mesh)
    qg, kg, vg = q.gather(), k.gather(), v.gather()
    if qg.device.type == "cpu":
        out = causal_flash_attention_reference(qg, kg, vg)
    else:
        out = _launch_causal("causal_flash_attention_shard_map", qg, kg, vg)
        graphs.count(causal_flash_attention_shard_map, "launches_gathered")
    return Sharded.split(out, mesh, q.spec)


segmented_block_attention_shard_map.launches = 0
segmented_block_attention_shard_map.launches_by_shard = {}
segmented_block_attention_shard_map.launches_gathered = 0  # always 0: K1-mesh is replicated, so always shardable
causal_flash_attention_shard_map.launches = 0
causal_flash_attention_shard_map.launches_by_shard = {}
causal_flash_attention_shard_map.launches_gathered = 0
