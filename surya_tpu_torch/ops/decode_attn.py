"""One-token GQA decode attention over the slot KV cache (K3, K3q).

``gqa_decode`` runs a hand-written CUDA kernel in ``csrc/decode_attn.cu`` for
tensors on a CUDA device and its plain PyTorch version for tensors on the
CPU; a CUDA input the kernels do not take raises. Replaces surya_tpu/ops/
decode_attn.py::gqa_decode_pallas: with a bf16 cache (K3, counted in
``gqa_decode.launches``) and with an int8 cache and bf16 per-row scales
(K3q, ``k_scale``/``v_scale`` given, counted in ``gqa_decode.launches_q``).

One decode step attends over two pieces, as one softmax:
  the frozen slot cache [layers, slots, kvh, S, D], rows < lengths[slot];
  this chunk's KV buffer [layers, slots, kvh, K, D], columns <= step.
Both come in as the full multi-layer arrays; the layer is picked inside.

On the card each (slot, kv head) is split into SPLIT_ROWS cache rows or
chunk columns, one warp a split, one CTA the kv heads of a (slot, split). A
split that is the only one of its (slot, kv head) writes the output;
otherwise it writes its partial softmax state to a workspace from
``torch.empty`` and counts itself in ``_merge_counts`` (one buffer per
stream), and the split that counts last merges them. The grid follows from
the shapes alone: a call does not synchronise with the host.
"""

from __future__ import annotations

import torch

from surya_tpu_torch.ops import _build
from surya_tpu_torch.ops.attention import NEG_INF

HEAD_DIM, GROUP = 128, 3  # the recognition decoder's head dim and query heads per kv head
MAX_KV_HEADS = 4  # kv heads of one CTA, one warp each: MAX_KVH in csrc/decode_attn.cu
SPLIT_ROWS = 64  # rows of one split: DEC_TILE in csrc/decode_attn.cu


def workspace_floats(B: int, kvh: int, S: int, K: int) -> int:
    """fp32 values of the splits' partials: (acc[G][D], m, l) for every
    (slot, kv head, split), split or not."""
    n_splits = -(-S // SPLIT_ROWS) + -(-K // SPLIT_ROWS)
    return B * kvh * n_splits * GROUP * (HEAD_DIM + 2)


def gqa_decode_reference(q, k_cache, v_cache, lengths, chunk_k, chunk_v, step: int, layer: int,
                         k_scale=None, v_scale=None):
    """Plain version: mirrors surya_tpu gqa_decode_reference in fp32. An int8
    cache is dequantized with its scales to float32, as the Pallas kernel
    does (the JAX reference then casts to the chunk dtype, which changes
    nothing in float32). Returns [B, H, D] in q's dtype."""
    B, H, D = q.shape
    kc, vc = k_cache[layer].float(), v_cache[layer].float()
    if k_scale is not None:
        kc = kc * k_scale[layer].float()[..., None]
        vc = vc * v_scale[layer].float()[..., None]
    ck, cv = chunk_k[layer].float(), chunk_v[layer].float()
    kvh, S, K = kc.shape[1], kc.shape[2], ck.shape[2]
    qg = q.float().reshape(B, kvh, H // kvh, D)
    scale = D**-0.5
    dev = q.device
    l1 = torch.einsum("bhgd,bhkd->bhgk", qg, kc) * scale
    l1 = l1.masked_fill(~(torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None], NEG_INF)
    l2 = torch.einsum("bhgd,bhkd->bhgk", qg, ck) * scale
    l2 = l2.masked_fill(~(torch.arange(K, device=dev) <= step), NEG_INF)
    m = torch.maximum(l1.amax(-1, keepdim=True), l2.amax(-1, keepdim=True))
    e1, e2 = torch.exp(l1 - m), torch.exp(l2 - m)
    denom = e1.sum(-1, keepdim=True) + e2.sum(-1, keepdim=True)
    out = torch.einsum("bhgk,bhkd->bhgd", e1 / denom, vc) + torch.einsum("bhgk,bhkd->bhgd", e2 / denom, cv)
    return out.reshape(B, H, D).to(q.dtype)


def _check_decode(name, q, k_cache, v_cache, lengths, chunk_k, chunk_v, step, layer, k_scale=None,
                  v_scale=None) -> tuple:
    """Raise for what K3 / K3q (scales given) do not take; returns (step, layer) as ints."""
    quantized = k_scale is not None
    tensors = (q, k_cache, v_cache, lengths, chunk_k, chunk_v) + ((k_scale, v_scale) if quantized else ())
    B, H, D = q.shape
    n_layers, _, kvh, S, _ = k_cache.shape
    K = chunk_k.shape[3]
    if k_cache.shape != (n_layers, B, kvh, S, D) or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: cache {tuple(k_cache.shape)} does not match q {tuple(q.shape)}")
    if chunk_k.shape != (n_layers, B, kvh, K, D) or chunk_v.shape != chunk_k.shape:
        raise ValueError(f"{name}: chunk {tuple(chunk_k.shape)} does not match cache {tuple(k_cache.shape)}")
    if quantized and (k_scale.shape != k_cache.shape[:-1] or v_scale.shape != k_scale.shape):
        raise ValueError(f"{name}: scales {tuple(k_scale.shape)} do not match cache {tuple(k_cache.shape)}")
    if H != GROUP * kvh or D != HEAD_DIM or kvh > MAX_KV_HEADS:
        raise ValueError(f"{name}: the kernel is built for {GROUP} query heads per kv head, at most "
                         f"{MAX_KV_HEADS} kv heads and head dim {HEAD_DIM}, got {H}/{kvh} heads of dim {D}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: lengths must be int32 [{B}]")
    cache_dtype = torch.int8 if quantized else torch.bfloat16
    if k_cache.dtype != cache_dtype or v_cache.dtype != cache_dtype:
        raise TypeError(f"{name}: kernel takes a {cache_dtype} cache, got {k_cache.dtype}/{v_cache.dtype}")
    if any(t.dtype != torch.bfloat16 for t in (q, chunk_k, chunk_v) + ((k_scale, v_scale) if quantized else ())):
        raise TypeError(f"{name}: kernel takes bfloat16 queries, chunk buffers and scales")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    step, layer = int(step), int(layer)
    if not (0 <= step < K and 0 <= layer < n_layers):
        raise ValueError(f"{name}: step {step} / layer {layer} out of range (K={K}, layers={n_layers})")
    return step, layer


_COUNTS = {}


def _merge_counts(dev: torch.device, n: int) -> torch.Tensor:
    """n int32 zeros on dev, one per (slot, kv head), for the calls on the
    current stream: the kernel counts the splits that have ended in them and
    sets each back to 0 when it merges, so one buffer serves every call of
    that size on that stream and every replay of a CUDA graph captured on
    it. Calls on one stream never overlap; each predictor decodes on a
    stream of its own, so two predictors never share a buffer (a graph that
    holds one must be captured on its predictor's stream). Kept for the life
    of the process, since a captured graph holds its address; PyTorch takes
    streams from a fixed pool, so the buffers are few."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream, n)
    if key not in _COUNTS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("gqa_decode: call it once on the capturing stream outside CUDA graph capture "
                               "first, so that its merge counts are allocated and zeroed")
        _COUNTS[key] = torch.zeros(n, dtype=torch.int32, device=dev)
    return _COUNTS[key]


def gqa_decode(q, k_cache, v_cache, lengths, chunk_k, chunk_v, step: int, layer: int,
               k_scale=None, v_scale=None):
    """q: [B, H, D] current-token queries (post-RoPE); k/v_cache: [layers, B,
    kvh, S, D], bf16, or int8 with k/v_scale [layers, B, kvh, S] bf16;
    lengths: [B] int32 valid cache rows per slot; chunk_k/v: [layers, B, kvh,
    K, D]; step: chunk columns <= step are valid; layer: which layer to
    attend over. Returns [B, H, D]."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("gqa_decode: give both k_scale and v_scale or neither")
    quantized = k_scale is not None
    if q.device.type == "cpu":
        return gqa_decode_reference(q, k_cache, v_cache, lengths, chunk_k, chunk_v, step, layer, k_scale, v_scale)
    name = "gqa_decode_int8" if quantized else "gqa_decode"
    tensors = (q, k_cache, v_cache, lengths, chunk_k, chunk_v) + ((k_scale, v_scale) if quantized else ())
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    step, layer = _check_decode(name, q, k_cache, v_cache, lengths, chunk_k, chunk_v, step, layer, k_scale, v_scale)
    B, H, D = q.shape
    kvh, S, K = k_cache.shape[2], k_cache.shape[3], chunk_k.shape[3]

    out = torch.empty_like(q)
    ws = torch.empty(workspace_floats(B, kvh, S, K), dtype=torch.float32, device=dev)
    done = _merge_counts(dev, B * kvh)
    lib = _build.library().lib
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if quantized:
            rc = lib.surya_gqa_decode_int8(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                lengths.data_ptr(), chunk_k.data_ptr(), chunk_v.data_ptr(), out.data_ptr(),
                ws.data_ptr(), ws.numel(), done.data_ptr(), B, H, kvh, D, S, K, step, layer, D**-0.5, stream,
            )
        else:
            rc = lib.surya_gqa_decode(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
                chunk_k.data_ptr(), chunk_v.data_ptr(), out.data_ptr(),
                ws.data_ptr(), ws.numel(), done.data_ptr(), B, H, kvh, D, S, K, step, layer, D**-0.5, stream,
            )
    _build.check(rc, name)
    if quantized:
        gqa_decode.launches_q += 1
    else:
        gqa_decode.launches += 1
    return out


gqa_decode.launches = 0  # K3, bf16 cache
gqa_decode.launches_q = 0  # K3q, int8 cache
