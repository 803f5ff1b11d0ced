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
Under a mesh, ``gqa_decode_shard_map`` (K3-mesh) launches the same kernels
once a shard, on the shard's own cache blocks.

On the card the valid rows of each (slot, kv head) (the chunk's columns
<= step, then the cache's rows < lengths[slot]) are read in 16-row
sub-tiles by one CTA, or shared round robin by the CTAs of a thread block
cluster where few slots hold a long cache (the kernel's host code picks
the cluster size from the shapes); the cluster's first CTA merges the
others' partial softmax states from their writes into its shared memory. Nothing is kept
between calls and nothing but the output is allocated. The grid follows
from the shapes alone: a call does not synchronise with the host.
"""

from __future__ import annotations

import torch

from surya_tpu_torch.common import graphs
from surya_tpu_torch.ops import _build
from surya_tpu_torch.ops.attention import NEG_INF
from surya_tpu_torch.ops.flash import shapes_text
from surya_tpu_torch.parallel.mesh import Sharded, kernel_shardable

HEAD_DIM, GROUP = 128, 3  # the recognition decoder's head dim and query heads per kv head
# (head dim, query heads per kv head) K3 is built for: the Qwen2-style
# decoder's and LFM2-MoE's attention layers'; K3q the first only
DECODE_SHAPES = ((HEAD_DIM, GROUP), (64, 4))
QUANT_SHAPES = ((HEAD_DIM, GROUP),)


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
    shapes = QUANT_SHAPES if quantized else DECODE_SHAPES
    if H % kvh or (D, H // kvh) not in shapes:
        raise ValueError(f"{name}: the kernel is built for {shapes_text(shapes)}, got {H}/{kvh} heads of dim {D}")
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


def gqa_decode(q, k_cache, v_cache, lengths, chunk_k, chunk_v, step: int, layer: int,
               k_scale=None, v_scale=None, mesh=None):
    """q: [B, H, D] current-token queries (post-RoPE); k/v_cache: [layers, B,
    kvh, S, D], bf16, or int8 with k/v_scale [layers, B, kvh, S] bf16;
    lengths: [B] int32 valid cache rows per slot; chunk_k/v: [layers, B, kvh,
    K, D]; step: chunk columns <= step are valid; layer: which layer to
    attend over. Returns [B, H, D]. With a mesh every array argument and
    the result are Sharded (see gqa_decode_shard_map)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("gqa_decode: give both k_scale and v_scale or neither")
    if mesh is not None:
        return _decode_on_mesh(q, k_cache, v_cache, lengths, chunk_k, chunk_v, step, layer, k_scale, v_scale, mesh)
    if q.device.type == "cpu":
        return gqa_decode_reference(q, k_cache, v_cache, lengths, chunk_k, chunk_v, step, layer, k_scale, v_scale)
    out = _launch_decode("gqa_decode", q, k_cache, v_cache, lengths, chunk_k, chunk_v, step, layer, k_scale, v_scale)
    graphs.count(gqa_decode, "launches_q" if k_scale is not None else "launches")
    return out


def _launch_decode(name, q, k_cache, v_cache, lengths, chunk_k, chunk_v, step, layer, k_scale, v_scale):
    """Check K3's (K3q's, with scales) inputs and launch it on q's device and
    current stream; counts nothing."""
    quantized = k_scale is not None
    name = f"{name}_int8" if quantized else name
    tensors = (q, k_cache, v_cache, lengths, chunk_k, chunk_v) + ((k_scale, v_scale) if quantized else ())
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    step, layer = _check_decode(name, q, k_cache, v_cache, lengths, chunk_k, chunk_v, step, layer, k_scale, v_scale)
    B, H, D = q.shape
    n_layers, _, kvh, S, _ = k_cache.shape
    K = chunk_k.shape[3]

    out = torch.empty_like(q)
    lib = _build.library().lib
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if quantized:
            rc = lib.surya_gqa_decode_int8(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                lengths.data_ptr(), chunk_k.data_ptr(), chunk_v.data_ptr(), out.data_ptr(),
                n_layers, B, H, kvh, D, S, K, step, layer, D**-0.5, stream,
            )
        else:
            rc = lib.surya_gqa_decode(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
                chunk_k.data_ptr(), chunk_v.data_ptr(), out.data_ptr(),
                n_layers, B, H, kvh, D, S, K, step, layer, D**-0.5, stream,
            )
    _build.check(rc, name)
    return out


gqa_decode.launches = 0  # K3, bf16 cache
gqa_decode.launches_q = 0  # K3q, int8 cache


# -- the mesh wrapper (surya_tpu/ops/decode_attn.py::gqa_decode_shard_map) -------

def gqa_decode_shard_map(q, k_cache, v_cache, lengths, chunk_k, chunk_v, step: int, layer: int,
                         k_scale=None, v_scale=None, mesh=None):
    """K3-mesh: K3 (K3q with scales) once a shard, slots over data and kv
    heads over model, as parallel/mesh.py places the cache; the int8 scales
    are split as the cache is. Attention is local to a (slot, kv head), so
    there is no collective here (the row-parallel o_proj after it sums). Each
    shard's cache, scales and chunk buffers are tensors of its own, so a
    launch reads them in place; the shard's grid is the single-device one at
    B / n_data slots and H / n_model heads. q: Sharded [B, H, D] (data,
    model, None); caches and chunks: Sharded [layers, B, kvh, S or K, D]
    (None, data, model, None, None); scales (None, data, model, None);
    lengths: Sharded [B] (data,). Returns the Sharded outputs, q's spec.
    ``launches``/``launches_q`` count K3/K3q launches, ``launches_by_shard``
    both by shard, ``launches_gathered`` the gathered path's
    (gqa_decode's dispatch), all through ``graphs.count`` (a captured
    chunk's per step that its replay ran); on the CPU each shard runs the
    plain version."""
    out = {}
    for dm in mesh.coords():
        args = (q[dm], k_cache[dm], v_cache[dm], lengths[dm], chunk_k[dm], chunk_v[dm], step, layer,
                k_scale[dm] if k_scale is not None else None, v_scale[dm] if v_scale is not None else None)
        if q[dm].device.type == "cpu":
            out[dm] = gqa_decode_reference(*args)
            continue
        out[dm] = _launch_decode("gqa_decode_shard_map", *args)
        graphs.count(gqa_decode_shard_map, "launches_q" if k_scale is not None else "launches")
        graphs.count(gqa_decode_shard_map, "launches_by_shard", key=dm)
    return Sharded(mesh, q.spec, out)


def _decode_on_mesh(q, k_cache, v_cache, lengths, chunk_k, chunk_v, step, layer, k_scale, v_scale, mesh):
    """gqa_decode's mesh branch: K3-mesh where the mesh divides the slots
    and both head counts; else (the JAX package takes its jnp reference
    there) the single-device kernel once, over the layer's slice of every
    input gathered to the mesh's first device (the plain version on the
    CPU), its output split back as q is."""
    if kernel_shardable(mesh, q.global_size(0), q.global_size(1), k_cache.global_size(2)):
        return gqa_decode_shard_map(q, k_cache, v_cache, lengths, chunk_k, chunk_v, step, layer, k_scale, v_scale,
                                    mesh=mesh)

    def layer_of(x):
        return Sharded(mesh, x.spec, {dm: t[layer:layer + 1] for dm, t in x.shards.items()}).gather()

    scales = (layer_of(k_scale), layer_of(v_scale)) if k_scale is not None else (None, None)
    args = (q.gather(), layer_of(k_cache), layer_of(v_cache), lengths.gather(), layer_of(chunk_k),
            layer_of(chunk_v), step, 0, *scales)
    if args[0].device.type == "cpu":
        out = gqa_decode_reference(*args)
    else:
        out = _launch_decode("gqa_decode_shard_map", *args)
        graphs.count(gqa_decode_shard_map, "launches_gathered")
    return Sharded.split(out, mesh, q.spec)


gqa_decode_shard_map.launches = 0  # K3 once a shard
gqa_decode_shard_map.launches_q = 0  # K3q once a shard
gqa_decode_shard_map.launches_by_shard = {}  # both, by shard (d, m)
gqa_decode_shard_map.launches_gathered = 0  # the single-device kernel on the gathered batch
