"""Qwen2-style autoregressive decoder (recognition), in PyTorch.

Counterpart of surya_tpu/models/qwen_decoder.py. The KV cache is a
preallocated slot array [layers, slots, kvh, max_seq, hd] (head-major rows,
as kernel K3 reads them) with a per-slot length; sequences are left-aligned.
Prefill runs right-padded rows with a causal mask (kernel K2); a decode step
writes its new KV into a small per-chunk buffer and attends over the frozen
cache plus that buffer (kernel K3); the chunk is committed once at its end.

Where JAX donated buffers, the port writes in place: ``merge_prefill`` and
``commit_chunk`` update the cache tensors, ``decode_step_chunked`` updates
the chunk buffers.

``init_cache(..., quantize=True)`` stores the cache as int8 with one bf16
scale per (layer, slot, head, row) (``RECOGNITION_MODEL_QUANTIZE``); the
chunk buffers stay in the compute dtype, and rows are quantized when they
enter the cache (kernel K3q reads them).

``quantize_weights`` swaps the seven projections of every layer for int8
weights with float32 per-channel scales (``RECOGNITION_WEIGHT_QUANTIZE``).

Under a mesh (parallel/mesh.py) ``ShardedDecoder`` runs the same layers
tensor-parallel, each shard over its data shard's rows with its
``DecoderShard``, on a cache that ``init_cache(..., mesh=...)`` shards.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from surya_tpu_torch import nn as pnn
from surya_tpu_torch.ops import attention as att
from surya_tpu_torch.ops import decode_attn, flash
from surya_tpu_torch.models.qwen_encoder import _MLP
from surya_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Sharded, all_reduce_sum, row_epilogue, row_matmul, slice_linear, split_sizes,
)


@dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 65536
    hidden_size: int = 1536
    intermediate_size: int = 4096
    num_hidden_layers: int = 10
    num_attention_heads: int = 12
    num_key_value_heads: int = 4
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    model_type: str = "qwen2"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def cache_layers(self) -> int:
        """Layers with KV in the slot cache: every layer."""
        return self.num_hidden_layers


class _SelfAttention(nn.Module):
    def __init__(self, config: DecoderConfig):
        super().__init__()
        h, hd = config.hidden_size, config.head_dim
        self.q_proj = nn.Linear(h, config.num_attention_heads * hd)
        self.k_proj = nn.Linear(h, config.num_key_value_heads * hd)
        self.v_proj = nn.Linear(h, config.num_key_value_heads * hd)
        self.o_proj = nn.Linear(config.num_attention_heads * hd, h, bias=False)


class _Layer(nn.Module):
    def __init__(self, config: DecoderConfig):
        super().__init__()
        h = config.hidden_size
        self.input_layernorm = pnn.RMSNorm(h, config.rms_norm_eps)
        self.post_attention_layernorm = pnn.RMSNorm(h, config.rms_norm_eps)
        self.self_attn = _SelfAttention(config)
        self.mlp = _MLP(h, config.intermediate_size, bias=False)


class Decoder(nn.Module):
    """Submodule names follow surya_tpu qwen_decoder.init_params' pytree."""

    def __init__(self, config: DecoderConfig):
        super().__init__()
        self.config = config
        self.layers = nn.ModuleList(_Layer(config) for _ in range(config.num_hidden_layers))
        self.norm = pnn.RMSNorm(config.hidden_size, config.rms_norm_eps)

    def _qkv(self, layer: _Layer, x):
        B, S, _ = x.shape
        c = self.config
        sa = layer.self_attn
        q = sa.q_proj(x).view(B, S, c.num_attention_heads, c.head_dim)
        k = sa.k_proj(x).view(B, S, c.num_key_value_heads, c.head_dim)
        v = sa.v_proj(x).view(B, S, c.num_key_value_heads, c.head_dim)
        return q, k, v

    def rope(self, positions):
        """positions [..., S] -> cos/sin [..., S, head_dim]."""
        freqs = att.rope_freqs(positions, self.config.head_dim, self.config.rope_theta)
        ang = torch.cat([freqs, freqs], dim=-1)
        return ang.cos(), ang.sin()

    def prefill(self, embeds, seq_lens, use_kernels: bool = True):
        """Full-sequence causal forward over right-padded rows.
        embeds: [B, L, hidden]; seq_lens: [B] valid lengths.
        Returns (new_k [layers, B, L, kvh, hd], new_v, last_hidden [B, hidden])."""
        B, L, _ = embeds.shape
        cos, sin = self.rope(torch.arange(L, device=embeds.device))
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
        attend = flash.causal_flash_attention if use_kernels else flash.causal_flash_attention_reference
        x = embeds
        ks, vs = [], []
        for layer in self.layers:
            q, k, v = self._qkv(layer, layer.input_layernorm(x))
            q, k = att.apply_rope(q, k, cos, sin)
            ks.append(k)
            vs.append(v)
            out = attend(q, k, v)
            x = x + layer.self_attn.o_proj(out.reshape(B, L, -1))
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        x = self.norm(x)
        last = x[torch.arange(B, device=x.device), seq_lens.long() - 1]
        return torch.stack(ks), torch.stack(vs), last

    def decode_step_chunked(self, cache: dict, chunk_k, chunk_v, embeds, step: int, base_len,
                            use_kernels: bool = True):
        """One decode token with the big cache read-only. The new KV lands in
        the chunk buffers (in place) at column `step`; attention covers cache
        rows < base_len and chunk columns <= step. embeds: [B, hidden];
        base_len: [B] cache lengths at chunk start. Returns hidden [B, hidden]."""
        B = embeds.shape[0]
        cos, sin = self.rope((base_len + step).float()[:, None])
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        attend = decode_attn.gqa_decode if use_kernels else decode_attn.gqa_decode_reference
        scales = (cache["k_scale"], cache["v_scale"]) if "k_scale" in cache else (None, None)
        x = embeds[:, None, :]
        for li, layer in enumerate(self.layers):
            q, k, v = self._qkv(layer, layer.input_layernorm(x))
            q, k = att.apply_rope(q, k, cos, sin)
            chunk_k[li, :, :, step] = k[:, 0]
            chunk_v[li, :, :, step] = v[:, 0]
            # the full cache/chunk arrays go in; the kernel picks the layer
            out = attend(q[:, 0], cache["k"], cache["v"], base_len, chunk_k, chunk_v, step, li, *scales)
            x = x + layer.self_attn.o_proj(out.reshape(B, 1, -1))
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        return self.norm(x)[:, 0]


def rope_tables(config: DecoderConfig, positions):
    """positions [..., S] -> cos/sin [..., S, head_dim] (Decoder.rope)."""
    freqs = att.rope_freqs(positions, config.head_dim, config.rope_theta)
    ang = torch.cat([freqs, freqs], dim=-1)
    return ang.cos(), ang.sin()


class DecoderShard(nn.Module):
    """Model index `index` of `parts` of a decoder, on one device, by the TP
    plan of parallel/mesh.py: its q and kv heads (whole heads; the index's
    share of split_sizes), its slice of the MLP, the input slices of o_proj
    and down_proj (whose partial products the model shards sum), and the
    replicated norms of `replica`, the decoder of that device's replicated
    model. With one part on the decoder's own device its layers are the
    decoder's own."""

    def __init__(self, decoder: Decoder, replica: Decoder, index: int, parts: int, device):
        super().__init__()
        c = self.config = decoder.config
        self.n_heads = split_sizes(c.num_attention_heads, parts)[index]
        self.n_kv_heads = split_sizes(c.num_key_value_heads, parts)[index]
        self.layers = nn.ModuleList()
        for src, rep in zip(decoder.layers, replica.layers):
            layer = nn.Module()
            layer.input_layernorm, layer.post_attention_layernorm = rep.input_layernorm, rep.post_attention_layernorm
            layer.self_attn, layer.mlp = nn.Module(), nn.Module()
            for block, names, unit in ((src.self_attn, ("q_proj", "k_proj", "v_proj", "o_proj"), c.head_dim),
                                       (src.mlp, ("gate_proj", "up_proj", "down_proj"), 1)):
                target = layer.self_attn if block is src.self_attn else layer.mlp
                for name in names:
                    setattr(target, name, slice_linear(getattr(block, name), name, index, parts, unit, device))
            self.layers.append(layer)
        self.norm = replica.norm

    def qkv(self, layer, x):
        B, S, _ = x.shape
        hd = self.config.head_dim
        sa = layer.self_attn
        return (sa.q_proj(x).view(B, S, self.n_heads, hd), sa.k_proj(x).view(B, S, self.n_kv_heads, hd),
                sa.v_proj(x).view(B, S, self.n_kv_heads, hd))


class ShardedDecoder:
    """The decoder tensor-parallel over a mesh (surya_tpu qwen_decoder's
    prefill and decode_step_chunked with a mesh). Shard (d, m) runs its
    DecoderShard over data shard d's rows: its heads' attention through
    K2-mesh in prefill and K3-mesh in decode, its slice of the MLP, and after
    o_proj and down_proj the row-parallel sum over the model axis. Per-shard
    values are dicts {(d, m): tensor}; the kernels get them as Sharded."""

    def __init__(self, placement):
        self.mesh = placement.mesh
        self.shards = {dm: placement.decoder_shard(*dm) for dm in self.mesh.coords()}
        self.config = self.shards[0, 0].config

    def _add_row_parallel(self, x: dict, partial: dict, li: int, block: str, name: str) -> dict:
        """x + the row layer's output: its partials summed over each data
        row's model shards, then its scale and bias."""
        mesh, out = self.mesh, {}
        for d in range(mesh.n_data):
            row = [(d, m) for m in range(mesh.n_model)]
            for dm, total in zip(row, all_reduce_sum([partial[dm] for dm in row], [mesh.device(*dm) for dm in row])):
                lin = getattr(getattr(self.shards[dm].layers[li], block), name)
                out[dm] = x[dm] + row_epilogue(lin, total)
        return out

    def _mlp(self, x: dict, li: int) -> dict:
        partial = {}
        for dm, xs in x.items():
            layer = self.shards[dm].layers[li]
            mlp, h = layer.mlp, layer.post_attention_layernorm(xs)
            partial[dm] = row_matmul(mlp.down_proj, F.silu(mlp.gate_proj(h)) * mlp.up_proj(h))
        return self._add_row_parallel(x, partial, li, "mlp", "down_proj")

    def prefill(self, embeds: dict, seq_lens: dict):
        """embeds {(d, m): [rows_d, L, hidden]}, seq_lens {(d, m): [rows_d]}.
        Returns (new_k, new_v: Sharded [layers, rows, L, kvh, hd]
        (PREFILL_KV_SPEC), last_hidden {(d, m): [rows_d, hidden]})."""
        mesh, c = self.mesh, self.config
        rope, ks, vs = {}, {}, {}
        for dm, e in embeds.items():
            cos, sin = rope_tables(c, torch.arange(e.shape[1], device=e.device))
            rope[dm], ks[dm], vs[dm] = (cos[None, :, None, :], sin[None, :, None, :]), [], []
        x = dict(embeds)
        for li in range(c.num_hidden_layers):
            q, k, v = {}, {}, {}
            for dm, xs in x.items():
                shard = self.shards[dm]
                layer = shard.layers[li]
                qs, kk, v[dm] = shard.qkv(layer, layer.input_layernorm(xs))
                q[dm], k[dm] = att.apply_rope(qs, kk, *rope[dm])
                ks[dm].append(k[dm])
                vs[dm].append(v[dm])
            out = flash.causal_flash_attention(*(Sharded(mesh, PREFILL_SPEC, t) for t in (q, k, v)), mesh=mesh)
            partial = {dm: row_matmul(self.shards[dm].layers[li].self_attn.o_proj,
                                      out[dm].reshape(*xs.shape[:2], -1)) for dm, xs in x.items()}
            x = self._mlp(self._add_row_parallel(x, partial, li, "self_attn", "o_proj"), li)
        last = {}
        for dm, xs in x.items():
            xs = self.shards[dm].norm(xs)
            last[dm] = xs[torch.arange(xs.shape[0], device=xs.device), seq_lens[dm].long() - 1]
        return (Sharded(mesh, PREFILL_KV_SPEC, {dm: torch.stack(t) for dm, t in ks.items()}),
                Sharded(mesh, PREFILL_KV_SPEC, {dm: torch.stack(t) for dm, t in vs.items()}), last)

    def decode_step_chunked(self, cache: dict, chunk_k: Sharded, chunk_v: Sharded, embeds: dict, step: int,
                            base_len: Sharded) -> dict:
        """One decode token over a sharded cache (read-only) and the
        shards' chunk buffers (written at column `step`, in place), as
        Decoder.decode_step_chunked. embeds {(d, m): [slots_d, hidden]}.
        Returns {(d, m): hidden [slots_d, hidden]}."""
        mesh, c = self.mesh, self.config
        scales = (cache["k_scale"], cache["v_scale"]) if "k_scale" in cache else (None, None)
        rope = {}
        for dm in embeds:
            cos, sin = rope_tables(c, (base_len[dm] + step).float()[:, None])
            rope[dm] = (cos[:, :, None, :], sin[:, :, None, :])
        x = {dm: e[:, None, :] for dm, e in embeds.items()}
        for li in range(c.num_hidden_layers):
            q = {}
            for dm, xs in x.items():
                shard = self.shards[dm]
                layer = shard.layers[li]
                qs, k, v = shard.qkv(layer, layer.input_layernorm(xs))
                qs, k = att.apply_rope(qs, k, *rope[dm])
                chunk_k[dm][li, :, :, step] = k[:, 0]
                chunk_v[dm][li, :, :, step] = v[:, 0]
                q[dm] = qs[:, 0]
            out = decode_attn.gqa_decode(Sharded(mesh, DECODE_Q_SPEC, q), cache["k"], cache["v"], base_len,
                                         chunk_k, chunk_v, step, li, *scales, mesh=mesh)
            partial = {dm: row_matmul(self.shards[dm].layers[li].self_attn.o_proj, out[dm].reshape(xs.shape[0], 1, -1))
                       for dm, xs in x.items()}
            x = self._mlp(self._add_row_parallel(x, partial, li, "self_attn", "o_proj"), li)
        return {dm: self.shards[dm].norm(xs)[:, 0] for dm, xs in x.items()}


def quantize_weights(decoder: Decoder) -> Decoder:
    """Weight-only int8 for every decoder projection (RECOGNITION_WEIGHT_
    QUANTIZE), in place: q, k, v, o and gate, up, down of every layer become
    ``nn.QuantLinear``s (surya_tpu qwen_decoder.quantize_weights). The
    weights are quantized as they are, so after the cast to the model dtype,
    as the JAX package quantizes its params at MODEL_DTYPE."""
    for layer in decoder.layers:
        for block, names in ((layer.self_attn, ("q_proj", "k_proj", "v_proj", "o_proj")),
                             (layer.mlp, ("gate_proj", "up_proj", "down_proj"))):
            for name in names:
                setattr(block, name, pnn.quantize_linear(getattr(block, name)))
    return decoder


def init_cache(config: DecoderConfig, n_slots: int, max_seq: int, dtype, device, quantize: bool = False,
               mesh=None) -> dict:
    """Slot KV cache {"k", "v": [layers, slots, kvh, max_seq, hd], "len": [slots]
    int32}; with ``quantize`` k/v are int8 and "k_scale"/"v_scale" hold the
    bf16 scales [layers, slots, kvh, max_seq]. With a mesh each entry is
    Sharded as surya_tpu's cache_sharding places it (CACHE_SPECS): slots
    over data, kv heads over model, every shard's block a tensor of its own
    on its device (`device` is not read)."""
    if mesh is not None:
        return _init_sharded_cache(config, n_slots, max_seq, dtype, quantize, mesh)
    shape = (config.num_hidden_layers, n_slots, config.num_key_value_heads, max_seq, config.head_dim)
    cache = {"len": torch.zeros((n_slots,), dtype=torch.int32, device=device)}
    if quantize:
        cache["k"] = torch.zeros(shape, dtype=torch.int8, device=device)
        cache["v"] = torch.zeros(shape, dtype=torch.int8, device=device)
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device)
    else:
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


# how a sharded cache and the decoder's arrays split over a mesh (PartitionSpecs)
CACHE_SPECS = {
    "k": (None, DATA_AXIS, MODEL_AXIS, None, None),  # [layers, slots, kvh, S, hd]
    "v": (None, DATA_AXIS, MODEL_AXIS, None, None),
    "k_scale": (None, DATA_AXIS, MODEL_AXIS, None),  # [layers, slots, kvh, S]
    "v_scale": (None, DATA_AXIS, MODEL_AXIS, None),
    "len": (DATA_AXIS,),
}
CHUNK_SPEC = CACHE_SPECS["k"]  # the chunk buffers [layers, slots, kvh, K, hd]
PREFILL_SPEC = (DATA_AXIS, None, MODEL_AXIS, None)  # prefill q/k/v [rows, L, heads, hd]
PREFILL_KV_SPEC = (None, DATA_AXIS, None, MODEL_AXIS, None)  # prefill's new_k/new_v [layers, rows, L, kvh, hd]
DECODE_Q_SPEC = (DATA_AXIS, MODEL_AXIS, None)  # a decode step's q [slots, heads, hd]
ROWS_SPEC = (DATA_AXIS,)  # per-row or per-slot arrays, whole on every model shard


def _init_sharded_cache(config: DecoderConfig, n_slots: int, max_seq: int, dtype, quantize: bool, mesh) -> dict:
    slots = split_sizes(n_slots, mesh.n_data)
    heads = split_sizes(config.num_key_value_heads, mesh.n_model)
    kv_dtype = torch.int8 if quantize else dtype
    cache = {key: {} for key in ("len", "k", "v") + (("k_scale", "v_scale") if quantize else ())}
    for d, m in mesh.coords():
        dev = mesh.device(d, m)
        shape = (config.num_hidden_layers, slots[d], heads[m], max_seq, config.head_dim)
        cache["len"][d, m] = torch.zeros((slots[d],), dtype=torch.int32, device=dev)
        for key in ("k", "v"):
            cache[key][d, m] = torch.zeros(shape, dtype=kv_dtype, device=dev)
        for key in ("k_scale", "v_scale") if quantize else ():
            cache[key][d, m] = torch.zeros(shape[:-1], dtype=torch.bfloat16, device=dev)
    return {key: Sharded(mesh, CACHE_SPECS[key], shards) for key, shards in cache.items()}


def shard_view(cache: dict, dm) -> dict:
    """Shard dm's part of a sharded cache, as an unsharded cache dict of its
    tensors: merge_prefill and commit_chunk update it in place."""
    return {key: value[dm] for key, value in cache.items()}


def quantize_kv(x):
    """Symmetric per-vector int8: x [..., head_dim] -> (int8 values, bf16
    scales [...]). As surya_tpu's quantize_kv, bit for bit: the values are
    divided by the float32 scale and rounded half to even, and the scale is
    stored rounded to bf16 afterwards."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1) / 127.0, min=1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q, scale, dtype):
    return (q.float() * scale.float()[..., None]).to(dtype)


def _store(cache: dict, index, k, v) -> None:
    """cache["k"/"v"][index] = k/v, quantizing them first for an int8 cache."""
    if "k_scale" in cache:
        (k, k_scale), (v, v_scale) = quantize_kv(k), quantize_kv(v)
        cache["k_scale"][index] = k_scale
        cache["v_scale"][index] = v_scale
    cache["k"][index] = k
    cache["v"][index] = v


def merge_prefill(cache: dict, new_k, new_v, seq_lens, slot_idx) -> dict:
    """Write a prefill's KV rows into cache slots (left-aligned, in place) and
    set the slot lengths. new_k/new_v: [layers, B, L, kvh, hd]; slot_idx: [B].
    Padding rows all target the trash slot, so that slot may be written more
    than once; nothing ever reads it."""
    L = new_k.shape[2]
    slot_idx = slot_idx.long()
    _store(cache, (slice(None), slot_idx, slice(None), slice(0, L)), new_k.transpose(2, 3), new_v.transpose(2, 3))
    cache["len"][slot_idx] = seq_lens.to(torch.int32)
    return cache


def merge_prefill_slots(cache: dict, new_k, new_v, seq_lens, rows, take) -> dict:
    """merge_prefill by slot (in place): slot s takes row rows[s]'s KV rows
    [0, L) and length where take[s], and keeps its own elsewhere; rows and
    take [slots]. Every slot is rewritten, so the shapes do not depend on
    which slots the rows fill. new_k/new_v: [layers, B, L, kvh, hd]."""
    L = new_k.shape[2]
    src = rows.clamp(0, new_k.shape[1] - 1).long()
    k, v = (x.index_select(1, src).transpose(2, 3) for x in (new_k, new_v))  # [layers, slots, kvh, L, hd]
    sel = take[None, :, None, None]
    if "k_scale" in cache:
        (k, k_scale), (v, v_scale) = quantize_kv(k), quantize_kv(v)
        for name, value in (("k_scale", k_scale), ("v_scale", v_scale)):
            cache[name][..., :L] = torch.where(sel, value, cache[name][..., :L])
    for name, value in (("k", k), ("v", v)):
        cache[name][:, :, :, :L] = torch.where(sel[..., None], value, cache[name][:, :, :, :L])
    cache["len"].copy_(torch.where(take, seq_lens.to(torch.int32)[src], cache["len"]))
    return cache


def commit_chunk(cache: dict, chunk_k, chunk_v, base_len, advance) -> dict:
    """Write a finished chunk's KV ([layers, B, kvh, K, hd]) into the cache at
    rows [base_len, base_len + K) per slot (in place) and advance the lengths.
    Rows are clamped to S - 1, so that row may be written more than once; it
    lies beyond every valid length, as do the garbage columns of steps after
    a slot finished."""
    n_slots, kvh, S = cache["k"].shape[1], cache["k"].shape[2], cache["k"].shape[3]
    K = chunk_k.shape[3]
    dev = chunk_k.device
    slots = torch.arange(n_slots, device=dev)[:, None, None]
    heads = torch.arange(kvh, device=dev)[None, :, None]
    rows = torch.clamp(base_len.long()[:, None, None] + torch.arange(K, device=dev)[None, None, :], max=S - 1)
    _store(cache, (slice(None), slots, heads, rows), chunk_k, chunk_v)
    cache["len"] += advance.to(torch.int32)
    return cache


# -- checkpoint conversion ----------------------------------------------------

def convert_torch(bag, config: DecoderConfig, prefix: str = "decoder") -> dict:
    """The upstream torch decoder's tensors as surya_tpu qwen_decoder's pytree
    (numpy leaves, JAX layout; surya_tpu qwen_decoder.convert_torch)."""
    layers = []
    for i in range(config.num_hidden_layers):
        b = f"{prefix}.layers.{i}"
        layers.append(
            {
                "input_layernorm": bag.rmsnorm(f"{b}.input_layernorm"),
                "post_attention_layernorm": bag.rmsnorm(f"{b}.post_attention_layernorm"),
                "self_attn": {
                    "q_proj": bag.linear(f"{b}.self_attn.q_proj"),
                    "k_proj": bag.linear(f"{b}.self_attn.k_proj"),
                    "v_proj": bag.linear(f"{b}.self_attn.v_proj"),
                    "o_proj": bag.linear(f"{b}.self_attn.o_proj", bias=False),
                },
                "mlp": {
                    "gate_proj": bag.linear(f"{b}.mlp.gate_proj", bias=False),
                    "up_proj": bag.linear(f"{b}.mlp.up_proj", bias=False),
                    "down_proj": bag.linear(f"{b}.mlp.down_proj", bias=False),
                },
            }
        )
    return {"layers": layers, "norm": bag.rmsnorm(f"{prefix}.norm")}
