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
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from surya_tpu_torch import nn as pnn
from surya_tpu_torch.ops import attention as att
from surya_tpu_torch.ops import decode_attn, flash
from surya_tpu_torch.models.qwen_encoder import _MLP


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

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


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
        x = embeds[:, None, :]
        for li, layer in enumerate(self.layers):
            q, k, v = self._qkv(layer, layer.input_layernorm(x))
            q, k = att.apply_rope(q, k, cos, sin)
            chunk_k[li, :, :, step] = k[:, 0]
            chunk_v[li, :, :, step] = v[:, 0]
            # the full cache/chunk arrays go in; the kernel picks the layer
            out = attend(q[:, 0], cache["k"], cache["v"], base_len, chunk_k, chunk_v, step, li)
            x = x + layer.self_attn.o_proj(out.reshape(B, 1, -1))
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        return self.norm(x)[:, 0]


def init_cache(config: DecoderConfig, n_slots: int, max_seq: int, dtype, device) -> dict:
    """Slot KV cache {"k", "v": [layers, slots, kvh, max_seq, hd], "len": [slots] int32}."""
    shape = (config.num_hidden_layers, n_slots, config.num_key_value_heads, max_seq, config.head_dim)
    return {
        "len": torch.zeros((n_slots,), dtype=torch.int32, device=device),
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def merge_prefill(cache: dict, new_k, new_v, seq_lens, slot_idx) -> dict:
    """Write a prefill's KV rows into cache slots (left-aligned, in place) and
    set the slot lengths. new_k/new_v: [layers, B, L, kvh, hd]; slot_idx: [B].
    Padding rows all target the trash slot, so that slot may be written more
    than once; nothing ever reads it."""
    L = new_k.shape[2]
    slot_idx = slot_idx.long()
    cache["k"][:, slot_idx, :, :L] = new_k.transpose(2, 3)
    cache["v"][:, slot_idx, :, :L] = new_v.transpose(2, 3)
    cache["len"][slot_idx] = seq_lens.to(torch.int32)
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
    cache["k"][:, slots, heads, rows] = chunk_k
    cache["v"][:, slots, heads, rows] = chunk_v
    cache["len"] += advance.to(torch.int32)
    return cache
