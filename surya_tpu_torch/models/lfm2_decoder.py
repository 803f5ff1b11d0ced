"""LFM2-MoE's language model as the recognition foundation model's decoder
(``decoder.model_type`` "lfm2_moe"), in PyTorch.

The layers are those of ``transformers``' Lfm2Moe: each layer is an
``operator_norm`` and either a gated short convolution ("conv") or GQA
attention ("full_attention"), added to the residual, then an ``ffn_norm``
and a feed-forward, added too: a dense SwiGLU in the first
``num_dense_layers`` layers, a sparse-expert one (ops/moe.py) in the rest;
``embedding_norm`` after the last layer.

- conv: ``B, C, x = in_proj(h)``, ``y = out_proj(C * conv(B * x))``, where
  conv is a causal depthwise convolution of ``conv_L_cache`` taps over the
  positions.
- attention: q and k RMS-normed per head (``q_layernorm``,
  ``k_layernorm``), RoPE, causal GQA (kernel K2 in prefill, K3 in decode),
  ``out_proj``.

The slot cache (``init_cache``) holds two kinds of state side by side: the
attention layers' KV, indexed by attention layer ([attention layers, slots,
kvh, max_seq, hd], as qwen_decoder's, which K3 reads), and each conv layer's
convolution state ("conv": [conv layers, slots, conv_L_cache - 1, hidden]),
the last ``B * x`` columns of each slot. Prefill leaves, for each row, the
columns of its valid tail (rows are right-padded: a ragged gather), which
``merge_prefill`` writes into the row's slot, overwriting what the slot
held. A decode chunk takes the slots' state into a buffer of its own at its
start, rolls it in place at every step and writes it back at its end, so
that a step run twice from the same start (a CUDA graph's warm-up and then
its replay) leaves the same state.

Only bf16 or float32 weights, on one device: the int8 paths and a mesh
raise (``check_supported``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from surya_tpu_torch import nn as pnn
from surya_tpu_torch.models import qwen_decoder
from surya_tpu_torch.ops import attention as att
from surya_tpu_torch.ops import decode_attn, flash, moe

MODEL_TYPE = "lfm2_moe"


@dataclass(frozen=True)
class Lfm2Config:
    """The language model's settings as its config.json names them."""

    vocab_size: int = 65536
    hidden_size: int = 2048
    intermediate_size: int = 7168
    moe_intermediate_size: int = 1792
    num_hidden_layers: int = 24
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    layer_types: Tuple[str, ...] = (
        "conv", "conv", "full_attention", "conv", "conv", "conv", "full_attention", "conv", "conv", "conv",
        "full_attention", "conv", "conv", "conv", "full_attention", "conv", "conv", "conv", "full_attention",
        "conv", "conv", "full_attention", "conv", "conv")
    num_dense_layers: int = 2
    num_experts: int = 32
    num_experts_per_tok: int = 4
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    use_expert_bias: bool = True
    conv_L_cache: int = 3
    conv_bias: bool = False
    rope_theta: float = 1000000.0
    norm_eps: float = 1e-5
    model_type: str = MODEL_TYPE

    def __post_init__(self):
        if len(self.layer_types) != self.num_hidden_layers or set(self.layer_types) - {"conv", "full_attention"}:
            raise ValueError(f"layer_types {self.layer_types} do not give {self.num_hidden_layers} conv or "
                             "full_attention layers")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def attention_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types) if t == "full_attention")

    @property
    def conv_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types) if t == "conv")

    @property
    def cache_layers(self) -> int:
        """Layers with KV in the slot cache: the attention layers."""
        return len(self.attention_layers)


def check_supported(quantize_cache: bool = False, quantize_weights: bool = False, mesh=None) -> None:
    """Raise for what this decoder does not run: an int8 KV cache or int8
    weights (RECOGNITION_MODEL_QUANTIZE, RECOGNITION_WEIGHT_QUANTIZE), a mesh."""
    if quantize_cache or quantize_weights:
        raise ValueError("the lfm2_moe decoder runs in bf16 or float32 only: unset RECOGNITION_MODEL_QUANTIZE "
                         "and RECOGNITION_WEIGHT_QUANTIZE")
    if mesh is not None:
        raise ValueError("the lfm2_moe decoder runs on one device: it has no mesh (unset USE_MESH, give no mesh=)")


class _ShortConv(nn.Module):
    def __init__(self, c: Lfm2Config):
        super().__init__()
        h = c.hidden_size
        self.in_proj = nn.Linear(h, 3 * h, bias=c.conv_bias)
        self.conv = nn.Conv1d(h, h, c.conv_L_cache, groups=h, bias=c.conv_bias)
        self.out_proj = nn.Linear(h, h, bias=c.conv_bias)


class _Attention(nn.Module):
    def __init__(self, c: Lfm2Config):
        super().__init__()
        h, hd = c.hidden_size, c.head_dim
        self.q_proj = nn.Linear(h, c.num_attention_heads * hd, bias=False)
        self.k_proj = nn.Linear(h, c.num_key_value_heads * hd, bias=False)
        self.v_proj = nn.Linear(h, c.num_key_value_heads * hd, bias=False)
        self.out_proj = nn.Linear(c.num_attention_heads * hd, h, bias=False)
        self.q_layernorm = pnn.RMSNorm(hd, c.norm_eps)
        self.k_layernorm = pnn.RMSNorm(hd, c.norm_eps)


class _DenseMLP(nn.Module):
    def __init__(self, h: int, inter: int):
        super().__init__()
        self.w1 = nn.Linear(h, inter, bias=False)
        self.w3 = nn.Linear(h, inter, bias=False)
        self.w2 = nn.Linear(inter, h, bias=False)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class _Experts(nn.Module):
    """Every expert's weights stacked: w13 [E, 2I, H] (expert e's w1 rows,
    then its w3 rows), w2 [E, H, I]."""

    def __init__(self, c: Lfm2Config):
        super().__init__()
        e, h, i = c.num_experts, c.hidden_size, c.moe_intermediate_size
        self.w13 = nn.Parameter(torch.empty(e, 2 * i, h))
        self.w2 = nn.Parameter(torch.empty(e, h, i))


class _SparseMoE(nn.Module):
    def __init__(self, c: Lfm2Config):
        super().__init__()
        self.gate = nn.Linear(c.hidden_size, c.num_experts, bias=False)
        self.experts = _Experts(c)
        self.register_buffer("expert_bias", torch.zeros(c.num_experts))


class _Layer(nn.Module):
    def __init__(self, c: Lfm2Config, index: int):
        super().__init__()
        self.is_attention = c.layer_types[index] == "full_attention"
        self.operator_norm = pnn.RMSNorm(c.hidden_size, c.norm_eps)
        self.ffn_norm = pnn.RMSNorm(c.hidden_size, c.norm_eps)
        if self.is_attention:
            self.self_attn = _Attention(c)
        else:
            self.conv = _ShortConv(c)
        self.is_sparse = index >= c.num_dense_layers
        self.feed_forward = _SparseMoE(c) if self.is_sparse else _DenseMLP(c.hidden_size, c.intermediate_size)


class Lfm2Decoder(nn.Module):
    """Submodule names follow the checkpoint's (``model.layers.{i}...`` as
    ``decoder.layers.{i}...``; ``stack_experts`` turns its per-expert
    tensors into this module's stacked ones)."""

    def __init__(self, config: Lfm2Config):
        super().__init__()
        self.config = config
        self.layers = nn.ModuleList(_Layer(config, i) for i in range(config.num_hidden_layers))
        self.embedding_norm = pnn.RMSNorm(config.hidden_size, config.norm_eps)
        # token-expert rows, experts hit and largest expert's rows of every
        # sparse layer call since the caller last read them (ops/moe.py)
        self.register_buffer("moe_counts", torch.zeros(3, dtype=torch.int64), persistent=False)

    def init_extra_(self, generator: torch.Generator, std: float = 0.02) -> None:
        """Random init of what pnn.init_normal_ does not reach: the experts
        and the convolution taps ~ N(0, std^2), the expert bias and the
        counters 0."""
        with torch.no_grad():
            for layer in self.layers:
                if layer.is_sparse:
                    for p in (layer.feed_forward.experts.w13, layer.feed_forward.experts.w2):
                        p.normal_(0.0, std, generator=generator)
                    layer.feed_forward.expert_bias.zero_()
                if not layer.is_attention:
                    layer.conv.conv.weight.normal_(0.0, std, generator=generator)
            self.moe_counts.zero_()

    # -- pieces ----------------------------------------------------------------

    def _qkv(self, attn: _Attention, x):
        B, S, _ = x.shape
        c = self.config
        q = attn.q_layernorm(attn.q_proj(x).view(B, S, c.num_attention_heads, c.head_dim))
        k = attn.k_layernorm(attn.k_proj(x).view(B, S, c.num_key_value_heads, c.head_dim))
        v = attn.v_proj(x).view(B, S, c.num_key_value_heads, c.head_dim)
        return q, k, v

    def _feed_forward(self, layer: _Layer, x, valid, use_kernels: bool):
        y = layer.ffn_norm(x)
        ff = layer.feed_forward
        if not layer.is_sparse:
            return x + ff(y)
        c = self.config
        shape = y.shape
        out = moe.sparse_moe(y.reshape(-1, shape[-1]), ff.gate.weight, ff.expert_bias, ff.experts.w13,
                             ff.experts.w2, c.num_experts_per_tok, c.norm_topk_prob, c.routed_scaling_factor,
                             valid=None if valid is None else valid.reshape(-1), counts=self.moe_counts,
                             use_kernels=use_kernels)
        return x + out.view(shape)

    # -- prefill and decode ------------------------------------------------------

    def prefill(self, embeds, seq_lens, use_kernels: bool = True):
        """Full-sequence causal forward over right-padded rows.
        embeds: [B, L, hidden]; seq_lens: [B] valid lengths. Returns (new_k,
        new_v [attention layers, B, L, kvh, hd], conv_tail [conv layers, B,
        conv_L_cache - 1, hidden]: the B * x columns at each row's last valid
        positions (zeros before position 0), last_hidden [B, hidden])."""
        B, L, H = embeds.shape
        c = self.config
        dev = embeds.device
        cos, sin = qwen_decoder.rope_tables(c, torch.arange(L, device=dev))
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
        attend = flash.causal_flash_attention if use_kernels else flash.causal_flash_attention_reference
        valid = torch.arange(L, device=dev)[None, :] < seq_lens[:, None]
        # the tail's positions of each row: seq_len - (taps - 1) .. seq_len - 1
        taps = c.conv_L_cache
        tail = seq_lens.long()[:, None] - (taps - 1) + torch.arange(taps - 1, device=dev)[None, :]
        x = embeds
        ks, vs, tails = [], [], []
        for layer in self.layers:
            h = layer.operator_norm(x)
            if layer.is_attention:
                q, k, v = self._qkv(layer.self_attn, h)
                q, k = att.apply_rope(q, k, cos, sin)
                ks.append(k)
                vs.append(v)
                x = x + layer.self_attn.out_proj(attend(q, k, v).reshape(B, L, -1))
            else:
                conv = layer.conv
                b, cg, xv = conv.in_proj(h).chunk(3, dim=-1)
                bx = b * xv  # [B, L, H]
                x = x + conv.out_proj(cg * causal_conv(bx, conv.conv))
                picked = bx.gather(1, tail.clamp(min=0)[..., None].expand(B, taps - 1, H))
                tails.append(torch.where((tail >= 0)[..., None], picked, 0.0))
            x = self._feed_forward(layer, x, valid, use_kernels)
        x = self.embedding_norm(x)
        last = x[torch.arange(B, device=dev), seq_lens.long() - 1]
        return torch.stack(ks), torch.stack(vs), torch.stack(tails), last

    def decode_step_chunked(self, cache: dict, chunk_k, chunk_v, embeds, step: int, base_len, conv_state,
                            use_kernels: bool = True):
        """One decode token with the KV cache read-only (qwen_decoder.Decoder.
        decode_step_chunked's contract for the attention layers, by attention
        layer) and conv_state [conv layers, B, conv_L_cache - 1, hidden] (the
        chunk's own: see the module docstring) rolled in place. Returns
        hidden [B, hidden]."""
        B = embeds.shape[0]
        c = self.config
        cos, sin = qwen_decoder.rope_tables(c, (base_len + step).float()[:, None])
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        attend = decode_attn.gqa_decode if use_kernels else decode_attn.gqa_decode_reference
        x = embeds[:, None, :]
        ai = ci = 0
        for layer in self.layers:
            h = layer.operator_norm(x)
            if layer.is_attention:
                q, k, v = self._qkv(layer.self_attn, h)
                q, k = att.apply_rope(q, k, cos, sin)
                chunk_k[ai, :, :, step] = k[:, 0]
                chunk_v[ai, :, :, step] = v[:, 0]
                out = attend(q[:, 0], cache["k"], cache["v"], base_len, chunk_k, chunk_v, step, ai)
                x = x + layer.self_attn.out_proj(out.reshape(B, 1, -1))
                ai += 1
            else:
                conv = layer.conv
                b, cg, xv = conv.in_proj(h[:, 0]).chunk(3, dim=-1)
                window = torch.cat([conv_state[ci], (b * xv)[:, None]], dim=1)  # [B, taps, H]
                conv_state[ci].copy_(window[:, 1:])
                x = x + conv.out_proj(cg * causal_conv(window, conv.conv)[:, -1])[:, None]
                ci += 1
            x = self._feed_forward(layer, x, None, use_kernels)
        return self.embedding_norm(x)[:, 0]


def causal_conv(bx, conv: nn.Conv1d):
    """The depthwise causal convolution of bx [B, L, H] over its positions
    (taps - 1 zeros before position 0), in fp32: out[t] = sum_j w[:, j]
    bx[t - (taps - 1) + j] (+ bias). Returns [B, L, H] in bx's dtype."""
    w = conv.weight[:, 0].float()  # [H, taps]
    taps, L = w.shape[1], bx.shape[1]
    padded = F.pad(bx.float(), (0, 0, taps - 1, 0))
    out = sum(padded[:, j : j + L] * w[:, j] for j in range(taps))
    if conv.bias is not None:
        out = out + conv.bias.float()
    return out.to(bx.dtype)


# -- the slot cache ---------------------------------------------------------------

def init_cache(config: Lfm2Config, n_slots: int, max_seq: int, dtype, device, quantize: bool = False,
               mesh=None) -> dict:
    """Slot cache {"k", "v": [attention layers, slots, kvh, max_seq, hd],
    "conv": [conv layers, slots, conv_L_cache - 1, hidden], "len": [slots]
    int32}."""
    check_supported(quantize_cache=quantize, mesh=mesh)
    shape = (config.cache_layers, n_slots, config.num_key_value_heads, max_seq, config.head_dim)
    return {
        "len": torch.zeros((n_slots,), dtype=torch.int32, device=device),
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "conv": torch.zeros((len(config.conv_layers), n_slots, config.conv_L_cache - 1, config.hidden_size),
                            dtype=dtype, device=device),
    }


def merge_prefill(cache: dict, new_k, new_v, conv_tail, seq_lens, slot_idx) -> dict:
    """qwen_decoder.merge_prefill for the KV and lengths, and each row's conv
    tail [conv layers, B, taps - 1, hidden] into its slot (in place),
    overwriting the slot's state: a reused slot keeps nothing of its last
    line. Padding rows all target the trash slot, which nothing reads."""
    qwen_decoder.merge_prefill(cache, new_k, new_v, seq_lens, slot_idx)
    cache["conv"][:, slot_idx.long()] = conv_tail.to(cache["conv"].dtype)
    return cache


def stack_experts(tensors: dict, config: Lfm2Config, prefix: str = "decoder") -> dict:
    """The per-expert tensors of a checkpoint (``{prefix}.layers.{i}.
    feed_forward.experts.{e}.w1/w2/w3.weight``) as this module's stacked
    ones (``...experts.w13`` and ``...experts.w2``), in place: `tensors`
    loses each layer's per-expert entries as it gains the stacked ones, so
    that it holds one layer's twice at most. Returns `tensors`."""
    out = tensors
    for i in range(config.num_hidden_layers):
        if i < config.num_dense_layers:
            continue
        b = f"{prefix}.layers.{i}.feed_forward.experts"
        names = [(f"{b}.{e}.w1.weight", f"{b}.{e}.w3.weight", f"{b}.{e}.w2.weight") for e in range(config.num_experts)]
        if names[0][0] not in out:
            continue
        out[f"{b}.w13"] = torch.stack([torch.cat([out.pop(w1), out.pop(w3)]) for w1, w3, _ in names])
        out[f"{b}.w2"] = torch.stack([out.pop(w2) for _, _, w2 in names])
    return out


# -- checkpoint conversion ----------------------------------------------------

def convert_torch(bag, config: Lfm2Config, prefix: str = "decoder") -> dict:
    """The checkpoint's decoder tensors (transformers' Lfm2Moe names under
    `prefix`: ``{prefix}.layers.{i}.operator_norm``, ``.conv.in_proj``,
    ``.self_attn.q_proj``, ``.feed_forward.experts.{e}.w1``, ...,
    ``{prefix}.embedding_norm``) as the pytree nn.load_jax_params takes
    (numpy leaves, JAX layout: linear kernels [in, out]; the convolution's
    taps, the stacked experts and the expert bias under their own names, as
    the module holds them)."""
    layers = []
    for i, kind in enumerate(config.layer_types):
        b = f"{prefix}.layers.{i}"
        layer = {"operator_norm": bag.rmsnorm(f"{b}.operator_norm"), "ffn_norm": bag.rmsnorm(f"{b}.ffn_norm")}
        if kind == "full_attention":
            layer["self_attn"] = {
                **{name: bag.linear(f"{b}.self_attn.{name}", bias=False)
                   for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
                "q_layernorm": bag.rmsnorm(f"{b}.self_attn.q_layernorm"),
                "k_layernorm": bag.rmsnorm(f"{b}.self_attn.k_layernorm"),
            }
        else:
            conv = {"weight": bag.raw(f"{b}.conv.conv.weight")}
            if config.conv_bias:
                conv["bias"] = bag.raw(f"{b}.conv.conv.bias")
            layer["conv"] = {"in_proj": bag.linear(f"{b}.conv.in_proj", bias=config.conv_bias),
                             "conv": conv,
                             "out_proj": bag.linear(f"{b}.conv.out_proj", bias=config.conv_bias)}
        f = f"{b}.feed_forward"
        if i < config.num_dense_layers:
            layer["feed_forward"] = {name: bag.linear(f"{f}.{name}", bias=False) for name in ("w1", "w2", "w3")}
        else:
            experts = range(config.num_experts)
            layer["feed_forward"] = {
                "gate": bag.linear(f"{f}.gate", bias=False),
                "expert_bias": (bag.raw(f"{f}.expert_bias") if f"{f}.expert_bias" in bag.tensors
                                else np.zeros((config.num_experts,), np.float32)),
                "experts": {
                    "w13": np.stack([np.concatenate([bag.raw(f"{f}.experts.{e}.w1.weight"),
                                                     bag.raw(f"{f}.experts.{e}.w3.weight")]) for e in experts]),
                    "w2": np.stack([bag.raw(f"{f}.experts.{e}.w2.weight") for e in experts]),
                },
            }
        layers.append(layer)
    return {"layers": layers, "embedding_norm": bag.rmsnorm(f"{prefix}.embedding_norm"),
            "moe_counts": np.zeros((3,), np.int64)}
