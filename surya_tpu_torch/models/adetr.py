"""ADETR decoder trunk: the autoregressive box decoder shared by layout and
table recognition, in PyTorch.

Counterpart of surya_tpu/models/adetr.py. Per layer: cross-attention over
the encoder output (its K/V computed once a batch, ``precompute_cross_kv``),
causal self-attention with RoPE over the box sequence, and a gated MLP with
the tanh GELU (JAX's default), with the "double residual flow" option (the
self-attention branch adds the raw layer input, not the cross-attention
output). The self-attention cache is [layers, B, S, kvh, hd]; ``prefill``
and ``step`` write it in place. Submodules carry the names of the JAX
parameter pytree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from surya_tpu_torch import nn as pnn
from surya_tpu_torch.ops import attention as att


@dataclass(frozen=True)
class ADETRConfig:
    num_hidden_layers: int = 8
    hidden_size: int = 1024
    intermediate_size: int = 4096
    encoder_hidden_size: int = 1024
    num_attention_heads: int = 16
    num_key_value_heads: int = 4
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    attention_bias: bool = False
    double_residual_flow: bool = True
    cross_attn_layers: Tuple[int, ...] = (0, 1, 2, 3, 4, 5, 6, 7)
    self_attn_layers: Tuple[int, ...] = (0, 1, 2, 3, 4, 5, 6, 7)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


class _Attention(nn.Module):
    def __init__(self, config: ADETRConfig, kv_in: int):
        super().__init__()
        h, hd, b = config.hidden_size, config.head_dim, config.attention_bias
        self.q_proj = nn.Linear(h, config.num_attention_heads * hd, bias=b)
        self.k_proj = nn.Linear(kv_in, config.num_key_value_heads * hd, bias=b)
        self.v_proj = nn.Linear(kv_in, config.num_key_value_heads * hd, bias=b)
        self.o_proj = nn.Linear(config.num_attention_heads * hd, h)


class _GatedMLP(nn.Module):
    def __init__(self, h: int, inter: int):
        super().__init__()
        self.gate_proj = nn.Linear(h, inter, bias=False)
        self.up_proj = nn.Linear(h, inter, bias=False)
        self.down_proj = nn.Linear(inter, h, bias=False)

    def forward(self, x):
        # jax.nn.gelu defaults to the tanh form
        return self.down_proj(F.gelu(self.gate_proj(x), approximate="tanh") * self.up_proj(x))


class _Layer(nn.Module):
    def __init__(self, config: ADETRConfig, li: int):
        super().__init__()
        h, eps = config.hidden_size, config.rms_norm_eps
        self.cross_pre_norm = pnn.GemmaRMSNorm(h, eps)
        self.temporal_pre_norm = pnn.GemmaRMSNorm(h, eps)
        self.channel_pre_norm = pnn.GemmaRMSNorm(h, eps)
        self.mlp_block = _GatedMLP(h, config.intermediate_size)
        self.cross_attn_block = _Attention(config, config.encoder_hidden_size) if li in config.cross_attn_layers \
            else None
        self.temporal_block = _Attention(config, h) if li in config.self_attn_layers else None


class ADETRDecoder(nn.Module):
    """Submodule names follow surya_tpu adetr.init_params' pytree."""

    def __init__(self, config: ADETRConfig):
        super().__init__()
        self.config = config
        self.layers = nn.ModuleList(_Layer(config, li) for li in range(config.num_hidden_layers))
        self.final_norm = pnn.GemmaRMSNorm(config.hidden_size, config.rms_norm_eps)

    def init_cache(self, batch: int, max_boxes: int, dtype, device) -> dict:
        c = self.config
        shape = (c.num_hidden_layers, batch, max_boxes, c.num_key_value_heads, c.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}

    def precompute_cross_kv(self, encoder_hidden):
        """Cross-attention K/V of every layer, [layers, B, L, kvh, hd] each;
        zeros for a layer without a cross block."""
        c = self.config
        B, L, _ = encoder_hidden.shape
        ks, vs = [], []
        for layer in self.layers:
            blk = layer.cross_attn_block
            if blk is None:
                zeros = encoder_hidden.new_zeros((B, L, c.num_key_value_heads, c.head_dim))
                ks.append(zeros)
                vs.append(zeros)
                continue
            ks.append(blk.k_proj(encoder_hidden).view(B, L, c.num_key_value_heads, c.head_dim))
            vs.append(blk.v_proj(encoder_hidden).view(B, L, c.num_key_value_heads, c.head_dim))
        return torch.stack(ks), torch.stack(vs)

    def rope(self, positions):
        """positions [...] -> cos/sin [..., head_dim], fp32."""
        freqs = att.rope_freqs(positions.float(), self.config.head_dim, self.config.rope_theta)
        ang = torch.cat([freqs, freqs], dim=-1)
        return ang.cos(), ang.sin()

    def _layer(self, layer: _Layer, cross_k, cross_v, x, self_attend):
        """One layer; self_attend(normed) -> the self-attention output."""
        c = self.config
        raw = x
        blk = layer.cross_attn_block
        if blk is not None:
            h = layer.cross_pre_norm(x)
            B, Q, _ = h.shape
            q = blk.q_proj(h).view(B, Q, c.num_attention_heads, c.head_dim)
            cross_res = blk.o_proj(att.sdpa(q, cross_k, cross_v).reshape(B, Q, -1)) + raw
        else:
            cross_res = raw
        if layer.temporal_block is None:
            residual = cross_res
        elif c.double_residual_flow:
            residual = self_attend(layer.temporal_pre_norm(cross_res)) + raw
        else:
            residual = self_attend(layer.temporal_pre_norm(cross_res)) + cross_res
        return layer.mlp_block(layer.channel_pre_norm(residual)) + residual

    def _qkv(self, blk: _Attention, h, cos, sin):
        c = self.config
        B, S, _ = h.shape
        q = blk.q_proj(h).view(B, S, c.num_attention_heads, c.head_dim)
        k = blk.k_proj(h).view(B, S, c.num_key_value_heads, c.head_dim)
        v = blk.v_proj(h).view(B, S, c.num_key_value_heads, c.head_dim)
        q, k = att.apply_rope(q, k, cos, sin)
        return q, k, v

    def prefill(self, cache: dict, cross_k, cross_v, embeds, seq_lens):
        """Causal pass over a right-padded prompt, writing cache rows [0, L)
        in place. embeds [B, L, h]; seq_lens [B]. Returns the final-norm
        hidden state at each row's last prompt token, [B, h]."""
        B, L, _ = embeds.shape
        dev = embeds.device
        cos, sin = self.rope(torch.arange(L, device=dev)[None, :])
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        causal = torch.ones((L, L), dtype=torch.bool, device=dev).tril()
        x = embeds
        for li, layer in enumerate(self.layers):

            def self_attend(h, li=li, blk=layer.temporal_block):
                q, k, v = self._qkv(blk, h, cos, sin)
                cache["k"][li, :, :L] = k
                cache["v"][li, :, :L] = v
                return blk.o_proj(att.sdpa(q, k, v, mask=causal).reshape(B, L, -1))

            x = self._layer(layer, cross_k[li], cross_v[li], x, self_attend)
        x = self.final_norm(x)
        return x[torch.arange(B, device=dev), seq_lens.long() - 1]

    def step(self, cache: dict, cross_k, cross_v, embed, pos, write_idx=None,
             seq_lens: Optional[torch.Tensor] = None, prompt_len: int = 0):
        """One AR step, writing the cache in place. embed [B, h]; pos [B] the
        RoPE position; write_idx [B] the cache row (default pos). They differ
        when the prompt was right-padded: generated tokens then write at rows
        >= prompt_len while their position continues from seq_len, and the
        rows in [seq_len, prompt_len) are masked. Returns hidden [B, h]."""
        B = embed.shape[0]
        S = cache["k"].shape[2]
        dev = embed.device
        if write_idx is None:
            write_idx = pos
        cos, sin = self.rope(pos[:, None])
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        write_at = torch.clamp(write_idx, max=S - 1).long()
        key_rows = torch.arange(S, device=dev)[None, :]
        key_ok = key_rows <= write_at[:, None]
        if seq_lens is not None and prompt_len > 0:
            key_ok &= ~((key_rows >= seq_lens[:, None]) & (key_rows < prompt_len))
        mask = key_ok[:, None, None, None, :]
        rows = torch.arange(B, device=dev)
        x = embed[:, None, :]
        for li, layer in enumerate(self.layers):

            def self_attend(h, li=li, blk=layer.temporal_block):
                q, k, v = self._qkv(blk, h, cos, sin)
                cache["k"][li, rows, write_at] = k[:, 0]
                cache["v"][li, rows, write_at] = v[:, 0]
                out = att.sdpa(q, cache["k"][li], cache["v"][li], mask=mask)
                return blk.o_proj(out.reshape(B, 1, -1))

            x = self._layer(layer, cross_k[li], cross_v[li], x, self_attend)
        return self.final_norm(x)[:, 0]


class DoneWatch:
    """When to end an AR box loop, without a host sync every step.

    The JAX package runs the loop as a device ``while_loop`` that stops once
    every row is done. Eagerly, asking the device that each step would sync
    the host with it every step. A row records nothing once it is done (done
    is sticky), so steps run past the point where every row is done leave
    the outputs unchanged: ``poll`` posts all(done) every ``every`` steps, a
    non-blocking copy into pinned memory behind an event, and reads the flag
    posted at the check before, whose event the device has usually passed.
    The loop then ends at most 2 * every - 1 steps late, with the same
    outputs. On the CPU the flag is read at once. ``steps`` counts the polls,
    one per recorded step, and ``syncs`` the event waits."""

    every = 8

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.pending = None
        self.steps = 0
        self.syncs = 0

    def poll(self, done) -> bool:
        """Call after each recorded step with the rows' done flags; True: stop."""
        self.steps += 1
        if self.steps % self.every:
            return False
        if self.pending is not None:
            flag, event = self.pending
            if event is not None:
                event.synchronize()
                self.syncs += 1
            if bool(flag):
                return True
        if self.cuda:
            flag = torch.empty((), dtype=torch.bool, pin_memory=True)
            flag.copy_(done.all(), non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            self.pending = (flag, event)
        else:
            self.pending = (done.all(), None)
        return False


# -- checkpoint conversion ----------------------------------------------------

def convert_torch(bag, config: ADETRConfig, prefix: str) -> dict:
    """The upstream torch ADETR decoder's tensors as surya_tpu adetr's pytree
    (numpy leaves, JAX layout; surya_tpu adetr.convert_torch)."""
    pre = f"{prefix}." if prefix else ""
    layers = []
    for li in range(config.num_hidden_layers):
        b = f"{pre}layers.{li}"
        layer = {
            "cross_pre_norm": {"scale": bag.raw(f"{b}.cross_pre_norm.weight")},
            "temporal_pre_norm": {"scale": bag.raw(f"{b}.temporal_pre_norm.weight")},
            "channel_pre_norm": {"scale": bag.raw(f"{b}.channel_pre_norm.weight")},
            "mlp_block": {
                "gate_proj": bag.linear(f"{b}.mlp_block.gate_proj", bias=False),
                "up_proj": bag.linear(f"{b}.mlp_block.up_proj", bias=False),
                "down_proj": bag.linear(f"{b}.mlp_block.down_proj", bias=False),
            },
        }
        if li in config.cross_attn_layers:
            layer["cross_attn_block"] = {
                "q_proj": bag.linear(f"{b}.cross_attn_block.q_proj"),
                "k_proj": bag.linear(f"{b}.cross_attn_block.k_proj"),
                "v_proj": bag.linear(f"{b}.cross_attn_block.v_proj"),
                "o_proj": bag.linear(f"{b}.cross_attn_block.o_proj"),
            }
        if li in config.self_attn_layers:
            layer["temporal_block"] = {
                "q_proj": bag.linear(f"{b}.temporal_block.q_proj"),
                "k_proj": bag.linear(f"{b}.temporal_block.k_proj"),
                "v_proj": bag.linear(f"{b}.temporal_block.v_proj"),
                "o_proj": bag.linear(f"{b}.temporal_block.o_proj"),
            }
        layers.append(layer)
    return {"layers": layers, "final_norm": {"scale": bag.raw(f"{pre}final_norm.weight")}}
