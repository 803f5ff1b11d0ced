"""Attention primitives (PyTorch counterpart of surya_tpu/ops/attention.py).

Softmax and the RoPE rotation run in fp32 whatever the input dtype.
Layout convention: q/k/v are [B, S, H, D].
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def sdpa(q, k, v, mask: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None):
    """Dense attention, fp32 logits and softmax. q: [B, Sq, H, D], k/v:
    [B, Sk, kvh, D]; query head h reads kv head h // (H / kvh) without
    repeating kv per query head. mask: bool, True = attend, broadcastable
    to [B, kvh, H / kvh, Sq, Sk]. bias: additive, taken in fp32 (as the JAX
    package's sdpa takes its masks), [B or 1, H or 1, Sq, Sk]. Returns
    [B, Sq, H, D] in q's dtype."""
    B, Sq, H, D = q.shape
    kvh = k.shape[2]
    qg = q.float().reshape(B, Sq, kvh, H // kvh, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * D**-0.5
    if bias is not None:
        bias = bias.float()
        if bias.shape[1] == H:
            logits = logits + bias.reshape(bias.shape[0], kvh, H // kvh, *bias.shape[2:])
        else:
            logits = logits + bias[:, :, None]
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q, k, cos, sin):
    """Rotary embedding with the rotation in fp32; cos/sin broadcast to q/k."""
    qf, kf = q.float(), k.float()
    cos, sin = cos.float(), sin.float()
    q_out = qf * cos + rotate_half(qf) * sin
    k_out = kf * cos + rotate_half(kf) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)


def rope_freqs(positions, head_dim: int, theta: float):
    """1-D RoPE angle table: positions [...] -> [..., head_dim // 2]."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim)
    )
    return positions.float()[..., None] * inv_freq
