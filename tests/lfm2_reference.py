"""Plain float32 reference of LFM2-MoE's language model (transformers'
Lfm2Moe, as LiquidAI/LFM2-8B-A1B's config.json sets it), for the tests of
surya_tpu_torch's lfm2_moe decoder. It imports neither JAX nor the port.

One causal pass over a whole sequence, with no kernel, cache or batching:
each layer is ``operator_norm``, then a gated short convolution (``B, C, x
= in_proj(h)``, ``out_proj(C * conv(B * x))``, conv a causal depthwise
convolution of ``conv_L_cache`` taps) or GQA attention (q and k RMS-normed
per head, RoPE, causal softmax, ``out_proj``), added to the residual; then
``ffn_norm`` and a dense SwiGLU (the first ``num_dense_layers``) or the
sparse experts (sigmoid router scores, the top-k of the scores plus
``expert_bias`` chosen, their scores normalised and scaled, each chosen
expert's SwiGLU weighted), added too; ``embedding_norm`` at the end.
Products run in float32 with TF32 off.

Departures from the published description: the router's normalisation adds
1e-6 to the sum of the chosen scores (transformers' value, not given in the
config); the tensors are named by their checkpoint names under ``decoder.``
in place of ``model.``; the token embedding and the head are the caller's.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

NORM_EPS = 1e-6


@contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def param_shapes(d: dict, prefix: str = "decoder") -> Dict[str, Tuple[int, ...]]:
    """Every decoder tensor at the widths of `d` (config.json's keys), by its
    checkpoint name."""
    h, hd = d["hidden_size"], d["hidden_size"] // d["num_attention_heads"]
    kv = d["num_key_value_heads"] * hd
    e, i_moe, taps = d["num_experts"], d["moe_intermediate_size"], d["conv_L_cache"]
    shapes = {}
    for i, kind in enumerate(d["layer_types"]):
        b = f"{prefix}.layers.{i}."
        shapes.update({b + "operator_norm.weight": (h,), b + "ffn_norm.weight": (h,)})
        if kind == "full_attention":
            shapes.update({b + "self_attn.q_proj.weight": (h, h), b + "self_attn.k_proj.weight": (kv, h),
                           b + "self_attn.v_proj.weight": (kv, h), b + "self_attn.out_proj.weight": (h, h),
                           b + "self_attn.q_layernorm.weight": (hd,), b + "self_attn.k_layernorm.weight": (hd,)})
        else:
            shapes.update({b + "conv.in_proj.weight": (3 * h, h), b + "conv.conv.weight": (h, 1, taps),
                           b + "conv.out_proj.weight": (h, h)})
        f = b + "feed_forward."
        if i < d["num_dense_layers"]:
            inter = d["intermediate_size"]
            shapes.update({f + "w1.weight": (inter, h), f + "w3.weight": (inter, h), f + "w2.weight": (h, inter)})
        else:
            shapes.update({f + "gate.weight": (e, h), f + "expert_bias": (e,)})
            for x in range(e):
                shapes.update({f"{f}experts.{x}.w1.weight": (i_moe, h), f"{f}experts.{x}.w3.weight": (i_moe, h),
                               f"{f}experts.{x}.w2.weight": (h, i_moe)})
    shapes[f"{prefix}.embedding_norm.weight"] = (h,)
    return shapes


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def swiglu(x, w1, w3, w2):
    return (F.silu(x @ w1.T) * (x @ w3.T)) @ w2.T


def route(x, gate, bias, d: dict):
    """x [S, H] -> (chosen [S, k], weights [S, k], biased scores [S, E])."""
    scores = torch.sigmoid(x @ gate.T)
    biased = scores + bias if d.get("use_expert_bias", True) else scores
    chosen = torch.topk(biased, d["num_experts_per_tok"], dim=-1).indices
    weights = scores.gather(1, chosen)
    if d.get("norm_topk_prob", True):
        weights = weights / (weights.sum(-1, keepdim=True) + NORM_EPS)
    return chosen, weights * d.get("routed_scaling_factor", 1.0), biased


def sparse_experts(W, f: str, x, d: dict):
    """The sparse feed-forward of the layer whose tensors start with f."""
    chosen, weights, _ = route(x, W[f + "gate.weight"], W[f + "expert_bias"], d)
    out = torch.zeros_like(x)
    for s in range(x.shape[0]):
        for j in range(chosen.shape[1]):
            e = int(chosen[s, j])
            out[s] += weights[s, j] * swiglu(x[s], W[f"{f}experts.{e}.w1.weight"], W[f"{f}experts.{e}.w3.weight"],
                                             W[f"{f}experts.{e}.w2.weight"])
    return out


def forward(W, d: dict, x, prefix: str = "decoder"):
    """x [S, H] (the embedded sequence) -> the final-normed hidden states [S, H]."""
    with no_tf32():
        x = x.float()
        S, h = x.shape
        H, KVH, eps = d["num_attention_heads"], d["num_key_value_heads"], d["norm_eps"]
        D = h // H
        inv = 1.0 / d["rope_theta"] ** (torch.arange(0, D, 2, dtype=torch.float32) / D)
        ang = torch.arange(S, dtype=torch.float32)[:, None] * inv
        ang = torch.cat([ang, ang], -1).to(x.device)
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        taps = d["conv_L_cache"]
        for i, kind in enumerate(d["layer_types"]):
            b = f"{prefix}.layers.{i}."
            y = rms_norm(x, W[b + "operator_norm.weight"], eps)
            if kind == "full_attention":
                a = b + "self_attn."
                q = rms_norm((y @ W[a + "q_proj.weight"].T).view(S, H, D), W[a + "q_layernorm.weight"], eps)
                k = rms_norm((y @ W[a + "k_proj.weight"].T).view(S, KVH, D), W[a + "k_layernorm.weight"], eps)
                v = (y @ W[a + "v_proj.weight"].T).view(S, KVH, D)
                q, k = (t * ang.cos()[:, None] + rotate_half(t) * ang.sin()[:, None] for t in (q, k))
                rep = H // KVH
                k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
                logits = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(D)
                probs = torch.softmax(logits.masked_fill(~causal, float("-inf")), -1)
                out = torch.einsum("hqk,khd->qhd", probs, v).reshape(S, h)
                x = x + out @ W[a + "out_proj.weight"].T
            else:
                c = b + "conv."
                bb, cc, xx = (y @ W[c + "in_proj.weight"].T).chunk(3, dim=-1)
                bx = bb * xx
                w = W[c + "conv.weight"][:, 0]  # [H, taps]
                mixed = torch.zeros_like(bx)
                for t in range(S):
                    for j in range(taps):
                        src = t - (taps - 1) + j
                        if src >= 0:
                            mixed[t] += w[:, j] * bx[src]
                x = x + (cc * mixed) @ W[c + "out_proj.weight"].T
            f = b + "feed_forward."
            y = rms_norm(x, W[b + "ffn_norm.weight"], eps)
            if i < d["num_dense_layers"]:
                x = x + swiglu(y, W[f + "w1.weight"], W[f + "w3.weight"], W[f + "w2.weight"])
            else:
                x = x + sparse_experts(W, f, y, d)
        return rms_norm(x, W[f"{prefix}.embedding_norm.weight"], eps)
