"""Plain PyTorch reference of the recognition foundation model with
LFM2-8B-A1B's language model as its decoder (configuration
``lfm2_8b_a1b_ocr``): the OCR model's vision encoder, prompt, token embedding
and heads (reference/foundation.py) around the layers of transformers'
Lfm2Moe. It imports nothing of the program under test.

Each line is run alone, in float32 (TF32 off: the caller's ``no_tf32``),
without a cache, kernel or batching: one causal pass over the prompt and the
tokens served for it. Every weight product goes through
``precision.matmul``, so that the lower-precision control takes them in fp8.

The decoder (as tests/lfm2_reference.py): each layer is ``operator_norm``,
then a gated short convolution (``B, C, x = in_proj(h)``, ``out_proj(C *
conv(B * x))``, conv a causal depthwise convolution of ``conv_L_cache``
taps) or GQA attention (q and k RMS-normed per head, RoPE, causal softmax,
``out_proj``), added to the residual; then ``ffn_norm`` and a dense SwiGLU
(the first ``num_dense_layers``) or the sparse experts: sigmoid router
scores, the top-k of the scores plus ``expert_bias`` chosen, their scores
normalised (``norm_topk_prob``, 1e-6 added to the sum: transformers' value,
not in the config) and scaled, each chosen expert's SwiGLU weighted, added;
``embedding_norm`` after the last layer.

Departures from the published model: the tensors are named by the
checkpoint's names under ``decoder.`` in place of ``model.``; the language
model's own embedding and head (65,536 ids) are replaced by the OCR model's
token embedding, tied head and bias at width 2048 (65,825 ids), and its
input takes the encoder's image tokens at the prompt's <IMAGE> positions.

``logits`` also returns, at each position that chose a served token, the
smallest margin between the 4th and the 5th biased router score over the
sparse layers there: a near tie of the routing, which a rounding of the
router's input can turn over.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import foundation
from perfbench.reference.precision import matmul

NORM_EPS = 1e-6


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every tensor of the model at the widths of `cfg` (a configuration's
    "model" entry, its "decoder" the language model's config.json keys), by
    name: the foundation's encoder, embeddings and heads, then the decoder's
    tensors under their checkpoint names."""
    shapes = {k: v for k, v in foundation.param_shapes(cfg).items() if not k.startswith("decoder.")}
    d = cfg["decoder"]
    h, hd = d["hidden_size"], d["hidden_size"] // d["num_attention_heads"]
    kv = d["num_key_value_heads"] * hd
    e, i_moe, taps = d["num_experts"], d["moe_intermediate_size"], d["conv_L_cache"]
    for i, kind in enumerate(d["layer_types"]):
        b = f"decoder.layers.{i}."
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
    shapes["decoder.embedding_norm.weight"] = (h,)
    return shapes


class Float32(dict):
    """A state dict whose tensors are handed out in float32, each cast when
    it is read (so that a bf16 model of 16.7 GB is never held in float32
    whole)."""

    def __getitem__(self, name):
        return super().__getitem__(name).float()


rms_norm = foundation.rms_norm


def _swiglu(W, x, w1: str, w3: str, w2: str):
    return matmul(W, F.silu(matmul(W, x, w1)) * matmul(W, x, w3), w2)


def sparse_experts(W, f: str, x, d: dict):
    """The sparse feed-forward of the layer whose tensors start with f, over
    x [S, H]. Returns (its output [S, H], the 4th-5th biased score margin
    at each position [S])."""
    scores = torch.sigmoid(matmul(W, x, f + "gate.weight"))
    biased = scores + W[f + "expert_bias"] if d["use_expert_bias"] else scores
    k = d["num_experts_per_tok"]
    top = torch.topk(biased, k + 1, dim=-1)
    chosen = top.indices[:, :k]
    weights = scores.gather(1, chosen)
    if d["norm_topk_prob"]:
        weights = weights / (weights.sum(-1, keepdim=True) + NORM_EPS)
    weights = weights * d["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in range(d["num_experts"]):
        tok, slot = (chosen == e).nonzero(as_tuple=True)
        if tok.numel():
            w = f"{f}experts.{e}."
            y = _swiglu(W, x[tok], w + "w1.weight", w + "w3.weight", w + "w2.weight")
            out.index_add_(0, tok, y * weights[tok, slot, None])
    return out, top.values[:, k - 1] - top.values[:, k]


def decode(W, d: dict, x):
    """The decoder over x [S, H] (the embedded sequence). Returns (the
    final-normed hidden states [S, H], the smallest routing margin over the
    sparse layers at each position [S])."""
    S, h = x.shape
    H, KVH, eps, taps = d["num_attention_heads"], d["num_key_value_heads"], d["norm_eps"], d["conv_L_cache"]
    D = h // H
    dev = x.device
    inv = 1.0 / d["rope_theta"] ** (torch.arange(0, D, 2, dtype=torch.float32) / D)
    ang = torch.arange(S, dtype=torch.float32)[:, None] * inv
    ang = torch.cat([ang, ang], -1).to(dev)
    causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    margin = torch.full((S,), float("inf"), device=dev)
    for i, kind in enumerate(d["layer_types"]):
        b = f"decoder.layers.{i}."
        y = rms_norm(x, W[b + "operator_norm.weight"], eps)
        if kind == "full_attention":
            a = b + "self_attn."
            q = rms_norm(matmul(W, y, a + "q_proj.weight").view(S, H, D), W[a + "q_layernorm.weight"], eps)
            k = rms_norm(matmul(W, y, a + "k_proj.weight").view(S, KVH, D), W[a + "k_layernorm.weight"], eps)
            v = matmul(W, y, a + "v_proj.weight").view(S, KVH, D)
            q, k = (foundation.rope(t.transpose(0, 1), ang) for t in (q, k))
            out = foundation.attention(q, k, v.transpose(0, 1), causal).transpose(0, 1).reshape(S, h)
            x = x + matmul(W, out, a + "out_proj.weight")
        else:
            c = b + "conv."
            bb, cc, xx = matmul(W, y, c + "in_proj.weight").chunk(3, dim=-1)
            bx = F.pad(bb * xx, (0, 0, taps - 1, 0))  # taps - 1 zero positions before the first
            w = W[c + "conv.weight"][:, 0]  # [H, taps]
            mixed = sum(bx[j : j + S] * w[:, j] for j in range(taps))
            x = x + matmul(W, cc * mixed, c + "out_proj.weight")
        f = b + "feed_forward."
        y = rms_norm(x, W[b + "ffn_norm.weight"], eps)
        if i < d["num_dense_layers"]:
            x = x + _swiglu(W, y, f + "w1.weight", f + "w3.weight", f + "w2.weight")
        else:
            out, m = sparse_experts(W, f, y, d)
            x = x + out
            margin = torch.minimum(margin, m)
    return rms_norm(x, W["decoder.embedding_norm.weight"], eps), margin


def logits(W, cfg: dict, image_tokens: torch.Tensor, prompt: List[int], served: List[int]):
    """One causal pass over the prompt (its <IMAGE> positions taking the
    image tokens in order) and the tokens fed back after each served token
    but the last, as reference/foundation.logits feeds them. Returns (the
    logits [len(served), vocab] that chose each served token, the smallest
    routing margin at each of those positions [len(served)])."""
    t = cfg["tokens"]
    feeds = list(served[:-1])
    if feeds and feeds[0] in (t["eos"], t["pad"]):
        feeds[0] = t["pad"]
    ids = torch.tensor(prompt + feeds, device=image_tokens.device)
    x = W["token_embed.weight"][ids].float()
    img = (ids[: len(prompt)] == t["image"]).nonzero()[:, 0]
    x[img] = image_tokens[: img.numel()]
    hidden, margin = decode(W, cfg["decoder"], x)
    P = len(prompt)
    return matmul(W, hidden[P - 1:], "token_embed.weight") + W["lm_head_bias"], margin[P - 1:]

