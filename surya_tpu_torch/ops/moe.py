"""The sparse-expert feed-forward of an LFM2-MoE layer, routed and run on
the device with no synchronisation with the host.

It replaces no kernel of the JAX package: the JAX package has no sparse
layer. It was added for the recognition foundation model's LFM2-MoE decoder
(models/lfm2_decoder.py).

``sparse_moe`` runs, on any device, in static shapes whatever the routing:

1. The router: fp32 logits of the tokens, their sigmoid scores, the
   top-k of the scores plus the expert bias (the bias chooses, it does
   not weigh), the chosen scores normalised to sum to 1 (``norm_topk_prob``)
   and scaled by ``routed_scaling_factor``.
2. The token-expert rows (tokens x k of them) sorted by expert (a stable
   sort: rows of one expert keep the order of their tokens). Rows of tokens
   that are not valid (a prefill wave's padding) take the sentinel expert
   E, sort after every real row and fall outside every expert's group.
3. Gate and up projections of every expert as one grouped GEMM over the
   sorted rows (``torch._grouped_mm``, group e the rows of expert e: the
   group offsets are the running counts, on the device), SwiGLU, and the
   down projection as a second grouped GEMM. Rows past the last group are
   not computed.
4. The rows taken back to token order (the inverse permutation, a gather:
   no atomics, so the sum is the same on every run) and added up weighted,
   in fp32. A token that is not valid gets zeros.

What bounds it on an H100: in decode every step reads all the experts'
weights (128 slots x top-4 leave no expert without rows), so the bytes of
the weights over the memory bandwidth; in prefill, where each expert takes
thousands of rows, the grouped GEMMs' operations. Both GEMMs are one launch
each whatever the routing, and no step reads a device value on the host,
so a CUDA graph captures the layer.

``counts`` (an int64 tensor [3] on the device, optional) is added to in
place: the token-expert rows computed, the experts with at least one row,
and the rows of the largest expert, so that a caller reads them once after
its last synchronisation. ``sparse_moe.launches`` counts the layer's calls
through ``common.graphs.count`` (a captured call counts once a replay).

``sparse_moe_reference`` is the plain version: every expert over the rows
routed to it, by index, in fp32, one expert at a time.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from surya_tpu_torch.common import graphs

NORM_EPS = 1e-6  # added to the chosen scores' sum before they are normalised


def route(x, gate_w, expert_bias, top_k: int, norm_topk_prob: bool = True,
          routed_scaling_factor: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, H], gate_w [E, H], expert_bias [E] -> (experts [T, k] int64,
    weights [T, k] fp32). The logits are taken in fp32 from the inputs as
    they are stored."""
    scores = torch.sigmoid(F.linear(x.float(), gate_w.float()))
    chosen = torch.topk(scores + expert_bias.float(), top_k, dim=-1).indices
    weights = scores.gather(1, chosen)
    if norm_topk_prob:
        weights = weights / (weights.sum(-1, keepdim=True) + NORM_EPS)
    return chosen, weights * routed_scaling_factor


def sparse_moe(x, gate_w, expert_bias, w13, w2, top_k: int, norm_topk_prob: bool = True,
               routed_scaling_factor: float = 1.0, valid: Optional[torch.Tensor] = None,
               counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [T, H]; gate_w [E, H]; expert_bias [E]; w13 [E, 2I, H] (each
    expert's gate rows, then its up rows); w2 [E, H, I]; valid [T] bool or
    None (every token). Returns [T, H] in x's dtype."""
    T, H = x.shape
    E = w13.shape[0]
    inter = w2.shape[2]
    dev = x.device
    chosen, weights = route(x, gate_w, expert_bias, top_k, norm_topk_prob, routed_scaling_factor)
    flat = chosen.reshape(-1)
    if valid is not None:
        flat = torch.where(valid.repeat_interleave(top_k), flat, E)
    order = torch.argsort(flat, stable=True)
    per_expert = torch.zeros(E + 1, dtype=torch.int64, device=dev).scatter_add_(0, flat, torch.ones_like(flat))[:E]
    offs = per_expert.cumsum(0).to(torch.int32)
    rows = x[order // top_k]  # [T k, H], sorted by expert; sentinel rows last
    h = torch._grouped_mm(rows, w13.transpose(1, 2), offs=offs)
    h = F.silu(h[:, :inter]) * h[:, inter:]
    y = torch._grouped_mm(h, w2.transpose(1, 2), offs=offs)
    inverse = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(), device=dev))
    out = (y[inverse].view(T, top_k, H).float() * weights[..., None]).sum(1)
    if valid is not None:
        out = torch.where(valid[:, None], out, 0.0)
    if counts is not None:
        counts += torch.stack([per_expert.sum(), (per_expert > 0).sum(), per_expert.max()])
    graphs.count(sparse_moe)
    return out.to(x.dtype)


sparse_moe.launches = 0


def sparse_moe_reference(x, gate_w, expert_bias, w13, w2, top_k: int, norm_topk_prob: bool = True,
                         routed_scaling_factor: float = 1.0, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``sparse_moe``: each expert over its rows, in fp32."""
    chosen, weights = route(x, gate_w, expert_bias, top_k, norm_topk_prob, routed_scaling_factor)
    xf = x.float()
    out = torch.zeros_like(xf)
    inter = w2.shape[2]
    for e in range(w13.shape[0]):
        tok, slot = (chosen == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        h = xf[tok] @ w13[e].float().T
        y = (F.silu(h[:, :inter]) * h[:, inter:]) @ w2[e].float().T
        out.index_add_(0, tok, y * weights[tok, slot, None])
    if valid is not None:
        out = torch.where(valid[:, None], out, 0.0)
    return out.to(x.dtype)
