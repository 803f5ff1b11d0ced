"""The sparse-expert feed-forward of an LFM2-MoE layer, routed and run on
the device with no synchronisation with the host.

It replaces no kernel of the JAX package: the JAX package has no sparse
layer. It was added for the recognition foundation model's LFM2-MoE decoder
(models/lfm2_decoder.py).

``sparse_moe`` runs, on any device, in static shapes whatever the routing:

1. ``route``: fp32 logits of the tokens, their sigmoid scores, the top-k
   of the scores plus the expert bias (the bias chooses, it does not
   weigh), the chosen scores normalised to sum to 1 (``norm_topk_prob``)
   and scaled by ``routed_scaling_factor``. A token that is not valid (a
   prefill wave's padding) takes the sentinel expert E.
2. ``permute``: the token-expert rows (tokens x k of them) sorted by
   expert (a stable sort: rows of one expert keep the order of their
   tokens; sentinel rows sort after every real row and fall outside every
   expert's group), the group offsets (the running counts, on the device),
   each row's place in the sorted order, and x's rows gathered there.
3. Gate and up projections of every expert as one grouped GEMM over the
   sorted rows (``torch._grouped_mm``, group e the rows of expert e),
   ``swiglu``, and the down projection as a second grouped GEMM. Rows past
   the last group are not computed.
4. ``combine``: each token's rows read back at their places (a gather: no
   atomics, so the sum is the same on every run) and added up weighted, in
   fp32. A token that is not valid gets zeros.

Both GEMMs are one launch each whatever the routing, and no step reads a
device value on the host, so a CUDA graph captures the layer. What bounds
the GEMMs on an H100: in decode every step reads all the experts' weights
(128 slots x top-4 leave no expert without rows), so the weights' bytes
over the memory bandwidth; in prefill, where each expert takes thousands
of rows, their operations.

On a CUDA input with ``use_kernels`` (the default), steps 1, 2, 3's
SwiGLU and 4 are four hand-written kernels (``csrc/moe.cu``, for bf16, 32
experts and top-4), so that a layer call is six launches (eight on the
card: each ``torch._grouped_mm`` launches PyTorch's
``prepare_grouped_gemm_data`` before its CUTLASS kernel); on the CPU or
with ``use_kernels=False`` they are the plain functions above, some 35
PyTorch launches. There is no fallback: a CUDA input the kernels do not
take (a float32 model among them, which passes ``use_kernels=False`` on
the card) raises. None of the four replaces a TPU kernel; each
was added because its plain version's launches and traffic cost more
device time than the GEMMs' own bound (``PERF.md``):

- ``route_kernel`` (name holds ``reduce``): the router's 32 dot products
  of 2048 a token, the choice and the weights. Bound: x's bytes at prefill
  (64 MB for a 128 x 128 wave); a launch's fixed time at decode. Design:
  a CTA of 16 tokens takes the logits on the tensor cores (mma.sync, bf16
  products summed in fp32), each of its 8 warps over an eighth of the
  columns with 24 16-byte loads in flight, so that a decode step waits on
  two rounds of loads; the eight partial sums are added in a fixed order
  and each token chosen by a warp in registers, writing only the choices,
  weights and each 8 tokens' rows by expert, where the plain version made
  about 10 launches and an fp32 copy of x.
- ``permute_kernel`` (name holds ``gather``): the stable sort, offsets,
  inverse places, the gather of x's rows and the counters. Bound: the
  gathered rows' bytes (read and written: 0.38 GB for a wave of 90 valid
  positions in 128); a launch's fixed time at decode. Design: a counting
  sort from the route blocks' histograms (each CTA sums them itself: no
  second pass, no atomics), a row's rank among its expert's rows in its
  warp by ``__match_any_sync``, padding rows neither sorted nor gathered;
  in place of a radix sort, a scatter, a cumsum and a gather of every row.
- ``swiglu_kernel`` (name holds ``elementwise``): reads the first GEMM's
  output once, writes silu(gate) x up, computed in fp32 and rounded once.
  Bound: h's bytes read and the product's written (0.50 GB a wave); a
  launch at decode. Design: 16-byte loads over the rows below the total on
  the device only, where the plain version read a strided half into a
  rounded silu and read both again for the product.
- ``combine_kernel`` (name holds ``gather``): a token's 4 rows weighted
  and added in fp32 in the order j = 0..3, rounded once to x's dtype.
  Bound: the rows read and the output written (0.25 GB a wave); a launch
  at decode. Design: a CTA a token, the places from ``permute_kernel``, so
  no inverse scatter, no fp32 copy of the rows, no separate sum, mask and
  cast.

``counts`` (an int64 tensor [3] on the device, optional) is added to in
place: the token-expert rows computed, the experts with at least one row,
and the rows of the largest expert, so that a caller reads them once after
its last synchronisation. ``sparse_moe.launches`` counts the layer's calls
and each ``*_kernel.launches`` its kernel's launches, through
``common.graphs.count`` (a captured call counts once a replay).

``sparse_moe_reference`` is the plain version of the whole layer: every
expert over the rows routed to it, by index, in fp32, one expert at a time.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from surya_tpu_torch.common import graphs
from surya_tpu_torch.ops import _build

NORM_EPS = 1e-6  # added to the chosen scores' sum before they are normalised
KERNEL_EXPERTS, KERNEL_TOP_K = 32, 4  # what csrc/moe.cu is built for
ROUTE_TOKENS = 8  # tokens a route block (csrc/moe.cu): one histogram row each
MAX_BLOCKS_PER_CTA = 32  # route blocks a permute CTA takes at most


# -- the plain functions: the CPU, use_kernels=False ---------------------------------

def route(x, gate_w, expert_bias, top_k: int, norm_topk_prob: bool = True, routed_scaling_factor: float = 1.0,
          valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, H], gate_w [E, H], expert_bias [E], valid [T] bool or None ->
    (experts [T, k] int64, E where a token is not valid; weights [T, k]
    fp32). The logits are taken in fp32 from the inputs as they are stored."""
    scores = torch.sigmoid(F.linear(x.float(), gate_w.float()))
    chosen = torch.topk(scores + expert_bias.float(), top_k, dim=-1).indices
    weights = scores.gather(1, chosen)
    if norm_topk_prob:
        weights = weights / (weights.sum(-1, keepdim=True) + NORM_EPS)
    if valid is not None:
        chosen = torch.where(valid[:, None], chosen, gate_w.shape[0])
    return chosen, weights * routed_scaling_factor


def permute(x, chosen, n_experts: int, counts: Optional[torch.Tensor] = None):
    """x [T, H], chosen [T, k] (n_experts: the sentinel) -> (rows [T k, H]
    sorted by expert, sentinel rows last; offs [E] int32, the running
    counts; inverse [T k], each row's place in the sorted order). Adds to
    counts (see the module docstring)."""
    flat = chosen.reshape(-1)
    order = torch.argsort(flat, stable=True)
    per_expert = torch.zeros(n_experts + 1, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat))[:n_experts]
    offs = per_expert.cumsum(0).to(torch.int32)
    rows = x[order // chosen.shape[1]]
    inverse = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(), device=x.device))
    if counts is not None:
        counts += torch.stack([per_expert.sum(), (per_expert > 0).sum(), per_expert.max()])
    return rows, offs, inverse


def swiglu(h, inter: int):
    """h [rows, 2I] (gate, then up) -> silu(gate) * up [rows, I]."""
    return F.silu(h[:, :inter]) * h[:, inter:]


def combine(y, inverse, weights, valid: Optional[torch.Tensor], dtype):
    """y [T k, H] in sorted order, inverse [T k], weights [T, k] -> [T, H]:
    each token's rows weighted and added in fp32, zeros where not valid."""
    T, k = weights.shape
    out = (y[inverse].view(T, k, -1).float() * weights[..., None]).sum(1)
    if valid is not None:
        out = torch.where(valid[:, None], out, 0.0)
    return out.to(dtype)


# -- the kernels: a CUDA input with use_kernels ------------------------------------------

def _check_kernels(x, gate_w, expert_bias, w13, w2, top_k: int, valid, counts) -> None:
    """Raise for what csrc/moe.cu does not take."""
    T, H = x.shape
    E = w13.shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"sparse_moe: the kernels take bf16 activations, got {x.dtype} "
                        f"(a float32 model on the card passes use_kernels=False)")
    if E != KERNEL_EXPERTS or top_k != KERNEL_TOP_K:
        raise ValueError(f"sparse_moe: the kernels are built for {KERNEL_EXPERTS} experts and top-{KERNEL_TOP_K}, "
                         f"got {E} and top-{top_k}")
    if T == 0 or H % 1024 or w2.shape[2] % 8:
        raise ValueError(f"sparse_moe: the kernels take T > 0, a width that is a multiple of 1024 and an "
                         f"intermediate size that is a multiple of 8, got T={T}, H={H}, I={w2.shape[2]}")
    if gate_w.dtype != torch.bfloat16 or expert_bias.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"sparse_moe: the kernels take a bf16 router and a bf16 or float32 bias, got "
                        f"{gate_w.dtype} and {expert_bias.dtype}")
    if gate_w.shape != (E, H) or expert_bias.shape != (E,):
        raise ValueError(f"sparse_moe: router {tuple(gate_w.shape)} / bias {tuple(expert_bias.shape)} do not match "
                         f"{E} experts of width {H}")
    for t in (x, gate_w, expert_bias, valid, counts):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"sparse_moe: every input must be contiguous on {x.device}")
    if valid is not None and (valid.dtype != torch.bool or valid.shape != (T,)):
        raise ValueError(f"sparse_moe: valid must be a bool [{T}], got {valid.dtype} {tuple(valid.shape)}")
    if counts is not None and (counts.dtype != torch.int64 or counts.shape != (3,)):
        raise ValueError("sparse_moe: counts must be an int64 [3]")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def route_kernel(x, gate_w, expert_bias, norm_topk_prob: bool, routed_scaling_factor: float, valid):
    """``route`` as csrc/moe.cu's route kernel: (chosen [T, 4] int32,
    weights [T, 4] fp32, hist [ceil(T / 8), 32] int32: each route block's
    rows by expert)."""
    T, H = x.shape
    dev = x.device
    chosen = torch.empty(T, KERNEL_TOP_K, dtype=torch.int32, device=dev)
    weights = torch.empty(T, KERNEL_TOP_K, dtype=torch.float32, device=dev)
    hist = torch.empty(-(-T // ROUTE_TOKENS), KERNEL_EXPERTS, dtype=torch.int32, device=dev)
    rc = _build.library().lib.surya_moe_route(
        x.data_ptr(), gate_w.data_ptr(), expert_bias.data_ptr(), int(expert_bias.dtype == torch.bfloat16),
        _ptr(valid), chosen.data_ptr(), weights.data_ptr(), hist.data_ptr(), T, H, int(norm_topk_prob), NORM_EPS,
        float(routed_scaling_factor), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "moe route")
    graphs.count(route_kernel)
    return chosen, weights, hist


def permute_kernel(x, chosen, hist, counts):
    """``permute`` as csrc/moe.cu's permute kernel, from route_kernel's
    chosen and hist: (rows [T 4, H], the rows past offs[-1] unwritten; offs
    [32] int32; inverse [T 4] int32, -1 for a token that is not valid)."""
    T, H = x.shape
    dev = x.device
    rows = torch.empty(T * KERNEL_TOP_K, H, dtype=x.dtype, device=dev)
    inverse = torch.empty(T * KERNEL_TOP_K, dtype=torch.int32, device=dev)
    offs = torch.empty(KERNEL_EXPERTS, dtype=torch.int32, device=dev)
    # a CTA an SM, each over one route block or more
    per_cta = min(MAX_BLOCKS_PER_CTA, -(-hist.shape[0] // _sm_count(dev.index)))
    rc = _build.library().lib.surya_moe_permute(
        x.data_ptr(), chosen.data_ptr(), hist.data_ptr(), rows.data_ptr(), inverse.data_ptr(), offs.data_ptr(),
        _ptr(counts), T, H, per_cta, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "moe permute")
    graphs.count(permute_kernel)
    return rows, offs, inverse


def swiglu_kernel(h, offs, inter: int):
    """``swiglu`` as csrc/moe.cu's kernel, over the rows below offs[-1]
    (the rows past it unwritten)."""
    if h.shape[1] != 2 * inter or not h.is_contiguous() or h.dtype != torch.bfloat16:
        raise ValueError(f"swiglu_kernel: need a contiguous bf16 [rows, {2 * inter}], got {h.dtype} "
                         f"{tuple(h.shape)} strides {h.stride()}")
    n = h.shape[0]
    out = torch.empty(n, inter, dtype=h.dtype, device=h.device)
    blocks = min(8 * _sm_count(h.device.index), -(-n * inter // (8 * 256)))  # grid-stride, 8 CTAs an SM at most
    rc = _build.library().lib.surya_moe_swiglu(h.data_ptr(), offs.data_ptr(), out.data_ptr(), n, inter, blocks,
                                               torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(rc, "moe swiglu")
    graphs.count(swiglu_kernel)
    return out


def combine_kernel(y, inverse, weights, valid):
    """``combine`` as csrc/moe.cu's kernel: [T, H] bf16."""
    T, H = weights.shape[0], y.shape[1]
    if not y.is_contiguous() or y.dtype != torch.bfloat16:
        raise ValueError(f"combine_kernel: need a contiguous bf16 y, got {y.dtype} strides {y.stride()}")
    out = torch.empty(T, H, dtype=y.dtype, device=y.device)
    rc = _build.library().lib.surya_moe_combine(y.data_ptr(), inverse.data_ptr(), weights.data_ptr(), _ptr(valid),
                                                out.data_ptr(), T, H, torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(rc, "moe combine")
    graphs.count(combine_kernel)
    return out


for _fn in (route_kernel, permute_kernel, swiglu_kernel, combine_kernel):
    _fn.launches = 0


def sparse_moe(x, gate_w, expert_bias, w13, w2, top_k: int, norm_topk_prob: bool = True,
               routed_scaling_factor: float = 1.0, valid: Optional[torch.Tensor] = None,
               counts: Optional[torch.Tensor] = None, use_kernels: bool = True) -> torch.Tensor:
    """x [T, H]; gate_w [E, H]; expert_bias [E]; w13 [E, 2I, H] (each
    expert's gate rows, then its up rows); w2 [E, H, I]; valid [T] bool or
    None (every token). Returns [T, H] in x's dtype."""
    E, inter = w13.shape[0], w2.shape[2]
    graphs.count(sparse_moe)
    kernels = use_kernels and x.is_cuda
    if kernels:
        _check_kernels(x, gate_w, expert_bias, w13, w2, top_k, valid, counts)
        chosen, weights, hist = route_kernel(x, gate_w, expert_bias, norm_topk_prob, routed_scaling_factor, valid)
        rows, offs, inverse = permute_kernel(x, chosen, hist, counts)
    else:
        chosen, weights = route(x, gate_w, expert_bias, top_k, norm_topk_prob, routed_scaling_factor, valid)
        rows, offs, inverse = permute(x, chosen, E, counts)
    h = torch._grouped_mm(rows, w13.transpose(1, 2), offs=offs)
    a = swiglu_kernel(h, offs, inter) if kernels else swiglu(h, inter)
    y = torch._grouped_mm(a, w2.transpose(1, 2), offs=offs)
    return combine_kernel(y, inverse, weights, valid) if kernels else combine(y, inverse, weights, valid, x.dtype)


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
