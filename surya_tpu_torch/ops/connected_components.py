"""Connected components and per-component stats on the device, for detection.

Counterpart of surya_tpu/ops/connected_components.py, with the same outputs:
threshold -> 4-connected labels (each component labelled with the flat index
of its first row-major pixel, plus 1) -> per-component stats in row-major
first-pixel order. Only [pages, max_comps, 11] stats and three numbers a
page cross to the host; the CRAFT box arithmetic runs there
(detection/heatmap.boxes_from_stats).

The JAX version is built from gather-free log-shift scans for the TPU's
compiler. On the GPU a scatter and a gather are cheap, so the flood takes
the minimum label over each whole row run and then each whole column run by
one ``scatter_reduce`` and one gather per direction. Rounds alternate until
a block of rounds changes nothing; each check is one host sync, and rounds
are idempotent once the flood is stable, so a block of ``ROUNDS_PER_CHECK``
rounds gives the same labels with fewer syncs. The component ordinal of a
pixel is the ordinal of its label's root pixel, read by a gather (the JAX
version floods a second time), and the stats are segment reductions over
``max_comps + 1`` segments, with integer sums (exact) for the moments.
"""

from __future__ import annotations

from typing import Tuple

import torch

# stats layout along the last axis
AREA, MIN_X, MAX_X, MIN_Y, MAX_Y, MAX_VAL, SUM_X, SUM_Y, SUM_XX, SUM_YY, SUM_XY = range(11)
STATS_DIM = 11

ROUNDS_PER_CHECK = 4
_BIG = 1 << 40  # above every label


def _run_ids(mask: torch.Tensor) -> torch.Tensor:
    """Id of each masked pixel's run along the last axis of mask [..., W]:
    runs are numbered in flat order, unique over the whole tensor. Unmasked
    pixels get mask.numel(), a segment of their own."""
    flat = mask.reshape(-1, mask.shape[-1])
    prev = torch.nn.functional.pad(flat[:, :-1], (1, 0), value=False)
    starts = (flat & ~prev).reshape(-1)
    ids = torch.cumsum(starts.to(torch.int64), 0) - 1
    return torch.where(mask.reshape(-1), ids, mask.numel())


def _run_min(val: torch.Tensor, ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    """The minimum of flat val [n] over each segment of ids, given to every
    element of that segment."""
    seg_min = torch.full((n_seg,), _BIG, dtype=val.dtype, device=val.device)
    seg_min.scatter_reduce_(0, ids, val, reduce="amin")
    return seg_min[ids]


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """Label the 4-connected components of mask [P, H, W] (bool). Returns
    int64 [P, H, W]: 0 for background, else the flat (per page) index of the
    component's first row-major pixel, plus 1."""
    P, H, W = mask.shape
    n = mask.numel()
    row_ids = _run_ids(mask)
    # column runs: the same over the transposed page, mapped back to [P, H, W]
    col_ids = _run_ids(mask.transpose(1, 2).contiguous()).reshape(P, W, H).transpose(1, 2).reshape(-1)
    pix = torch.arange(1, H * W + 1, device=mask.device).repeat(P)
    flat_mask = mask.reshape(-1)
    val = torch.where(flat_mask, pix, _BIG)
    while True:
        before = val
        for _ in range(ROUNDS_PER_CHECK):
            val = _run_min(val, row_ids, n + 1)
            val = _run_min(val, col_ids, n + 1)
        if torch.equal(val, before):
            break
    return torch.where(flat_mask, val, 0).reshape(P, H, W)


def component_stats(heat: torch.Tensor, low_text, max_comps: int = 256
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Threshold heat [P, H, W] (float in [0, 1]) at low_text (a number or
    [P]) and reduce per-component stats.

    Returns (stats [P, max_comps, STATS_DIM] float32, n_comp [P] int32,
    n_raw [P] int32). Components enumerate in row-major first-pixel order;
    a page with more than max_comps components keeps the first max_comps,
    and n_raw > max_comps tells the caller so. An unused stats row holds
    area 0, sums 0, minima +inf and maxima -inf, as the JAX version's."""
    P, H, W = heat.shape
    dev = heat.device
    low = torch.as_tensor(low_text, dtype=torch.float32, device=dev).expand(P)
    mask = heat > low[:, None, None]
    lab = label_components(mask).reshape(P, H * W)
    flat_mask = mask.reshape(P, H * W)

    # roots: pixel i is a root iff its label is i + 1; a cumsum over them
    # gives each root its 1-based ordinal, which its label's root hands on
    pix = torch.arange(H * W, device=dev)[None, :]
    is_root = flat_mask & (lab == pix + 1)
    ordinal = torch.cumsum(is_root.to(torch.int64), dim=1)
    n_raw = ordinal[:, -1].to(torch.int32)
    n_comp = torch.clamp(n_raw, max=max_comps)
    comp = torch.gather(ordinal, 1, (lab - 1).clamp(min=0))
    # 1-based component id per page; 0: background and components past max_comps
    seg = torch.where(flat_mask & (comp <= max_comps), comp, 0)
    n_seg = max_comps + 1
    seg_flat = (seg + torch.arange(P, device=dev)[:, None] * n_seg).reshape(-1)

    # every pixel of segments 1.. is masked; segment 0 is dropped below
    xs = (pix % W).expand(P, -1).reshape(-1)
    ys = (pix // W).expand(P, -1).reshape(-1)

    def ssum(v):  # integer sums: exact whatever the order of the atomics
        out = torch.zeros(P * n_seg, dtype=torch.int64, device=dev)
        return out.index_add_(0, seg_flat, v).to(torch.float32)

    def sext(v, reduce, fill):
        out = torch.full((P * n_seg,), fill, dtype=torch.float32, device=dev)
        return out.scatter_reduce_(0, seg_flat, v.to(torch.float32), reduce=reduce)

    inf = float("inf")
    stats = torch.stack(
        [
            ssum(torch.ones_like(xs)),
            sext(xs, "amin", inf), sext(xs, "amax", -inf),
            sext(ys, "amin", inf), sext(ys, "amax", -inf),
            sext(heat.reshape(-1), "amax", -inf),
            ssum(xs), ssum(ys), ssum(xs * xs), ssum(ys * ys), ssum(xs * ys),
        ],
        dim=-1,
    ).reshape(P, n_seg, STATS_DIM)
    return stats[:, 1:], n_comp, n_raw


def dynamic_threshold_inputs(heat: torch.Tensor, valid_px=None) -> torch.Tensor:
    """Top-10% mean intensity per page, heat [P, H, W] -> [P], by bisecting
    the decile threshold (10 rounds of count-above), as the JAX version.
    valid_px ([P], optional) is the number of real pixels of each page when
    rows are zero-padded: the decile is then k = valid_px // 10."""
    P, H, W = heat.shape
    flat = heat.reshape(P, H * W).float()
    if valid_px is None:
        k = torch.full((P, 1), float(max(1, H * W // 10)), device=heat.device)
    else:
        k = torch.clamp(torch.floor(valid_px.float() / 10.0), min=1.0)[:, None]
    lo = torch.zeros((P, 1), device=heat.device)
    hi = torch.ones((P, 1), device=heat.device)
    for _ in range(10):
        mid = (lo + hi) * 0.5
        enough = (flat >= mid).sum(dim=1, keepdim=True) >= k
        lo = torch.where(enough, mid, lo)
        hi = torch.where(enough, hi, mid)
    sel = flat >= lo
    cnt = torch.clamp(sel.sum(dim=1), min=1).float()
    return (flat * sel).sum(dim=1) / cnt
