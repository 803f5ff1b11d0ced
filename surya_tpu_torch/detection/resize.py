"""PIL-exact LANCZOS resampling as weight matrices, for the device resize
(the port's own copy of surya_tpu/detection/resize.py, which is numpy only).

The reference's detection preprocessing is a host-side double resize —
``img.thumbnail(size, LANCZOS)`` then ``img.resize(size, LANCZOS)``
(surya/detection/__init__.py:50-62, with a comment that the double resize
matters for accuracy). On a single-core host that costs ~55ms per chunk and
dominates detection wall-clock.

Resampling is linear, so the whole chain — thumbnail's integer ``reduce()``
pre-step (reducing_gap=2.0), its LANCZOS pass over a fractional box, and the
final stretch — composes into ONE [out, in] matrix per axis. The device then
resizes a uint8 chunk batch with two small matmuls fused into the detection
forward. Coefficients replicate PIL's Resample.c / Reduce.c in float (PIL
quantizes coefficients to fixed point and rounds to uint8 between stages, so
outputs can differ by ±1-2 levels — immaterial against the heatmap
thresholds; see tests/test_torch_resize.py).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np


def _lanczos(x: np.ndarray, a: float = 3.0) -> np.ndarray:
    """PIL's lanczos filter: sinc(x) * sinc(x/a) on |x| < a."""
    x = np.asarray(x, np.float64)
    out = np.sinc(x) * np.sinc(x / a)
    return np.where(np.abs(x) < a, out, 0.0)


def lanczos_matrix(in_size: int, out_size: int, box0: float = 0.0, box_w: float | None = None) -> np.ndarray:
    """[out_size, in_size] row-stochastic matrix replicating PIL's
    ImagingResampleHorizontal coefficient computation (Resample.c:
    precompute_coeffs) for LANCZOS, over a fractional source box."""
    if box_w is None:
        box_w = float(in_size)
    scale = box_w / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ss = 1.0 / filterscale

    M = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = box0 + (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        taps = np.arange(xmin, xmax)
        w = _lanczos((taps - center + 0.5) * ss)
        s = w.sum()
        if s != 0:
            w = w / s
        M[xx, xmin:xmax] = w
    return M


def reduce_matrix(in_size: int, factor: int) -> np.ndarray:
    """[ceil(in/factor), in_size] integer box-average matrix replicating
    PIL's Image.reduce() along one axis (partial edge block averages its
    actual pixel count)."""
    out_size = (in_size + factor - 1) // factor
    M = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        lo = i * factor
        hi = min(lo + factor, in_size)
        M[i, lo:hi] = 1.0 / (hi - lo)
    return M


def pil_thumbnail_size(size: Tuple[int, int], target: Tuple[int, int]) -> Tuple[int, int]:
    """PIL Image.thumbnail's aspect-preserving size rounding."""
    w, h = size
    tw, th = target
    if tw >= w and th >= h:
        return (w, h)

    def round_aspect(number, key):
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    aspect = w / h
    x, y = tw, th
    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect, key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return (x, y)


def _thumbnail_axis_matrix(in_size: int, out_size: int, reducing_gap: float = 2.0) -> np.ndarray:
    """One axis of thumbnail's resize: optional integer reduce() pre-step
    (factor = int(in/out/gap) or 1, PIL Image.resize) then LANCZOS over the
    fractional remaining box."""
    if in_size == out_size:
        return np.eye(in_size)
    factor = int(in_size / out_size / reducing_gap) or 1
    if factor > 1:
        R = reduce_matrix(in_size, factor)
        reduced = R.shape[0]
        return lanczos_matrix(reduced, out_size, box0=0.0, box_w=in_size / factor) @ R
    return lanczos_matrix(in_size, out_size)


@lru_cache(maxsize=256)
def double_resize_matrices(src_hw: Tuple[int, int], dst_hw: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """(V [dstH, srcH], H [dstW, srcW]) float32 matrices such that
    ``V @ img @ H.T`` reproduces PIL thumbnail(dst, LANCZOS) followed by
    resize(dst, LANCZOS) — out = resize(thumb) composed into one pass."""
    sh, sw = src_hw
    dh, dw = dst_hw
    tw, th = pil_thumbnail_size((sw, sh), (dw, dh))
    A_v = _thumbnail_axis_matrix(sh, th)
    A_h = _thumbnail_axis_matrix(sw, tw)
    B_v = lanczos_matrix(th, dh) if th != dh else np.eye(dh)
    B_h = lanczos_matrix(tw, dw) if tw != dw else np.eye(dw)
    return (B_v @ A_v).astype(np.float32), (B_h @ A_h).astype(np.float32)
