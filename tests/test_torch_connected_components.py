"""The port's connected components and component stats
(surya_tpu_torch/ops/connected_components.py) against a numpy BFS oracle and
against the JAX package's functions on the same inputs: labels, n_comp and
n_raw equal, stats within 1e-6 relative (both sides sum integers below 2^24
here, so they agree exactly), the top-10% means within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surya_tpu.ops import connected_components as jcc
from surya_tpu_torch.ops import connected_components as cc

STATS_RTOL = 1e-6


def _bfs_components(mask: np.ndarray):
    """4-connected components, enumerated by first row-major pixel."""
    H, W = mask.shape
    seen = np.zeros_like(mask, bool)
    comps = []
    for y in range(H):
        for x in range(W):
            if not mask[y, x] or seen[y, x]:
                continue
            stack = [(y, x)]
            seen[y, x] = True
            pix = []
            while stack:
                cy, cx = stack.pop()
                pix.append((cy, cx))
                for ny, nx in ((cy + 1, cx), (cy - 1, cx), (cy, cx + 1), (cy, cx - 1)):
                    if 0 <= ny < H and 0 <= nx < W and mask[ny, nx] and not seen[ny, nx]:
                        seen[ny, nx] = True
                        stack.append((ny, nx))
            comps.append(pix)
    return comps


def _stats(heat: np.ndarray, low, max_comps):
    out = cc.component_stats(torch.from_numpy(heat), low, max_comps=max_comps)
    return tuple(t.numpy() for t in out)


def _check_against_jax(heat: np.ndarray, low, max_comps):
    stats, n_comp, n_raw = _stats(heat, low, max_comps)
    jstats, jn, jraw = (np.asarray(a) for a in jcc.component_stats(jnp.asarray(heat), low, max_comps=max_comps))
    np.testing.assert_array_equal(n_comp, jn)
    np.testing.assert_array_equal(n_raw, jraw)
    np.testing.assert_allclose(stats, jstats, rtol=STATS_RTOL, atol=0)
    mask = heat > np.asarray(low, np.float32).reshape(-1, 1, 1)
    labels = cc.label_components(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(labels, np.asarray(jcc.label_components(jnp.asarray(mask))))
    return stats, n_comp, n_raw


def _check(heat: np.ndarray, low: float, max_comps=64):
    stats, n_comp, n_raw = _check_against_jax(heat[None], low, max_comps)
    assert n_raw[0] >= n_comp[0]
    stats, n_comp = stats[0], int(n_comp[0])
    comps = _bfs_components(heat > low)
    assert n_comp == min(len(comps), max_comps), (n_comp, len(comps))
    for i, pix in enumerate(comps[:max_comps]):
        ys = np.array([p[0] for p in pix], np.float64)
        xs = np.array([p[1] for p in pix], np.float64)
        s = stats[i]
        assert s[cc.AREA] == len(pix)
        assert s[cc.MIN_X] == xs.min() and s[cc.MAX_X] == xs.max()
        assert s[cc.MIN_Y] == ys.min() and s[cc.MAX_Y] == ys.max()
        assert s[cc.MAX_VAL] == heat[ys.astype(int), xs.astype(int)].max()
        for col, v in ((cc.SUM_X, xs), (cc.SUM_Y, ys), (cc.SUM_XX, xs * xs), (cc.SUM_YY, ys * ys),
                       (cc.SUM_XY, xs * ys)):
            assert s[col] == v.sum()


def test_blobs_and_snakes():
    heat = np.zeros((64, 96), np.float32)
    heat[5:12, 10:80] = 0.9  # wide line
    heat[20:24, 5:9] = 0.7  # small blob
    heat[30, 5:90] = 0.8  # 1px snake
    heat[40:60, 40] = 0.8  # vertical snake
    heat[50:62, 70:73] = 0.85  # L-shaped component
    heat[59:62, 60:73] = 0.85
    _check(heat, 0.35)


def test_spiral_needs_many_rounds():
    """A spiral: its label reaches the inner end only after many row and
    column rounds, more than one block of ROUNDS_PER_CHECK."""
    heat = np.zeros((41, 41), np.float32)
    lo, hi = 0, 40
    while lo < hi:
        heat[lo, lo:hi + 1] = 1.0
        heat[lo:hi + 1, hi] = 1.0
        heat[hi, lo:hi + 1] = 1.0
        heat[lo + 2:hi + 1, lo] = 1.0
        if lo + 2 <= hi - 2:
            heat[lo + 2, lo:lo + 3] = 1.0
        lo, hi = lo + 2, hi - 2
    _check(heat, 0.5)


def test_diagonal_not_connected():
    heat = np.zeros((16, 16), np.float32)
    heat[2, 2] = 1.0
    heat[3, 3] = 1.0  # diagonal only: 4-connectivity keeps them apart
    _check(heat, 0.5)


@pytest.mark.parametrize("seed", range(4))
def test_random_noise_matches_oracle(seed):
    heat = np.random.default_rng(seed).uniform(0, 1, (48, 48)).astype(np.float32)
    _check(heat, 0.62, max_comps=512)


def test_batched_pages_are_isolated():
    heat = np.zeros((2, 8, 8), np.float32)
    heat[0, 0:8, 3] = 1.0  # a vertical line touching the page edge
    heat[1, 0, :] = 1.0  # would merge with page 0's line if pages leaked
    stats, n, _ = _check_against_jax(heat, 0.5, max_comps=8)
    assert n.tolist() == [1, 1]
    assert stats[0, 0, cc.AREA] == 8 and stats[1, 0, cc.AREA] == 8


def test_per_page_thresholds_match_jax():
    heat = np.random.default_rng(5).uniform(0, 1, (3, 32, 40)).astype(np.float32)
    _check_against_jax(heat, np.array([0.5, 0.7, 0.9], np.float32), max_comps=128)


def test_overflow_keeps_first_components():
    heat = np.zeros((8, 33), np.float32)
    heat[2, 0:32:2] = 1.0  # 16 isolated pixels
    stats, n, n_raw = _check_against_jax(heat[None], 0.5, max_comps=4)
    assert int(n_raw[0]) == 16 and int(n[0]) == 4
    np.testing.assert_array_equal(stats[0, :, cc.MIN_X], [0, 2, 4, 6])


def test_dynamic_threshold_inputs():
    heat = np.zeros((1, 10, 10), np.float32)
    heat[0, 0] = 1.0  # 10 pixels of 1.0: exactly the top 10%
    top10 = cc.dynamic_threshold_inputs(torch.from_numpy(heat)).numpy()
    assert abs(top10[0] - 1.0) < 1e-6


def test_dynamic_threshold_matches_jax_and_ignores_padding():
    """With valid_px, a half-padded page gives the top-10% mean of the
    unpadded page; both equal the JAX function's within 1e-6."""
    rng = np.random.default_rng(0)
    real = rng.uniform(0, 1, (2, 10, 10)).astype(np.float32)
    padded = np.concatenate([real, np.zeros_like(real)], axis=1)
    valid = np.array([100, 100])
    t_real = cc.dynamic_threshold_inputs(torch.from_numpy(real)).numpy()
    t_pad = cc.dynamic_threshold_inputs(torch.from_numpy(padded), torch.from_numpy(valid)).numpy()
    assert np.abs(t_real - t_pad).max() < 2e-3
    np.testing.assert_allclose(t_real, np.asarray(jcc.dynamic_threshold_inputs(jnp.asarray(real))), atol=1e-6)
    np.testing.assert_allclose(
        t_pad, np.asarray(jcc.dynamic_threshold_inputs(jnp.asarray(padded), valid)), atol=1e-6)
