"""The port's device resize (surya_tpu_torch/detection/resize.py matrices,
``detection.resize_on_device``) against PIL's double LANCZOS and
against the JAX package's ``_resize_device`` on the same canvas, on the CPU
in float32, and the port's resize-matrix cache.

Tolerances: against PIL, as tests/test_device_resize.py (mean |diff| < 0.6
levels, 99.5th percentile <= 3: PIL rounds coefficients to fixed point and
to uint8 between its two passes); against the JAX function, equal pixels
(both compute the same float32 products; a sum order that differs may move
a pixel that lies within float32 rounding of a half level by one level, so
at most 1 level and at most 1e-4 of the pixels)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from surya_tpu.detection import DetectionPredictor as JaxDetectionPredictor
from surya_tpu.detection.resize import double_resize_matrices as jax_double_resize_matrices
from surya_tpu_torch.detection import DetectionPredictor, resize_on_device
from surya_tpu_torch.detection.resize import double_resize_matrices, pil_thumbnail_size

torch.set_num_threads(1)

CASES = [
    ((896, 1240), (896, 896)),  # a typical page chunk: mild downscale and stretch
    ((1400, 1000), (896, 896)),  # a tall chunk
    ((2200, 1800), (896, 896)),  # a large page: the reduce() pre-step
    ((600, 500), (896, 896)),  # upscale on both axes (thumbnail does nothing)
    ((896, 896), (896, 896)),  # identity
    ((123, 1111), (896, 896)),  # extreme aspect
]


def _structured(h, w, seed):
    """Document-like content: a smooth background, dark lines and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 200 + 40 * np.sin(xx / 37.0) * np.cos(yy / 23.0)
    base[(yy % 40) < 8] = 30
    base = base + rng.normal(0, 10, (h, w))
    return np.clip(base, 0, 255).astype(np.uint8)[..., None].repeat(3, -1)


def _pil_double(arr: np.ndarray, dst_wh) -> np.ndarray:
    img = Image.fromarray(arr)
    img.thumbnail(dst_wh, Image.Resampling.LANCZOS)
    return np.asarray(img.resize(dst_wh, Image.Resampling.LANCZOS), np.float64)


@pytest.fixture(scope="module")
def detectors():
    ref = JaxDetectionPredictor(checkpoint=os.devnull, tiny=True)
    ours = DetectionPredictor(tiny=True, device="cpu", jax_params=jax.tree.map(np.asarray, ref.params))
    # the JAX program's tail returns its input: forward_resize then gives the
    # resized pixels, rounded back to uint8
    ref._apply_heat = lambda params, x: x
    return ref, ours


def _canvas(arrays, gray=False):
    """Chunks on a zeroed canvas bucketed to 256 px, their size groups, and
    the stacked matrices (groups padded to a power of two), as the predictor
    builds them."""
    sizes = [a.shape[:2] for a in arrays]
    Hb = -(-max(s[0] for s in sizes) // 256) * 256
    Wb = -(-max(s[1] for s in sizes) // 256) * 256
    C = 1 if gray else 3
    canvas = np.zeros((len(arrays), Hb, Wb, C), np.uint8)
    for i, a in enumerate(arrays):
        canvas[i, : a.shape[0], : a.shape[1]] = a[..., :C]
    uniq = sorted(set(sizes))
    G = 1
    while G < len(uniq):
        G *= 2
    Vs, Hs = np.zeros((G, 896, Hb), np.float32), np.zeros((G, 896, Wb), np.float32)
    for g, s in enumerate(uniq):
        V, Hm = double_resize_matrices(s, (896, 896))
        Vs[g, :, : s[0]], Hs[g, :, : s[1]] = V, Hm
    gid = np.array([uniq.index(s) for s in sizes], np.int64)
    return canvas, Vs, Hs, gid


def _ours(canvas, Vs, Hs, gid) -> np.ndarray:
    """The port's resized pixels [B, h, w, 3], as the detector's forward
    takes them: broadcast to RGB, then / 255 in float32 (read back x 255)."""
    out = resize_on_device(*(torch.from_numpy(a) for a in (canvas, Vs, Hs, gid)), torch.float32)
    out = out.expand(-1, 3, -1, -1) / 255.0
    return torch.round(out * 255.0).permute(0, 2, 3, 1).numpy().astype(np.int16)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_matches_pil_double_resize(case):
    (h, w), dst = CASES[case]
    arr = _structured(h, w, case)
    ref = _pil_double(arr, dst)
    mine = _ours(*_canvas([arr]))[0].astype(np.float64)
    assert mine.shape == ref.shape
    diff = np.abs(mine - ref)
    assert diff.mean() < 0.6, ((h, w), diff.mean())
    assert np.percentile(diff, 99.5) <= 3, ((h, w), np.percentile(diff, 99.5))


@pytest.mark.parametrize("gray", [False, True])
def test_matches_jax_resize_device(detectors, gray):
    """Two source sizes in one batch (two size groups) on one canvas; the
    gray canvas ships one channel and comes back as RGB."""
    ref = detectors[0]
    arrays = [_structured(896, 1240, 0), _structured(600, 500, 1)]
    canvas, Vs, Hs, gid = _canvas(arrays, gray=gray)
    expected = np.asarray(ref._forward_resize(ref.params, jnp.asarray(canvas), jnp.asarray(Vs), jnp.asarray(Hs),
                                              jnp.asarray(gid.astype(np.int32)))).astype(np.int16)
    got = _ours(canvas, Vs, Hs, gid)
    assert got.shape == expected.shape == (2, 896, 896, 3)
    diff = np.abs(got - expected)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, (diff.max(), (diff > 0).mean())
    if gray:
        rgb = _ours(*_canvas(arrays))
        np.testing.assert_array_equal(got, rgb)


def test_matrices_match_jax_package():
    for (h, w), dst in CASES:
        for mine, ref in zip(double_resize_matrices((h, w), dst), jax_double_resize_matrices((h, w), dst)):
            np.testing.assert_array_equal(mine, ref)


def test_thumbnail_size_matches_pil():
    for (h, w), dst in CASES:
        img = Image.fromarray(np.zeros((h, w, 3), np.uint8))
        img.thumbnail(dst, Image.Resampling.LANCZOS)
        assert pil_thumbnail_size((w, h), dst) == img.size, (w, h)


def test_rows_are_stochastic():
    V, H = double_resize_matrices((1400, 1000), (896, 896))
    np.testing.assert_allclose(V.sum(1), 1.0, atol=1e-5)
    np.testing.assert_allclose(H.sum(1), 1.0, atol=1e-5)


def test_resize_cache_evicts_one_entry(detectors):
    """Past resize_cache_entries stacks the least recently used one goes
    (the JAX package clears the whole cache, the one in use too): the stack
    in use and the one just used survive, the count stays at the limit."""
    det = detectors[1]
    det._resize_mat_cache.clear()
    limit = det.resize_cache_entries
    assert limit == 32
    first = det._resize_mats([(100, 100)], 1, (256, 256))
    for i in range(limit - 1):
        det._resize_mats([(100 + i + 1, 100)], 1, (256, 256))
    assert len(det._resize_mat_cache) == limit
    assert det._resize_mats([(100, 100)], 1, (256, 256)) is first  # a hit: now the most recent
    new = det._resize_mats([(50, 60)], 1, (256, 256))  # a miss at the limit
    assert len(det._resize_mat_cache) == limit
    assert det._resize_mats([(50, 60)], 1, (256, 256)) is new
    assert det._resize_mats([(100, 100)], 1, (256, 256)) is first
    assert ((101, 100),) + (1, 256, 256) not in det._resize_mat_cache  # the least recent went
    det._resize_mat_cache.clear()
