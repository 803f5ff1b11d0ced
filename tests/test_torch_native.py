"""The port's C++ CRAFT host op (surya_tpu_torch/native) against the JAX
package's op on the same heatmaps (the same source: quads and confidences
equal, in the same order), against the port's OpenCV path (the two
enumerate components in other orders: matched by IoU > 0.95, confidences
within 1e-3, as tests/test_native.py), and its uint8 entry against its
float entry (quads within 1e-4, confidences within 1e-5)."""

import numpy as np
import pytest

from surya_tpu import native as jax_native
from surya_tpu_torch import native
from surya_tpu_torch.detection import heatmap
from surya_tpu_torch.settings import settings


def _synthetic_heatmap(seed=0):
    rng = np.random.default_rng(seed)
    heat = rng.uniform(0, 0.15, (300, 400)).astype(np.float32)
    heat[40:58, 30:330] = rng.uniform(0.75, 0.95, (18, 300))  # text-line blobs
    heat[90:106, 50:250] = rng.uniform(0.7, 0.95, (16, 200))
    for i in range(20):  # a slightly rotated blob
        heat[150 + i, 60 + i : 260 + i] = 0.85
    heat[250:252, 10:13] = 0.9  # a blob under the size filter
    return heat


def _quad_iou(a, b):
    ax0, ay0, ax1, ay1 = a[:, 0].min(), a[:, 1].min(), a[:, 0].max(), a[:, 1].max()
    bx0, by0, bx1, by1 = b[:, 0].min(), b[:, 1].min(), b[:, 0].max(), b[:, 1].max()
    inter = max(0, min(ax1, bx1) - max(ax0, bx0)) * max(0, min(ay1, by1) - max(ay0, by0))
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return inter / union if union else 0


def _detect(heat, use_native):
    old = settings.USE_NATIVE_POSTPROCESS
    settings.USE_NATIVE_POSTPROCESS = use_native
    try:
        return heatmap.detect_boxes(heat, 0.6, 0.35)
    finally:
        settings.USE_NATIVE_POSTPROCESS = old


@pytest.mark.parametrize("kind", ["blobs", "noise", "uint8"])
def test_native_matches_jax_package_op(kind):
    if jax_native.craft_ops() is None:
        pytest.fail("the JAX package's native craft_ops did not build")
    rng = np.random.default_rng(3)
    heat = {"blobs": _synthetic_heatmap(), "noise": rng.uniform(0, 1, (128, 128)).astype(np.float32),
            "uint8": np.round(_synthetic_heatmap(seed=7) * 255.0).astype(np.uint8)}[kind]
    quads, confs = native.extract_boxes(heat, 0.6, 0.35)
    ref_quads, ref_confs = jax_native.extract_boxes(heat, 0.6, 0.35)
    assert len(quads) > 0
    np.testing.assert_array_equal(quads, ref_quads)
    np.testing.assert_array_equal(confs, ref_confs)


def test_native_matches_opencv():
    heat = _synthetic_heatmap()
    cv_boxes, cv_confs = _detect(heat, False)
    nat_boxes, nat_confs = _detect(heat, True)
    assert len(nat_boxes) == len(cv_boxes) > 0
    used = set()
    for nb, nc in zip(nat_boxes, nat_confs):
        best_iou, best_j = 0, None
        for j, cb in enumerate(cv_boxes):
            iou = _quad_iou(np.asarray(nb), np.asarray(cb))
            if j not in used and iou > best_iou:
                best_iou, best_j = iou, j
        assert best_iou > 0.95, (nb, best_iou)
        assert abs(nc - cv_confs[best_j]) < 1e-3
        used.add(best_j)


def test_native_random_noise_agreement():
    """On pure noise the two paths still agree on the box count."""
    heat = np.random.default_rng(3).uniform(0, 1, (128, 128)).astype(np.float32)
    assert len(_detect(heat, True)[0]) == len(_detect(heat, False)[0])


def test_native_uint8_matches_float():
    heat_u8 = np.round(_synthetic_heatmap(seed=7) * 255.0).astype(np.uint8)
    f_boxes, f_confs = native.extract_boxes(heat_u8.astype(np.float32) / 255.0, 0.6, 0.35)
    u_boxes, u_confs = native.extract_boxes(heat_u8, 0.6, 0.35)
    assert len(u_boxes) == len(f_boxes) > 0
    np.testing.assert_allclose(u_boxes, f_boxes, atol=1e-4)
    np.testing.assert_allclose(u_confs, f_confs, atol=1e-5)


def test_dynamic_thresholds_uint8_matches_float():
    heat = _synthetic_heatmap(seed=9)
    heat_u8 = np.round(heat * 255.0).astype(np.uint8)
    tf, lf = heatmap.get_dynamic_thresholds(heat_u8.astype(np.float32) / 255.0, 0.6, 0.35)
    tu, lu = heatmap.get_dynamic_thresholds(heat_u8, 0.6, 0.35)
    assert abs(tf - tu) < 1e-6 and abs(lf - lu) < 1e-6


def test_build_failure_raises(monkeypatch, tmp_path):
    """A source that does not compile raises; nothing falls back to OpenCV."""
    bad = tmp_path / "craft_ops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("SURYA_TORCH_NATIVE_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _detect(_synthetic_heatmap(), True)
