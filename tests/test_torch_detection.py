"""The port's detection against the JAX package's, on the CPU in float32, on
shared weights (carried over with detection.loader.from_jax_params):

- the tiny EfficientViT's ``apply_heat`` at 896x896: within 1e-4 abs (fp32
  convolutions summed in other orders);
- ``DetectionPredictor`` with the blob hook and the C++ CRAFT op (the
  port's default; the JAX package's is the same source) on both sides, on a page
  of drawn text and on a 4096-px tall page (5 chunks): the same number of
  boxes, polygons within 1e-3, confidences within 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from surya_tpu import nn as jax_nn
from surya_tpu.detection import DetectionPredictor as JaxDetectionPredictor
from surya_tpu.models import efficientvit as jax_evit
from surya_tpu.settings import settings as jax_settings
from surya_tpu_torch import nn as pnn
from surya_tpu_torch.detection import DetectionPredictor
from surya_tpu_torch.detection.heatmap import get_detected_boxes
from surya_tpu_torch.detection.loader import TINY_DETECTOR, detection_config, from_jax_params
from surya_tpu_torch.models import efficientvit
from surya_tpu_torch.settings import settings

torch.set_num_threads(1)


@pytest.mark.parametrize("batch", [1, 2])
def test_apply_heat_matches_jax(batch):
    cfg = detection_config(tiny=True)
    jcfg = jax_evit.EfficientViTConfig(**TINY_DETECTOR)
    params = jax_evit.init_params(jcfg, jax.random.PRNGKey(3))
    # non-trivial folded norms and biases, so that every leaf matters
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32) * 0.01, params)
    model = from_jax_params(params, cfg, "cpu")
    x = rng.random((batch, 896, 896, 3), dtype=np.float32)
    ref = np.asarray(jax.jit(jax_evit.apply_heat, static_argnums=1)(params, jcfg, jnp.asarray(x)))
    with torch.inference_mode():
        out = model.apply_heat(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (batch, 224, 224, 2)
    assert np.abs(out - ref).max() < 1e-4


def test_load_jax_params_conv_layout():
    """HWIO conv kernels become OIHW; a missing or extra leaf raises."""
    conv = torch.nn.Conv2d(4, 6, 3, padding=1, groups=2, bias=True)
    key = jax.random.PRNGKey(0)
    p = jax.tree.map(np.asarray, jax_nn.conv2d_init(key, 4, 6, 3, groups=2))
    holder = torch.nn.Module()
    holder.c = conv
    pnn.load_jax_params(holder, {"c": p})
    x = np.random.default_rng(1).standard_normal((1, 5, 5, 4)).astype(np.float32)
    ref = np.asarray(jax_nn.conv2d(p, jnp.asarray(x), padding=1, groups=2))
    with torch.no_grad():
        out = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert np.abs(out - ref).max() < 1e-5
    with pytest.raises(KeyError):
        pnn.load_jax_params(holder, {"c": {"kernel": p["kernel"]}})
    with pytest.raises(KeyError):
        pnn.load_jax_params(holder, {"c": {**p, "extra": p["bias"]}})


def test_heatmap_boxes_synthetic():
    """CRAFT postprocess finds a synthetic blob with full confidence."""
    heat = np.zeros((200, 200), np.float32)
    heat[50:70, 20:180] = 0.9
    boxes = get_detected_boxes(heat)
    assert len(boxes) == 1
    assert boxes[0].bbox[0] <= 21 and boxes[0].bbox[2] >= 178
    assert boxes[0].confidence == 1.0


@pytest.fixture(scope="module")
def detectors():
    # a local checkpoint path that does not exist: random init, no download
    ref = JaxDetectionPredictor(checkpoint=os.devnull, tiny=True)
    jax_evit.install_blob_detector(ref)
    ours = DetectionPredictor(tiny=True, device="cpu", jax_params=jax.tree.map(np.asarray, ref.params))
    efficientvit.install_blob_detector(ours)
    return ref, ours


def _text_page():
    img = Image.new("RGB", (1024, 1024), "white")
    draw = ImageDraw.Draw(img)
    draw.text((10, 10), "Hello World", fill="black", font_size=72)
    for i in range(4):
        draw.text((30, 200 + 90 * i), f"Line {i}: the quick brown fox jumps.", fill="black", font_size=32)
    return img


def _tall_page():
    img = Image.new("RGB", (1200, 4096), "white")
    draw = ImageDraw.Draw(img)
    for i, y in enumerate([20, 880, 1700, 2700, 3990]):  # one line near a chunk seam at 896
        draw.text((40, y), f"tall page line {i}", fill="black", font_size=40)
    return img


def assert_same_detection(ours, ref):
    assert len(ours) == len(ref)
    for page, ref_page in zip(ours, ref):
        assert page.image_bbox == ref_page.image_bbox
        assert len(page.bboxes) == len(ref_page.bboxes)
        for box, ref_box in zip(page.bboxes, ref_page.bboxes):
            assert np.abs(np.asarray(box.polygon) - np.asarray(ref_box.polygon)).max() < 1e-3
            assert abs(box.confidence - ref_box.confidence) < 1e-4


@pytest.mark.parametrize("page", ["text", "tall", "both"])
def test_detection_predictor_matches_jax(detectors, page):
    ref, ours = detectors
    assert ours.config == detection_config(tiny=True)
    assert ref.config == jax_evit.EfficientViTConfig(**TINY_DETECTOR)  # the JAX loader's tiny config
    pages = {"text": [_text_page()], "tall": [_tall_page()], "both": [_text_page(), _tall_page(), _text_page()]}[page]
    old = jax_settings.USE_NATIVE_POSTPROCESS
    jax_settings.USE_NATIVE_POSTPROCESS = settings.USE_NATIVE_POSTPROCESS = True
    try:
        expected = ref([p.copy() for p in pages])
    finally:
        jax_settings.USE_NATIVE_POSTPROCESS = old
    got = ours([p.copy() for p in pages])
    assert all(len(r.bboxes) > 0 for r in got)
    assert_same_detection(got, expected)


def test_batch_size_setting_read_at_call_time(detectors):
    """DETECTOR_BATCH_SIZE, changed after construction, sets the batches of
    the next call; unset, the device's default does."""
    _, ours = detectors
    old = settings.DETECTOR_BATCH_SIZE
    try:
        settings.DETECTOR_BATCH_SIZE = 1
        assert ours.get_batch_size() == 1
        sizes = [len(sizes) for _, sizes in ours.batch_detection([_text_page(), _text_page()])]
        assert sizes == [1, 1]
        settings.DETECTOR_BATCH_SIZE = None
        assert ours.get_batch_size() == DetectionPredictor.default_batch_sizes["cpu"]
    finally:
        settings.DETECTOR_BATCH_SIZE = old


def test_detection_maps_match_jax(detectors):
    """include_maps: both channels come back as images of the stitched
    processor-size maps, within one uint8 level of the JAX package's (the
    heat is rounded to uint8 on both sides)."""
    ref, ours = detectors
    old = jax_settings.USE_NATIVE_POSTPROCESS
    jax_settings.USE_NATIVE_POSTPROCESS = settings.USE_NATIVE_POSTPROCESS = True
    try:
        [expected] = ref([_text_page()], include_maps=True)
    finally:
        jax_settings.USE_NATIVE_POSTPROCESS = old
    [got] = ours([_text_page()], include_maps=True)
    for ours_map, ref_map in ((got.heatmap, expected.heatmap), (got.affinity_map, expected.affinity_map)):
        a, b = np.asarray(ours_map, np.int16), np.asarray(ref_map, np.int16)
        assert a.shape == b.shape == (896, 896)  # the processor size
        assert np.abs(a - b).max() <= 1
    assert_same_detection([got], [expected])
