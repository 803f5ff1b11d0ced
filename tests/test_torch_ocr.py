"""Whole-page OCR of the port against the JAX package's, on the CPU in
float32, on shared weights: ``RecognitionPredictor(pages,
det_predictor=DetectionPredictor())`` with the blob hook on both detectors
and the C++ CRAFT op on both sides, with the int8 KV cache off and on. The same
pages must give the same text, polygons and decoded token counts, and
confidences within 1e-4."""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from surya_tpu.detection import DetectionPredictor as JaxDetectionPredictor
from surya_tpu.models import efficientvit as jax_evit
from surya_tpu.recognition import RecognitionPredictor as JaxRecognitionPredictor
from surya_tpu.settings import settings as jax_settings
from surya_tpu_torch.detection import DetectionPredictor
from surya_tpu_torch.models import efficientvit
from surya_tpu_torch.recognition import RecognitionPredictor
from surya_tpu_torch.settings import settings

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pipelines():
    # a local checkpoint path that does not exist: random init, no download
    jdet = JaxDetectionPredictor(checkpoint=os.devnull, tiny=True)
    jax_evit.install_blob_detector(jdet)
    jrec = JaxRecognitionPredictor(checkpoint=os.devnull, tiny=True)
    det = DetectionPredictor(tiny=True, device="cpu", jax_params=jax.tree.map(np.asarray, jdet.params))
    efficientvit.install_blob_detector(det)
    rec = RecognitionPredictor(tiny=True, device="cpu", jax_params=jax.tree.map(np.asarray, jrec.params))
    return (jdet, jrec), (det, rec)


def _pages(n):
    pages = []
    for p in range(n):
        img = Image.new("RGB", (640, 480), "white")
        d = ImageDraw.Draw(img)
        for i in range(3 + p):
            d.text((20, 30 + i * 60), f"page {p} line {i} sample text", fill="black", font_size=22 + 4 * i)
        pages.append(img)
    return pages


def _as_values(results):
    """Text, polygons, confidences and chars of every line, as plain values."""
    return [
        [(ln.text, ln.polygon, ln.confidence, [(c.text, c.polygon, c.confidence) for c in ln.chars])
         for ln in page.text_lines]
        for page in results
    ]


def _assert_same(ours, ref):
    assert len(ours) == len(ref)
    for page, ref_page in zip(_as_values(ours), _as_values(ref)):
        assert len(page) == len(ref_page)
        for (text, poly, conf, chars), (r_text, r_poly, r_conf, r_chars) in zip(page, ref_page):
            assert text == r_text and poly == r_poly
            assert abs(conf - r_conf) < 1e-4
            assert len(chars) == len(r_chars)
            for (c, c_poly, c_conf), (rc, rc_poly, rc_conf) in zip(chars, r_chars):
                assert c == rc and c_poly == rc_poly and abs(c_conf - rc_conf) < 1e-4


def _run_both(pipelines, pages, quantize, pin, highres=None, detection_batch_size=None):
    """The JAX and the port's whole-page OCR of the same pages, with the
    C++ CRAFT op on both sides. Returns the tokens decoded."""
    (jdet, jrec), (det, rec) = pipelines

    def call(pred, det_pred):
        return pred([p.copy() for p in pages], det_predictor=det_pred, detection_batch_size=detection_batch_size,
                    highres_images=None if highres is None else [p.copy() for p in highres])

    old =(jax_settings.USE_NATIVE_POSTPROCESS, jax_settings.RECOGNITION_MODEL_QUANTIZE,
           jax_settings.RECOGNITION_PIN_DECODE, settings.RECOGNITION_MODEL_QUANTIZE, settings.RECOGNITION_PIN_DECODE)
    jax_settings.USE_NATIVE_POSTPROCESS = settings.USE_NATIVE_POSTPROCESS = True
    jax_settings.RECOGNITION_MODEL_QUANTIZE = settings.RECOGNITION_MODEL_QUANTIZE = quantize
    jax_settings.RECOGNITION_PIN_DECODE = settings.RECOGNITION_PIN_DECODE = pin
    try:
        expected, got = call(jrec, jdet), call(rec, det)
    finally:
        (jax_settings.USE_NATIVE_POSTPROCESS, jax_settings.RECOGNITION_MODEL_QUANTIZE,
         jax_settings.RECOGNITION_PIN_DECODE, settings.RECOGNITION_MODEL_QUANTIZE,
         settings.RECOGNITION_PIN_DECODE) = old
    assert [len(p.text_lines) for p in got] == [3, 4]  # every drawn line is found
    _assert_same(got, expected)
    assert rec.last_decoded_tokens == jrec.last_decoded_tokens
    return rec.last_decoded_tokens


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("pin", [False, True])
def test_full_page_ocr_matches_jax(pipelines, quantize, pin):
    decoded = _run_both(pipelines, _pages(2), quantize, pin)
    if pin:
        assert decoded == settings.RECOGNITION_MAX_TOKENS * 7


def test_full_page_ocr_highres_matches_jax(pipelines):
    """Lines detected on the pages are sliced from the same pages at twice
    the size (polygons scaled to them), one page per detection batch."""
    pages = _pages(2)
    highres = [p.resize((2 * p.size[0], 2 * p.size[1]), Image.Resampling.BICUBIC) for p in pages]
    _run_both(pipelines, pages, quantize=True, pin=False, highres=highres, detection_batch_size=1)


def test_blank_pages_give_empty_results(pipelines):
    """A page where detection finds nothing still yields one empty result."""
    _, (det, rec) = pipelines
    pages = _pages(1) + [Image.new("RGB", (640, 480), "white")]
    results = rec(pages, det_predictor=det)
    assert [len(r.text_lines) for r in results] == [3, 0]
    assert [r.image_bbox for r in results] == [[0, 0, 640, 480]] * 2
    assert rec(pages[1:], det_predictor=det)[0].text_lines == []
