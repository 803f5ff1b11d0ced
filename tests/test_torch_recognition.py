"""The port's RecognitionPredictor against the JAX package's, end to end on
the CPU in float32, on shared weights (carried over with from_jax_params):
the same page and line boxes must give the same text, polygons and decoded
token counts, and confidences within 1e-4."""

import os

import jax
import numpy as np
import pytest
import torch

from surya_tpu.recognition import RecognitionPredictor as JaxPredictor
from surya_tpu.settings import settings as jax_settings
from surya_tpu_torch.recognition import RecognitionPredictor
from surya_tpu_torch.settings import settings

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def predictors():
    # a local checkpoint path that does not exist: random init, no download
    ref = JaxPredictor(checkpoint=os.devnull, tiny=True)
    ours = RecognitionPredictor(tiny=True, device="cpu", jax_params=jax.tree.map(np.asarray, ref.params))
    return ref, ours


def _assert_same(ours, ref):
    assert len(ours) == len(ref)
    for page, ref_page in zip(ours, ref):
        assert page.image_bbox == ref_page.image_bbox
        assert len(page.text_lines) == len(ref_page.text_lines)
        for line, ref_line in zip(page.text_lines, ref_page.text_lines):
            assert line.text == ref_line.text
            assert line.polygon == ref_line.polygon
            assert abs(line.confidence - ref_line.confidence) < 1e-4
            assert len(line.chars) == len(ref_line.chars)
            for ch, ref_ch in zip(line.chars, ref_line.chars):
                assert ch.text == ref_ch.text and ch.polygon == ref_ch.polygon
                assert abs(ch.confidence - ref_ch.confidence) < 1e-4


MANY_LINES = [[[5, 5 + 30 * i, 200 + 40 * (i % 3), 30 + 30 * i] for i in range(10)]]
CASES = {
    # 3 lines fit the slots at once
    "one_wave": dict(bboxes=[[[10, 5, 300, 60], [10, 200, 400, 240], [10, 260, 300, 300]]]),
    # 10 lines through 4 slots: queue, waves and slot reuse
    "more_lines_than_slots": dict(bboxes=MANY_LINES, recognition_batch_size=4),
    # RECOGNITION_PIN_DECODE: every line decodes exactly its budget
    "pinned": dict(bboxes=MANY_LINES, recognition_batch_size=4),
    # polygon crops, one of them degenerate (a blank stands in for it)
    "polygons": dict(polygons=[[[[5, 5], [300, 8], [298, 60], [4, 58]], [[5, 5]] * 4,
                                [[10, 200], [400, 200], [400, 240], [10, 240]]]]),
    # two pages, two tasks, input text, no math
    "two_pages_tasks_text": dict(
        pages=2, bboxes=[[[10, 5, 300, 60]], [[10, 200, 400, 240], [10, 260, 300, 300]]],
        task_names=["ocr_with_boxes", "ocr_without_boxes"], input_text=[["Hi"], [None, "a b"]],
        math_mode=False,
    ),
}


@pytest.mark.parametrize("case", list(CASES))
def test_recognition_matches_jax(predictors, test_image, case):
    ref, ours = predictors
    kwargs = dict(CASES[case])
    pages = [test_image] * kwargs.pop("pages", 1)
    pin = case == "pinned"
    old = jax_settings.RECOGNITION_PIN_DECODE, settings.RECOGNITION_PIN_DECODE
    jax_settings.RECOGNITION_PIN_DECODE = settings.RECOGNITION_PIN_DECODE = pin
    try:
        expected = ref(pages, **kwargs)
        got = ours(pages, **kwargs)
    finally:
        jax_settings.RECOGNITION_PIN_DECODE, settings.RECOGNITION_PIN_DECODE = old
    _assert_same(got, expected)
    assert ours.last_decoded_tokens == ref.last_decoded_tokens
    if pin:
        assert ours.last_decoded_tokens == settings.RECOGNITION_MAX_TOKENS * len(MANY_LINES[0])
