"""Whole-page OCR of the port against the JAX package's under bench.py's
workload, on the CPU in float32, on shared tiny weights, with the blob hook
on both detectors: pages of bench.py's ``build_page()`` (1240x1754, 40
lines at ``font_size=22``), ``RECOGNITION_MAX_TOKENS=40`` pinned, a 40-step
decode chunk and the bf16 (not int8) KV cache, set before the predictors are
built (both read the chunk at construction), through
``rec(pages, det_predictor=det)``.

Exact: the same polygons, the same token ids and text for every line, and
40 decoded tokens a line."""

import contextlib
import importlib.util
import os
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from surya_tpu.detection import DetectionPredictor as JaxDetectionPredictor
from surya_tpu.models import efficientvit as jax_evit
from surya_tpu.recognition import RecognitionPredictor as JaxRecognitionPredictor
from surya_tpu.settings import settings as jax_settings
from surya_tpu_torch.detection import DetectionPredictor
from surya_tpu_torch.models import efficientvit
from surya_tpu_torch.recognition import RecognitionPredictor
from surya_tpu_torch.settings import settings

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parent.parent / "bench.py"
PAGES = 2
# bench.py:50-57: every line decodes exactly this many tokens, in one chunk
PIN_TOKENS = 40
BENCH_SETTINGS = dict(RECOGNITION_MAX_TOKENS=PIN_TOKENS, RECOGNITION_PIN_DECODE=True,
                      RECOGNITION_DECODE_CHUNK=PIN_TOKENS, RECOGNITION_MODEL_QUANTIZE=False)


@pytest.fixture(scope="module", autouse=True)
def no_default_checkpoints():
    """Port predictors built with checkpoint=None resolve no s3:// default
    (no download): every *_MODEL_CHECKPOINT setting names a path that does
    not exist."""
    with pytest.MonkeyPatch.context() as mp:
        for name in [n for n in vars(settings) if n.endswith("_MODEL_CHECKPOINT")]:
            mp.setattr(settings, name, os.devnull)
        yield


@contextlib.contextmanager
def _both(**values):
    """Set fields of both packages' settings for the block."""
    old = [(s, k, getattr(s, k)) for s in (settings, jax_settings) for k in values]
    try:
        for s in (settings, jax_settings):
            for k, v in values.items():
                setattr(s, k, v)
        yield
    finally:
        for s, k, v in old:
            setattr(s, k, v)


@contextlib.contextmanager
def _tokens(pred):
    """Collect the token ids of every prediction_loop run of pred."""
    runs = []
    loop = pred.prediction_loop

    def recording(*args, **kwargs):
        out = loop(*args, **kwargs)
        runs.append([list(t) for t in out[0]])
        return out

    pred.prediction_loop = recording
    try:
        yield runs
    finally:
        del pred.prediction_loop


@pytest.fixture(scope="module")
def bench_module():
    """bench.py as a module; the environment its import sets is restored."""
    spec = importlib.util.spec_from_file_location("bench_under_test", BENCH)
    module = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ):
        spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def pipelines():
    """Both packages' tiny pipelines on shared weights, built under bench.py's
    settings, which stay set for the module's tests."""
    with _both(**BENCH_SETTINGS):
        jdet = JaxDetectionPredictor(checkpoint=os.devnull, tiny=True)
        jax_evit.install_blob_detector(jdet)
        jrec = JaxRecognitionPredictor(checkpoint=os.devnull, tiny=True)
        det = DetectionPredictor(tiny=True, device="cpu", jax_params=jax.tree.map(np.asarray, jdet.params))
        efficientvit.install_blob_detector(det)
        rec = RecognitionPredictor(tiny=True, device="cpu", jax_params=jax.tree.map(np.asarray, jrec.params))
        assert rec.decode_chunk == jrec.decode_chunk == PIN_TOKENS
        yield (jdet, jrec), (det, rec)


def test_build_page_is_bench_py_page(bench_module):
    """The port's copy of build_page() draws bench.py's page pixel for pixel."""
    ours, ref = np.asarray(chip_smoke.build_page()), np.asarray(bench_module.build_page())
    assert ours.shape == (1754, 1240, 3)
    assert np.array_equal(ours, ref)
    assert chip_smoke.BENCH_LINES == bench_module.LINES_PER_PAGE
    assert chip_smoke.PIN_TOKENS == bench_module.PIN_TOKENS_PER_LINE == PIN_TOKENS
    assert chip_smoke.BENCH_PAGES == bench_module.N_PAGES


@pytest.mark.parametrize("pipeline_pages", [0, 1], ids=["sequential", "streaming"])
def test_bench_workload_matches_jax(pipelines, pipeline_pages):
    """rec(pages, det_predictor=det) on bench.py's pages, sequential and
    through the streaming path that bench.py's 16 pages take (here a
    detection group of 1 page, so the second page joins the live run): the
    same polygons, token ids and text as the JAX package, every drawn line
    found, and 40 tokens decoded for each."""
    (jdet, jrec), (det, rec) = pipelines
    pages = [chip_smoke.build_page() for _ in range(PAGES)]
    with _both(RECOGNITION_DET_PIPELINE_PAGES=pipeline_pages), _tokens(rec) as ours, _tokens(jrec) as ref:
        got = rec([p.copy() for p in pages], det_predictor=det)
        expected = jrec([p.copy() for p in pages], det_predictor=jdet)
    assert [len(r.text_lines) for r in got] == [chip_smoke.BENCH_LINES] * PAGES
    assert [[ln.polygon for ln in r.text_lines] for r in got] == \
        [[ln.polygon for ln in r.text_lines] for r in expected]
    assert ours == ref
    assert sorted(len(t) for run in ours for t in run if t) == [PIN_TOKENS] * (chip_smoke.BENCH_LINES * PAGES)
    assert [[ln.text for ln in r.text_lines] for r in got] == [[ln.text for ln in r.text_lines] for r in expected]
    assert rec.last_decoded_tokens == jrec.last_decoded_tokens == PIN_TOKENS * chip_smoke.BENCH_LINES * PAGES
