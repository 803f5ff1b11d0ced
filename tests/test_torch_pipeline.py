"""The port's pipelined recognition against its own sequential path and
against the JAX package's, on the CPU in float32, on shared weights, with
the blob hook on both detectors: the streaming det->rec path above
RECOGNITION_DET_PIPELINE_PAGES (with an empty group, a feeder and
leftovers), ``stream()`` (in order, equal to the batch call, the error path,
backpressure and early close), fused prefill+decode, drain-first, the held
wave and the grayscale patch ship.

Exact: the token ids of every prompt equal the JAX package's on the same
path, and lines, polygons and confidences equal between the port's paths
(in float32 the tokens do not depend on how prompts are grouped in waves;
confidences within 1e-5 relative)."""

import contextlib
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from surya_tpu.detection import DetectionPredictor as JaxDetectionPredictor
from surya_tpu.models import efficientvit as jax_evit
from surya_tpu.recognition import FEED_DONE as JAX_FEED_DONE
from surya_tpu.recognition import RecognitionPredictor as JaxRecognitionPredictor
from surya_tpu.settings import settings as jax_settings
from surya_tpu_torch.detection import DetectionPredictor
from surya_tpu_torch.models import efficientvit
from surya_tpu_torch.recognition import FEED_DONE, RecognitionPredictor
from surya_tpu_torch.settings import settings

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def no_default_checkpoints():
    """Port predictors built with checkpoint=None resolve no s3:// default
    (no download): every *_MODEL_CHECKPOINT setting names a path that does
    not exist."""
    from surya_tpu_torch.settings import settings as port_settings

    with pytest.MonkeyPatch.context() as mp:
        for name in [n for n in vars(port_settings) if n.endswith("_MODEL_CHECKPOINT")]:
            mp.setattr(port_settings, name, os.devnull)
        yield


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


def _pages(n):
    pages = []
    for p in range(n):
        img = Image.new("RGB", (640, 360), "white")
        d = ImageDraw.Draw(img)
        for i in range(3):
            d.text((20, 30 + i * 70), f"page {p} line {i} sample text", fill="black", font_size=24)
        pages.append(img)
    return pages


def _flatten(results):
    return [[(ln.text, tuple(np.asarray(ln.polygon).round(2).ravel().tolist())) for ln in r.text_lines]
            for r in results]


def _assert_same(ours, ref):
    """Equal texts and polygons; confidences within 1e-5 relative (a score
    is a softmax over a wave's rows: another wave may round its sums
    otherwise)."""
    assert _flatten(ours) == _flatten(ref)
    conf = [[ln.confidence for ln in r.text_lines] for r in ours]
    ref_conf = [[ln.confidence for ln in r.text_lines] for r in ref]
    for c, rc in zip(conf, ref_conf):
        np.testing.assert_allclose(c, rc, rtol=1e-5)


def _fake_detect(pages, per_page, poly=((5, 5), (200, 5), (200, 40), (5, 40))):
    """A detect_and_slice_bboxes that returns given crops for given pages."""
    page_idx = {id(p): i for i, p in enumerate(pages)}

    def detect(images, task_names, det_predictor, detection_batch_size=None, highres_images=None):
        flat = {k: [] for k in ("slices", "slice_map", "polygons", "task_names", "input_text", "res_scales")}
        for img, task in zip(images, task_names):
            s = per_page[page_idx[id(img)]]
            flat["slice_map"].append(len(s))
            flat["slices"].extend(a.copy() for a in s)
            flat["polygons"].extend([[list(q) for q in poly]] * len(s))
            flat["task_names"].extend([task] * len(s))
            flat["input_text"].extend([None] * len(s))
            flat["res_scales"].extend([(1, 1)] * len(s))
        return flat

    return detect


def test_pipelined_matches_sequential_and_jax(pipelines):
    """5 pages in groups of 2: the streaming path gives the sequential
    path's results, and the JAX package's token ids on the same path."""
    (jdet, jrec), (det, rec) = pipelines
    pages = _pages(5)
    with _both(RECOGNITION_MAX_TOKENS=8, RECOGNITION_DET_PIPELINE_PAGES=0):
        seq = rec([p.copy() for p in pages], det_predictor=det)
    with _both(RECOGNITION_MAX_TOKENS=8, RECOGNITION_DET_PIPELINE_PAGES=2):
        with _tokens(rec) as ours, _tokens(jrec) as ref:
            piped = rec([p.copy() for p in pages], det_predictor=det)
            expected = jrec([p.copy() for p in pages], det_predictor=jdet)
    assert len(piped) == len(seq) == len(pages)
    assert all(len(r.text_lines) == 3 for r in piped)
    _assert_same(piped, seq)
    assert ours == ref and len(ours) == 1 and len(ours[0]) == 15
    assert [[ln.text for ln in r.text_lines] for r in piped] == [[ln.text for ln in r.text_lines] for r in expected]


def test_pipeline_empty_group(pipelines):
    """A page group where detection finds nothing yields empty results for
    its pages and does not shorten the list."""
    _, (det, rec) = pipelines
    pages = _pages(3) + [Image.new("RGB", (640, 360), "white") for _ in range(2)]
    with _both(RECOGNITION_MAX_TOKENS=8, RECOGNITION_DET_PIPELINE_PAGES=3):
        piped = rec([p.copy() for p in pages], det_predictor=det)
    assert [len(r.text_lines) for r in piped] == [3, 3, 3, 0, 0]


def test_all_blank_pages_same_shape_both_paths(pipelines):
    _, (det, rec) = pipelines
    pages = [Image.new("RGB", (640, 360), "white") for _ in range(3)]
    out = []
    for g in (0, 2):
        with _both(RECOGNITION_DET_PIPELINE_PAGES=g):
            out.append(rec([p.copy() for p in pages], det_predictor=det))
    assert [len(r) for r in out] == [3, 3]
    assert all(r.text_lines == [] and r.image_bbox == [0, 0, 640, 360] for r in out[0] + out[1])


def _feeder_case(pred, feed_done):
    rng = np.random.default_rng(0)
    small = (rng.random((20, 80, 3)) * 255).astype(np.uint8)
    big = (rng.random((600, 2000, 3)) * 255).astype(np.uint8)  # its bound overflows the small-prompt cache
    flat1 = {"slices": [small], "input_text": [None], "task_names": ["ocr_with_boxes"]}
    flat2 = {"slices": [big, small.copy()], "input_text": [None, None], "task_names": ["ocr_with_boxes"] * 2}
    sent = []

    def feeder(block):
        if sent:
            return feed_done
        sent.append(True)
        return flat2

    leftovers = []
    toks, bbox_arr, _ = pred.prediction_loop(flat1, math_mode=True, feeder=feeder, leftover_sink=leftovers)
    return toks, bbox_arr, [p.id for p in leftovers]


def test_streaming_feeder_and_leftovers(pipelines):
    """prediction_loop with a feeder: a later group joins the live run, and a
    prompt whose bound exceeds the first group's cache goes to the leftover
    sink (empty in the main run); token ids as the JAX package's."""
    (_, jrec), (_, rec) = pipelines
    with _both(RECOGNITION_MAX_TOKENS=8):
        toks, bbox_arr, left = _feeder_case(rec, FEED_DONE)
        jtoks, _, jleft = _feeder_case(jrec, JAX_FEED_DONE)
    assert len(toks) == 3 == bbox_arr.shape[0]
    assert left == jleft == [1]
    assert toks[1] == [] and len(toks[0]) > 0 and len(toks[2]) > 0
    assert toks == [list(t) for t in jtoks]


def test_streaming_call_splices_leftovers(pipelines, monkeypatch):
    """The streaming path with a leftover: the follow-up loop's outputs are
    spliced back by id, equal to the sequential path's line for line and to
    the JAX package's token ids."""
    (_, jrec), (_, rec) = pipelines
    rng = np.random.default_rng(1)
    pages = [Image.new("RGB", (640, 360), "white") for _ in range(4)]
    shapes = [(20, 80), (20, 120), (600, 2000), (20, 80)]  # the third is a leftover
    per_page = [[(rng.random((h, w, 3)) * 255).astype(np.uint8)] for h, w in shapes]
    for pred in (rec, jrec):
        monkeypatch.setattr(pred, "detect_and_slice_bboxes", _fake_detect(pages, per_page))
    with _both(RECOGNITION_MAX_TOKENS=8, RECOGNITION_DET_PIPELINE_PAGES=0):
        seq = rec(pages, det_predictor=object())
    with _both(RECOGNITION_MAX_TOKENS=8, RECOGNITION_DET_PIPELINE_PAGES=2):
        with _tokens(rec) as ours, _tokens(jrec) as ref:
            piped = rec(pages, det_predictor=object())
            jrec(pages, det_predictor=object())
    _assert_same(piped, seq)
    assert all(len(r.text_lines) == 1 for r in piped)
    assert len(ours) == 2 and ours == ref  # the main run, then the leftover's


def test_stream_matches_batch_and_jax(pipelines):
    """stream() yields (index, OCRResult) in input order, each equal to the
    batch call's, from a generator with a blank page in the middle; the
    token ids equal those of the JAX package's stream()."""
    (jdet, jrec), (det, rec) = pipelines
    pages = _pages(4)
    pages.insert(2, Image.new("RGB", (640, 360), "white"))
    with _both(RECOGNITION_MAX_TOKENS=8, RECOGNITION_DET_PIPELINE_PAGES=0):
        batch = rec([p.copy() for p in pages], det_predictor=det)
        with _tokens(rec) as ours, _tokens(jrec) as ref:
            streamed = list(rec.stream((p.copy() for p in pages), det, group_pages=2))
            expected = list(jrec.stream((p.copy() for p in pages), jdet, group_pages=2))
    assert [i for i, _ in streamed] == list(range(len(pages)))
    _assert_same([r for _, r in streamed], batch)
    assert len(streamed[2][1].text_lines) == 0
    assert ours == ref
    assert [[ln.text for ln in r.text_lines] for _, r in streamed] == \
        [[ln.text for ln in r.text_lines] for _, r in expected]


def test_stream_mixed_task_leftovers(pipelines, monkeypatch):
    """A later group's prompt whose bound exceeds the stream's cache bound
    runs in the follow-up at the stream's end; pages still come in order."""
    _, (det, rec) = pipelines
    rng = np.random.default_rng(3)
    pages = [Image.new("RGB", (640, 360), "white") for _ in range(4)]
    small = (rng.random((20, 80, 3)) * 255).astype(np.uint8)
    big = (rng.random((600, 2000, 3)) * 255).astype(np.uint8)
    monkeypatch.setattr(rec, "detect_and_slice_bboxes",
                        _fake_detect(pages, [[small], [small.copy()], [big], [small.copy()]]))
    bound = rec.processor.prompt_len_bound

    def small_bound(shape, img_size, task, text, math_mode):  # pretend the task's budget image is tiny
        return bound(small.shape if shape == (img_size[1], img_size[0], 3) else shape, img_size, task, text,
                     math_mode)

    monkeypatch.setattr(rec.processor, "prompt_len_bound", small_bound)
    with _both(RECOGNITION_MAX_TOKENS=8):
        streamed = list(rec.stream(iter(pages), det, group_pages=2))
    assert [i for i, _ in streamed] == [0, 1, 2, 3]
    assert all(len(r.text_lines) == 1 and isinstance(r.text_lines[0].text, str) for _, r in streamed)


def test_stream_error_yields_completed_pages(pipelines):
    """A mid-stream failure still yields every page completed before it, in
    order and equal to the batch call's, then raises the error itself."""
    _, (det, rec) = pipelines
    pages = _pages(4)
    group1_consumed = threading.Event()
    calls = []

    class Boom(RuntimeError):
        pass

    def failing_det(images, batch_size=None):
        """Detects the first group; the second raises once the consumer has it."""
        calls.append(len(images))
        if len(calls) >= 2:
            group1_consumed.wait(60)
            raise Boom("detector died")
        return det(images, batch_size=batch_size)

    got = []
    try:
        with _both(RECOGNITION_MAX_TOKENS=8, RECOGNITION_DET_PIPELINE_PAGES=0):
            with pytest.raises(Boom):
                for i, res in rec.stream(iter(pages), failing_det, group_pages=2):
                    got.append((i, res))
                    if len(got) == 2:
                        group1_consumed.set()
            batch = rec([p.copy() for p in pages[:2]], det_predictor=det)
    finally:
        group1_consumed.set()
    assert [i for i, _ in got] == [0, 1]
    _assert_same([r for _, r in got], batch)


def test_stream_backpressure_and_close(pipelines):
    """With a slow consumer the feeder stops pulling once the finished but
    unconsumed pages reach RECOGNITION_STREAM_BUFFER_PAGES, and closing the
    generator stops the pull at the next wave boundary."""
    _, (det, rec) = pipelines
    template = _pages(1)[0]
    pulled = []

    def endless():
        while True:
            pulled.append(1)
            yield template.copy()

    CONSUME, BUF = 3, 3
    with _both(RECOGNITION_MAX_TOKENS=8, RECOGNITION_STREAM_BUFFER_PAGES=BUF):
        stream = rec.stream(endless(), det, group_pages=1)
        got = [next(stream) for _ in range(CONSUME)]
        # consumed + buffer + the current group + one detection group ahead,
        # and one group of slack for a pull under way
        assert len(pulled) <= CONSUME + BUF + 3, len(pulled)
        stream.close()
        time.sleep(1.0)
        settled = len(pulled)
        time.sleep(1.0)
        assert len(pulled) == settled
    assert [i for i, _ in got] == list(range(CONSUME))
    assert all(len(r.text_lines) > 0 for _, r in got)


def _counting(pred, monkeypatch):
    counts = {"prefill": 0, "decode": 0}
    for kind in counts:
        fn = getattr(pred, f"_dispatch_{kind}")

        def counted(*args, _fn=fn, _kind=kind, **kwargs):
            counts[_kind] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(pred, f"_dispatch_{kind}", counted)
    return counts


@pytest.fixture()
def small_slots(pipelines):
    """The port's recognizer with 4 slots and prefill rows of 2, as the JAX
    package's test_fused_prefill sets its own."""
    _, (_, rec) = pipelines
    old = (rec.n_slots, rec.prefill_rows, rec.prefill_row_buckets, rec.patch_caps, rec.patch_cap)
    rec.n_slots, rec.prefill_rows, rec.prefill_row_buckets = 4, 2, (2, 4)
    rec.patch_caps, rec.patch_cap = (1024, 4096), 4096
    yield rec
    rec.n_slots, rec.prefill_rows, rec.prefill_row_buckets, rec.patch_caps, rec.patch_cap = old


def _lines_page():
    img = Image.new("RGB", (512, 512), "white")
    d = ImageDraw.Draw(img)
    for i in range(6):
        d.text((10, 10 + i * 60), f"line {i} text", fill="black", font_size=24)
    return img, [[[5, 5 + i * 60, 300, 50 + i * 60] for i in range(6)]]


def test_fused_equals_unfused(small_slots, monkeypatch):
    """Fused prefill+decode gives the unfused outputs (tests/test_fused_prefill.py)
    and saves decode dispatches."""
    rec = small_slots
    img, bboxes = _lines_page()
    counts = _counting(rec, monkeypatch)
    fused = rec([img], bboxes=bboxes, recognition_batch_size=4)
    fused_counts = dict(counts)
    counts.update(prefill=0, decode=0)
    monkeypatch.setattr(rec, "fuse_decode", False)
    unfused = rec([img], bboxes=bboxes, recognition_batch_size=4)
    _assert_same(fused, unfused)
    assert [[c.polygon for c in ln.chars] for ln in fused[0].text_lines] == \
        [[c.polygon for c in ln.chars] for ln in unfused[0].text_lines]
    assert fused_counts["prefill"] == counts["prefill"]
    assert fused_counts["decode"] < counts["decode"]


def test_drain_first_sends_no_wasted_chunk(small_slots, monkeypatch):
    """One wave under a budget the fused chunk already exhausts: the loop
    drains instead of sending a decode chunk (pinned: exactly the budget)."""
    rec = small_slots
    img, bboxes = _lines_page()
    counts = _counting(rec, monkeypatch)
    with _both(RECOGNITION_PIN_DECODE=True, RECOGNITION_MAX_TOKENS=8):
        rec([img], bboxes=[bboxes[0][:2]], recognition_batch_size=4)
    assert counts == {"prefill": 1, "decode": 0}
    assert rec.last_decoded_tokens == 2 * 8


def test_held_wave_multi_chunk(small_slots):
    """Waves that need several decode chunks: wave 2 is built while wave 1
    decodes and then held for its slots; the results equal a run of wider
    waves line for line (tests/test_recognition.py:67)."""
    rec = small_slots
    img, _ = _lines_page()
    bboxes = [[[5, 5 + 30 * i, 200, 30 + 30 * i] for i in range(6)]]
    old_chunk = rec.decode_chunk
    rec.decode_chunk = 4
    try:
        with _both(RECOGNITION_MAX_TOKENS=12):  # 3 chunks a wave
            multi = rec([img], bboxes=bboxes, recognition_batch_size=2)
            single = rec([img], bboxes=bboxes)
    finally:
        rec.decode_chunk = old_chunk
    assert len(multi[0].text_lines) == 6
    _assert_same(multi, single)


def test_grayscale_patch_ship_matches_rgb(small_slots, monkeypatch):
    """Gray crops ship one channel third of each patch row, tiled back on the
    device: tokens and scores equal the three-channel ship
    (tests/test_recognition.py:131)."""
    rec = small_slots
    img, bboxes = _lines_page()
    shipped = []
    build = rec.processor.build_prefill_batch

    def recording(*args, **kwargs):
        batch = build(*args, **kwargs)
        shipped.append(batch.patches.shape[-1])
        return batch

    monkeypatch.setattr(rec.processor, "build_prefill_batch", recording)
    with _both(RECOGNITION_GRAYSCALE_SHIP=None):
        gray = rec([img], bboxes=bboxes)
    with _both(RECOGNITION_GRAYSCALE_SHIP=False):
        rgb = rec([img], bboxes=bboxes)
    p2 = rec.processor.patch_size ** 2
    assert set(shipped) == {p2, 3 * p2}
    _assert_same(gray, rgb)
