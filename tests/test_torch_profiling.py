"""The port's spans and counters (common/profiling.py) on the CPU: counters
in the stage registry, the spans and counters of a recognition call and of
a layout call, the shared clock of the registry and torch.profiler, and
one trace a call with SURYA_PROFILE_DIR set."""

import gc
import json
import os
import sys
import threading
from collections import Counter, defaultdict

import pytest
import torch
from PIL import Image, ImageDraw

from surya_tpu_torch.common import profiling
from surya_tpu_torch.layout import LayoutPredictor
from surya_tpu_torch.recognition import RecognitionPredictor
from surya_tpu_torch.settings import settings

torch.set_num_threads(1)

# entered once a call
CALL_SPANS = ("recognition.call", "recognition.slice", "recognition.loop", "recognition.assemble",
              "recognition.detokenize")
# entered once a wave or a chunk, at least once a call
LOOP_SPANS = ("recognition.add_prompts", "recognition.build_wait", "recognition.seed_prefill",
              "recognition.process_decode", "recognition.wave_select")
COUNTERS = ("recognition.wave_patches", "recognition.wave_patch_cap", "recognition.decode_row_steps",
            "recognition.decode_tokens_kept", "recognition.assemble_chars", "recognition.assemble_runs")
LAYOUT_DISPATCH_SPANS = ("layout.prepare", "layout.enqueue", "layout.wait", "layout.assemble")
# spans of the recognition builder thread: a CPU profiler session records
# only the thread that started it
BUILDER_SPANS = {"recognition.wave_select", "recognition.prefill_build"}


@pytest.fixture(scope="module", autouse=True)
def no_default_checkpoints():
    """Port predictors built with checkpoint=None resolve no s3:// default
    (no download): every *_MODEL_CHECKPOINT setting names a path that does
    not exist."""
    with pytest.MonkeyPatch.context() as mp:
        for name in [n for n in vars(settings) if n.endswith("_MODEL_CHECKPOINT")]:
            mp.setattr(settings, name, os.devnull)
        mp.setattr(settings, "RECOGNITION_MAX_TOKENS", 12)
        yield


@pytest.fixture(scope="module")
def rec():
    return RecognitionPredictor(None, True, device="cpu")


@pytest.fixture(scope="module")
def lay():
    return LayoutPredictor(None, True, device="cpu")


def _pages(lines=(5, 7)):
    """Pages of drawn text lines and each line's box."""
    pages, boxes = [], []
    for n in lines:
        img = Image.new("RGB", (640, 480), "white")
        d = ImageDraw.Draw(img)
        boxes.append([])
        for i in range(n):
            d.text((20, 30 + i * 40), f"line {i} sample text", fill="black", font_size=22)
            boxes[-1].append([16, 26 + i * 40, 300, 56 + i * 40])
        pages.append(img)
    return pages, boxes


def _ocr(rec, lines=(5, 7)):
    pages, boxes = _pages(lines)
    rec(pages, bboxes=boxes)
    return sum(len(b) for b in boxes)


def test_count_accumulates_across_threads_and_reports_beside_stages():
    profiling.report()
    workers, adds = 16, 500
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(adds):
                profiling.count("c", 2)

        threads = [threading.Thread(target=work) for _ in range(workers)]
        with profiling.stage("s"):
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    got = profiling.report()
    assert got["c"] == {"count": 2 * workers * adds, "calls": workers * adds}
    assert got["s"]["calls"] == 1 and got["s"]["total_s"] > 0
    assert profiling.report() == {}  # report() cleared both


@pytest.mark.parametrize("first", ["stage", "count"])
def test_a_name_is_a_stage_or_a_counter_not_both(first):
    """The two kinds share report()'s keys, so a name taken by one kind is
    refused to the other until report() clears the registry."""
    profiling.report()
    try:
        if first == "stage":
            with profiling.stage("both"):
                pass
            with pytest.raises(ValueError, match="both"):
                profiling.count("both")
        else:
            profiling.count("both")
            with pytest.raises(ValueError, match="both"):
                with profiling.stage("both"):
                    pass
        assert set(profiling.report()) == {"both"}
        # cleared: the other kind may take the name now
        if first == "stage":
            profiling.count("both")
            assert profiling.report()["both"] == {"count": 1, "calls": 1}
        else:
            with profiling.stage("both"):
                pass
            assert profiling.report()["both"]["calls"] == 1
    finally:
        profiling.report()


def test_given_lines_ocr_reports_every_span_and_counter(rec):
    profiling.report()
    lines = _ocr(rec)
    got = profiling.report()
    for name in CALL_SPANS:
        assert got[name]["calls"] == 1, name
    for name in LOOP_SPANS + COUNTERS:
        assert name in got, name
    waves, chunks = got["recognition.wave_patches"]["calls"], got["recognition.decode_row_steps"]["calls"]
    assert waves >= 1 and chunks >= 1
    # never per line or per token: at most once a wave or a chunk
    assert got["recognition.seed_prefill"]["calls"] == got["recognition.wave_select"]["calls"] == waves
    assert got["recognition.wave_patch_cap"]["calls"] == waves
    assert got["recognition.process_decode"]["calls"] == got["recognition.decode_tokens_kept"]["calls"] == chunks
    assert got["recognition.add_prompts"]["calls"] == 1
    assert got["recognition.assemble_chars"]["calls"] == got["recognition.assemble_runs"]["calls"] == 1
    assert 0 < got["recognition.wave_patches"]["count"] <= got["recognition.wave_patch_cap"]["count"]
    # every prompt's token 0 comes from its wave, the rest from the chunks
    assert got["recognition.decode_tokens_kept"]["count"] + lines == rec.last_decoded_tokens
    assert got["recognition.decode_tokens_kept"]["count"] <= got["recognition.decode_row_steps"]["count"]


def test_layout_call_reports_each_span_once_a_dispatch(lay, monkeypatch):
    monkeypatch.setattr(settings, "LAYOUT_PIPELINE_BATCH", 1)
    pages, _ = _pages((2, 3, 4))
    profiling.report()
    lay(pages)
    got = profiling.report()
    dispatches = len(lay.last_run["tiles"])
    assert dispatches == len(pages)
    assert got["layout.call"]["calls"] == 1
    for name in LAYOUT_DISPATCH_SPANS:
        assert got[name]["calls"] == dispatches, name
    assert got["layout.enqueue"]["total_s"] == pytest.approx(lay.last_run["enqueue_s"], abs=1e-3)


def test_registry_spans_are_profiler_ranges_on_one_clock(rec):
    """Every span of an OCR call that the profiler's thread enters is a
    torch.profiler range, as often, and their durations agree. The
    collector is off meanwhile: a collection that falls between a span's
    clock and its range's end would add its pause to one side alone."""
    lines = (3, 4)
    _ocr(rec, lines)
    profiling.report()
    gc.disable()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _ocr(rec, lines)
    finally:
        gc.enable()
    report = profiling.report()
    assert report["recognition.wave_patches"]["calls"] == 1
    got = {name: v for name, v in report.items() if "total_s" in v}
    calls, seconds = Counter(), defaultdict(float)
    for ev in prof.events():
        if ev.name in got:
            calls[ev.name] += 1
            seconds[ev.name] += (ev.time_range.end - ev.time_range.start) / 1e6
    assert set(got) - set(calls) <= BUILDER_SPANS
    assert set(CALL_SPANS) | (set(LOOP_SPANS) - BUILDER_SPANS) <= set(calls)
    for name in calls:
        assert calls[name] == got[name]["calls"], name
        assert abs(seconds[name] - got[name]["total_s"]) <= max(0.05 * got[name]["total_s"], 1e-3), name


@pytest.mark.parametrize("kind", ["recognition", "layout"])
def test_profile_dir_writes_one_trace_a_call(rec, lay, kind, tmp_path, monkeypatch):
    call = {"recognition": lambda: _ocr(rec), "layout": lambda: lay(_pages()[0])}[kind]
    call()  # a warm-up before the variable is set
    monkeypatch.setenv("SURYA_PROFILE_DIR", str(tmp_path))
    profiling.report()
    call()
    got = profiling.report()
    traces = sorted(p.name for p in tmp_path.iterdir())
    assert len(traces) == 1 and traces[0].startswith(f"{kind}.call_"), traces
    names = {e.get("name") for e in json.loads((tmp_path / traces[0]).read_text())["traceEvents"]}
    stages = {name for name, v in got.items() if "total_s" in v}
    assert stages - BUILDER_SPANS <= names
