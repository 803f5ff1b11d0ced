"""Where the time of chip_smoke.py's workloads goes, on one NVIDIA GPU.

    python3 profile_smoke.py

Drives the workloads of chip_smoke.py at production widths with random bf16
weights: recognition of given line boxes (4 synthetic pages x 8 lines,
RecognitionPredictor, bf16 KV cache), pinned to 40 tokens per line and with
free-running stops; whole-page OCR (DetectionPredictor then
RecognitionPredictor, int8 KV cache, pinned) of 8 synthetic pages x 16 lines
(one detection group: detection, then recognition) and of 16 such pages, the
north star's shape (two groups of 8: detection of the second runs in a
worker thread while the first is recognized); layout of chip_smoke.py's 16
pages of 1240x1754 at full width, as called and cap-bound (every row decodes
its 100 steps), and table recognition of its 4 synthetic 14 x 8 tables. For
each mode it prints:

- untraced: the wall of REPS runs, each split by timers that add no
  synchronisation (the pipelined scheduler reads a dispatch's outputs on an
  event while the next one runs): recognition's host time enqueueing its
  dispatches (waves, chunks), its waits for their outputs, and the rest of
  its host time; for whole-page OCR also the detection calls' wall (in the
  streaming run it overlaps recognition) and their waits for the device;
  for layout and table rec the host time enqueueing the box loops (event
  waits of the all-done check included) and the waits for their outputs;
- traced, one more run under torch.profiler: that run's own wall, the
  device's busy time in it (the union of kernel, copy and memset intervals),
  the number of kernels, device time by kind and the largest kernels.

Busy time is set only against the traced run's wall, never against an
untraced one. The last line is one JSON object holding every number.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

if not torch.cuda.is_available():
    raise SystemExit("profile_smoke.py: no CUDA device; this script runs only on the GPU")
# random weights, and no default s3:// checkpoint resolved or fetched (the
# port's settings are read when it is first imported, by chip_smoke below)
os.environ.setdefault("ALLOW_RANDOM_WEIGHTS", "true")
os.environ.setdefault("DISABLE_TQDM", "true")
for _name in ("DETECTOR", "RECOGNITION", "LAYOUT", "TABLE_REC", "OCR_ERROR"):
    os.environ[f"{_name}_MODEL_CHECKPOINT"] = os.devnull

import chip_smoke  # noqa: E402
from surya_tpu_torch.detection import DetectionPredictor  # noqa: E402
from surya_tpu_torch.layout import LayoutPredictor  # noqa: E402
from surya_tpu_torch.models.efficientvit import install_blob_detector  # noqa: E402
from surya_tpu_torch.recognition import RecognitionPredictor  # noqa: E402
from surya_tpu_torch.settings import settings  # noqa: E402
from surya_tpu_torch.table_rec import TableRecPredictor, install_synthetic_tables  # noqa: E402

REPS = 3
TOP = 10
# device-time kinds, matched in order against the lower-cased kernel name
KINDS = (
    ("K1 segmented_block_attention", ("segmented_attention_kernel",)),
    ("K2 causal_flash_attention", ("causal_attention_kernel",)),
    ("K3q gqa_decode, int8 cache", ("gqa_decode_kernel<128, 3, true>", "gqa_decode_kernelili128eli3elb1e")),
    ("K3 gqa_decode", ("gqa_decode_kernel",)),
    ("convolutions (cuDNN)", ("conv", "fprop", "wgrad", "dgrad")),
    ("GEMM (cuBLAS/CUTLASS)", ("gemm", "cutlass", "xmma", "cublas", "nvjet")),
    ("copies, memsets, index ops", ("memcpy", "memset", "copy", "index", "gather", "scatter")),
    ("elementwise and reductions", ("elementwise", "reduce")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals, in us."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def time_calls(obj, names, stats, prefix=""):
    """Wrap the methods `names` of a predictor with wall timers (the times
    are kept under prefix + name)."""
    for name in names:
        def timed(*args, _fn=getattr(obj, name), _name=prefix + name, **kwargs):
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            stats[_name].append(time.perf_counter() - t0)
            return out

        setattr(obj, name, timed)


def untraced(run, stats):
    """REPS runs of `run()` -> (wall, detection calls' walls, tokens), each
    split by the timed calls. Recognition runs from the end of the first
    detection call to the end of the run."""
    runs = []
    for _ in range(REPS):
        stats.clear()
        wall, det_calls, toks = run()
        prefill, decode = sum(stats["_dispatch_prefill"]), sum(stats["_dispatch_decode"])
        waits = sum(stats["_wait"])
        rec_wall = wall - (det_calls[0] if det_calls else 0.0)
        r = {"wall_s": wall, "tokens": toks, "recognition_s": rec_wall,
             "prefill_enqueue_s": prefill, "waves": len(stats["_dispatch_prefill"]),
             "decode_enqueue_s": decode, "chunks": len(stats["_dispatch_decode"]),
             "recognition_wait_s": waits, "recognition_host_rest_s": rec_wall - prefill - decode - waits}
        if det_calls:
            det_waits = sum(stats["det._wait"])
            r.update(detection_s=sum(det_calls), detection_calls=len(det_calls), detection_wait_s=det_waits,
                     detection_host_s=sum(det_calls) - det_waits)
        runs.append(r)
    return runs


def traced(run):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall, _, toks = run()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise RuntimeError("torch.profiler recorded no device events")
    by_kind, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in dev:
        dur = e.time_range.end - e.time_range.start
        by_kind[kind_of(e.name)] += dur
        by_name[e.name][0] += dur
        by_name[e.name][1] += 1
    total = sum(by_kind.values())
    busy = busy_us((e.time_range.start, e.time_range.end) for e in dev)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "wall_s": wall, "tokens": toks, "device_busy_s": busy / 1e6, "busy_share": busy / 1e6 / wall,
        "device_events": len(dev), "device_time_s": total / 1e6,
        "by_kind": {k: {"s": v / 1e6, "share": v / total} for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])},
        "top": [{"name": n, "s": t / 1e6, "calls": c} for n, (t, c) in top],
    }


def box_loop_modes():
    """(label, run) of the layout and table-rec modes; a run returns (wall,
    [], AR steps run) and keeps its enqueue and wait split in SPLITS."""
    lay = LayoutPredictor(device="cuda")
    tab = TableRecPredictor(device="cuda")
    install_synthetic_tables(tab, chip_smoke.TABLE_ROWS, chip_smoke.TABLE_COLS, chip_smoke.TABLE_CELLS)
    pages = chip_smoke.bench_pages(chip_smoke.LAYOUT_PAGES)
    crops = [p.crop((100, 100, 868, 868)) for p in pages[: chip_smoke.TABLE_CROPS]]
    as_called = lay.config
    capped = dataclasses.replace(as_called, eos_token_id=-1, pad_token_id=-1)
    waits = defaultdict(list)
    time_calls(lay, ("_wait",), waits, prefix="lay.")
    time_calls(tab, ("_wait",), waits, prefix="tab.")

    def layout(config):
        lay.model.config = config
        try:
            waits.clear()
            _, wall = chip_smoke.synchronised(lay, pages)
        finally:
            lay.model.config = as_called
        run = lay.last_run
        SPLITS.append({"wall_s": wall, "enqueue_s": run["enqueue_s"], "wait_s": sum(waits["lay._wait"]),
                       "steps": run["steps"], "host_syncs": run["host_syncs"]})
        return wall, [], sum(run["steps"])

    def tables():
        waits.clear()
        _, wall = chip_smoke.synchronised(tab, crops)
        passes = tab.last_run["passes"]
        SPLITS.append({"wall_s": wall, "enqueue_s": sum(p["enqueue_s"] for p in passes),
                       "wait_s": sum(waits["tab._wait"]), "steps": [p["steps"] for p in passes],
                       "host_syncs": [p["host_syncs"] for p in passes]})
        return wall, [], sum(p["steps"] for p in passes)

    return [("layout 16 pages, as called", lambda: layout(as_called)),
            ("layout 16 pages, cap-bound", lambda: layout(capped)),
            ("table rec 4 synthetic tables", tables)]


SPLITS: list = []


def main():
    power = chip_smoke.card()
    print(f"card: {power}")
    pred = RecognitionPredictor(device="cuda")
    det = DetectionPredictor(device="cuda")
    install_blob_detector(det)
    pages, bboxes = chip_smoke.synthetic_pages(np.random.default_rng(chip_smoke.SEED))
    ocr_pages = chip_smoke.synthetic_full_pages(np.random.default_rng(chip_smoke.SEED + 1))
    north_pages = chip_smoke.synthetic_full_pages(np.random.default_rng(chip_smoke.SEED + 2),
                                                  chip_smoke.NORTH_STAR_PAGES)
    stats = defaultdict(list)
    time_calls(pred, ("_dispatch_prefill", "_dispatch_decode", "_wait"), stats)
    time_calls(det, ("_wait",), stats, prefix="det.")

    def given_lines(pin):
        wall, _, toks = chip_smoke.run_predictor(pred, pages, bboxes, pin=pin)
        return wall, [], toks

    def whole_page(page_set):
        chip_smoke.set_pin(True)
        settings.RECOGNITION_MODEL_QUANTIZE = True
        try:
            _, wall, det_calls, tokens = chip_smoke.run_pages(pred, det, page_set, chip_smoke.PIPELINE_PAGES)
        finally:
            settings.RECOGNITION_MODEL_QUANTIZE = False
        return wall, det_calls, sum(len(t) for t in tokens)

    report = {"card": power}
    for label, run in [("pinned", lambda: given_lines(True)), ("free-running", lambda: given_lines(False)),
                       ("whole-page 8 pages pinned, int8 cache", lambda: whole_page(ocr_pages)),
                       ("whole-page 16 pages streaming pinned, int8 cache", lambda: whole_page(north_pages))]:
        run()  # warm-up at this mode's shapes
        runs = untraced(run, stats)
        trace = traced(run)
        report[label] = {"untraced": runs, "traced": trace}
        print(f"[{label}] {runs[0]['tokens']} tokens [{power}]")
        for r in runs:
            det_part = (f"; detection {r['detection_s']:.4f} s in {r['detection_calls']} calls = waits "
                        f"{r['detection_wait_s']:.4f} s + host {r['detection_host_s']:.4f} s"
                        if "detection_s" in r else "")
            print(f"  untraced: wall {r['wall_s']:.4f} s; recognition {r['recognition_s']:.4f} s = enqueue "
                  f"{r['prefill_enqueue_s']:.4f} s ({r['waves']} waves) + {r['decode_enqueue_s']:.4f} s "
                  f"({r['chunks']} chunks) + waits {r['recognition_wait_s']:.4f} s + other host "
                  f"{r['recognition_host_rest_s']:.4f} s{det_part}")
        print(f"  traced: wall {trace['wall_s']:.4f} s, device busy {trace['device_busy_s']:.4f} s "
              f"({trace['busy_share']:.1%} of that wall), {trace['device_events']} device events")
        for k, v in trace["by_kind"].items():
            print(f"    {v['share']:6.1%} {v['s'] * 1e3:9.3f} ms  {k}")
        for t in trace["top"]:
            print(f"    top: {t['s'] * 1e3:9.3f} ms {t['calls']:6d} calls  {t['name'][:110]}")
    for label, run in box_loop_modes():
        run()  # warm-up
        SPLITS.clear()
        for _ in range(REPS):
            run()
        runs = list(SPLITS)
        trace = traced(run)
        report[label] = {"untraced": runs, "traced": trace}
        print(f"[{label}] AR steps {runs[0]['steps']}, host syncs {runs[0]['host_syncs']} [{power}]")
        for r in runs:
            print(f"  untraced: wall {r['wall_s']:.4f} s = enqueue {r['enqueue_s']:.4f} s + output waits "
                  f"{r['wait_s']:.4f} s + other host {r['wall_s'] - r['enqueue_s'] - r['wait_s']:.4f} s")
        print(f"  traced: wall {trace['wall_s']:.4f} s, device busy {trace['device_busy_s']:.4f} s "
              f"({trace['busy_share']:.1%} of that wall), {trace['device_events']} device events")
        for k, v in trace["by_kind"].items():
            print(f"    {v['share']:6.1%} {v['s'] * 1e3:9.3f} ms  {k}")
        for t in trace["top"]:
            print(f"    top: {t['s'] * 1e3:9.3f} ms {t['calls']:6d} calls  {t['name'][:110]}")
    torch.cuda.synchronize()
    print(json.dumps(report))


if __name__ == "__main__":
    main()
