"""Where the time of chip_smoke.py's workloads goes, on one NVIDIA GPU.

    python3 profile_smoke.py

Drives the workloads of chip_smoke.py at production widths with random bf16
weights: recognition of given line boxes (4 synthetic pages x 8 lines,
RecognitionPredictor, bf16 KV cache), pinned to 40 tokens per line and with
free-running stops, and whole-page OCR (8 synthetic pages x 16 lines,
DetectionPredictor then RecognitionPredictor, int8 KV cache), pinned. For each
mode it prints:

- untraced: the wall of REPS runs, each split into its prefill waves, its
  decode chunks and the host time around them, and for whole-page OCR also
  the detection wall and its device program (every device program ends in a
  copy to the host, so the timers add no synchronisation);
- traced, one more run under torch.profiler: that run's own wall, the
  device's busy time in it (the union of kernel, copy and memset intervals),
  the number of kernels, device time by kind and the largest kernels.

Busy time is set only against the traced run's wall, never against an
untraced one. The last line is one JSON object holding every number.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from surya_tpu_torch.detection import DetectionPredictor
from surya_tpu_torch.models.efficientvit import install_blob_detector
from surya_tpu_torch.recognition import RecognitionPredictor
from surya_tpu_torch.settings import settings

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


def time_programs(obj, names, stats):
    """Wrap the device programs `names` of a predictor with wall timers."""
    for name in names:
        def timed(*args, _fn=getattr(obj, name), _name=name, **kwargs):
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            stats[_name].append(time.perf_counter() - t0)
            return out

        setattr(obj, name, timed)


def untraced(run, stats):
    """REPS runs of `run()` -> (wall, detection wall, tokens), each split by the timed programs."""
    runs = []
    for _ in range(REPS):
        stats.clear()
        wall, det_wall, toks = run()
        prefill, decode = sum(stats["_prefill"]), sum(stats["_decode"])
        r = {"wall_s": wall, "tokens": toks, "prefill_s": prefill, "waves": len(stats["_prefill"]),
             "decode_s": decode, "chunks": len(stats["_decode"]),
             "host_rest_s": wall - det_wall - prefill - decode}
        if det_wall:
            r.update(detection_s=det_wall, detection_device_program_s=sum(stats["heatmaps"]))
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


def main():
    power = chip_smoke.card()
    print(f"card: {power}")
    pred = RecognitionPredictor(device="cuda")
    det = DetectionPredictor(device="cuda")
    install_blob_detector(det)
    pages, bboxes = chip_smoke.synthetic_pages(np.random.default_rng(chip_smoke.SEED))
    ocr_pages = chip_smoke.synthetic_full_pages(np.random.default_rng(chip_smoke.SEED + 1))
    stats = defaultdict(list)
    time_programs(pred, ("_prefill", "_decode"), stats)
    time_programs(det, ("heatmaps",), stats)

    def given_lines(pin):
        wall, _, toks = chip_smoke.run_predictor(pred, pages, bboxes, pin=pin)
        return wall, 0.0, toks

    def whole_page():
        settings.RECOGNITION_MODEL_QUANTIZE = True
        try:
            det_wall, rec_wall, _, toks = chip_smoke.run_full_page(pred, det, ocr_pages, pin=True)
        finally:
            settings.RECOGNITION_MODEL_QUANTIZE = False
        return det_wall + rec_wall, det_wall, toks

    report = {"card": power}
    for label, run in [("pinned", lambda: given_lines(True)), ("free-running", lambda: given_lines(False)),
                       ("whole-page pinned, int8 cache", whole_page)]:
        run()  # warm-up at this mode's shapes
        runs = untraced(run, stats)
        trace = traced(run)
        report[label] = {"untraced": runs, "traced": trace}
        print(f"[{label}] {runs[0]['tokens']} tokens [{power}]")
        for r in runs:
            det_part = (f"detection {r['detection_s']:.4f} s (device program {r['detection_device_program_s']:.4f} s) + "
                        if "detection_s" in r else "")
            print(f"  untraced: wall {r['wall_s']:.4f} s = {det_part}prefill {r['prefill_s']:.4f} s ({r['waves']} waves) "
                  f"+ decode {r['decode_s']:.4f} s ({r['chunks']} chunks) + host {r['host_rest_s']:.4f} s")
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
