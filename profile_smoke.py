"""Where the time of chip_smoke.py's recognition workload goes, on one NVIDIA GPU.

    python3 profile_smoke.py

Drives the workload of chip_smoke.py (4 synthetic pages x 8 line boxes,
production widths, random bf16 weights, seed 0) through RecognitionPredictor,
pinned to 40 tokens per line and with free-running stops. For each mode it
prints:

- untraced: the wall of REPS runs, each split into its prefill waves, its
  decode chunks and the host time around them (both device programs end in a
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
from surya_tpu_torch.recognition import RecognitionPredictor

REPS = 3
TOP = 10
# device-time kinds, matched in order against the lower-cased kernel name
KINDS = (
    ("K1 segmented_block_attention", ("segmented_attention_kernel",)),
    ("K2 causal_flash_attention", ("causal_attention_kernel",)),
    ("K3 gqa_decode", ("gqa_decode_kernel",)),
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


def time_programs(pred, stats):
    """Wrap the predictor's two device programs with wall timers."""
    for name in ("_prefill", "_decode"):
        def timed(*args, _fn=getattr(pred, name), _name=name, **kwargs):
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            stats[_name].append(time.perf_counter() - t0)
            return out

        setattr(pred, name, timed)


def untraced(pred, pages, bboxes, pin, stats):
    runs = []
    for _ in range(REPS):
        stats.clear()
        wall, _, toks = chip_smoke.run_predictor(pred, pages, bboxes, pin=pin)
        prefill, decode = sum(stats["_prefill"]), sum(stats["_decode"])
        runs.append({"wall_s": wall, "tokens": toks, "prefill_s": prefill, "waves": len(stats["_prefill"]),
                     "decode_s": decode, "chunks": len(stats["_decode"]), "host_rest_s": wall - prefill - decode})
    return runs


def traced(pred, pages, bboxes, pin):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall, _, toks = chip_smoke.run_predictor(pred, pages, bboxes, pin=pin)
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
    pages, bboxes = chip_smoke.synthetic_pages(np.random.default_rng(chip_smoke.SEED))
    stats = defaultdict(list)
    time_programs(pred, stats)
    report = {"card": power}
    for label, pin in [("pinned", True), ("free-running", False)]:
        chip_smoke.run_predictor(pred, pages, bboxes, pin=pin)  # warm-up at this mode's shapes
        runs = untraced(pred, pages, bboxes, pin, stats)
        trace = traced(pred, pages, bboxes, pin)
        report[label] = {"untraced": runs, "traced": trace}
        print(f"[{label}] {runs[0]['tokens']} tokens [{power}]")
        for r in runs:
            print(f"  untraced: wall {r['wall_s']:.4f} s = prefill {r['prefill_s']:.4f} s ({r['waves']} waves) "
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
