"""One run of one cell of BENCHMARK.json: set-up, a closed-loop window of
calls, then, with the program's state freed, the check of what it served.

Everything a cell needs is found by name: its configuration file (the
``file`` of its entry in ``configs``), its traffic mix
(``perfbench/traffic/<traffic>.json``), the system that drives the program
for the configuration (``perfbench/systems/<system>.py``, named in the
configuration file), the limits of its comparison
(``perfbench/limits/<cell>.json``) and the reader of each per-layer metric
(``perfbench/metrics/<metric>.py``).

The window: one client calls the program, each call as soon as the last has
returned, until ``--seconds`` have passed since the first began; the last
call is finished. A rate is the pages of every call over the time from the
first call's start to the last call's end. With ``--trace 1`` the mix's
``trace_calls`` calls run under one torch.profiler session before the
window, and the program's stage times and counters are read over the
window's calls, which no profiler slows.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
CACHE = ROOT / ".perfbench_cache"  # every build and kernel cache of the program, at fixed paths
FORBIDDEN = ("jax", "jaxlib", "flax", "surya_tpu")  # top-level module names no run may load
PROGRAM = "surya_tpu_torch"


def parse(argv):
    p = argparse.ArgumentParser(description="One run of one cell of BENCHMARK.json")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="1: run the lower-precision control in the program's place (not a benchmark run)")
    return p.parse_args(argv)


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json"):
    bench = json.loads(bench_path.read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in {bench_path}")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    metrics = {"end_to_end": [m for m in bench["end_to_end"] if name in m.get("workloads", [name])],
               "per_layer": [m for m in bench["per_layer"] if name in m.get("workloads", [name])]}
    return cell, cfg, metrics


def program_environment(system_env: Dict[str, str]) -> None:
    """The program's settings, before it is imported: random weights allowed
    and no checkpoint resolved (the benchmark loads its own), every cache
    inside the checkout, no trace of the program's own."""
    os.environ.pop("SURYA_PROFILE_DIR", None)
    os.environ.update({
        "ALLOW_RANDOM_WEIGHTS": "true", "DISABLE_TQDM": "true", "USE_FLAX": "0", "USE_MESH": "false",
        "SURYA_TORCH_BUILD_DIR": str(CACHE / "kernels"), "SURYA_TORCH_NATIVE_DIR": str(CACHE / "native"),
        "TRITON_CACHE_DIR": str(CACHE / "triton"), "MODEL_CACHE_DIR": str(CACHE / "models"),
        "FONT_DIR": str(CACHE / "fonts"), "S3_BASE_URL": "http://127.0.0.1:9",
        **{k: os.devnull for k in ("DETECTOR_MODEL_CHECKPOINT", "RECOGNITION_MODEL_CHECKPOINT",
                                    "LAYOUT_MODEL_CHECKPOINT", "TABLE_REC_MODEL_CHECKPOINT",
                                    "OCR_ERROR_MODEL_CHECKPOINT")},
        **system_env,
    })


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_reader(metric: str):
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What the per-layer readers read: the traced calls' device trace and
    work, the program's stage times over the untraced calls, the counters."""

    def __init__(self):
        self.trace = None  # devtrace.DeviceTrace of the traced calls
        self.traced_pages = 0
        self.work: Dict[str, float] = {}  # counts of the traced calls' work
        self.stages: Dict[str, dict] = {}  # profiling.report() over the window's (untraced) calls
        self.stage_pages = 0  # the window's pages
        self.counters: Dict[str, float] = {}  # the system's, summed over the window's calls
        self.untraced_wall_s = 0.0  # the window's wall

    def stage_s(self, *names) -> Optional[float]:
        found = [self.stages[n]["total_s"] for n in names if n in self.stages]
        return sum(found) if found else None


def run(argv=None, t_start: Optional[float] = None, device: str = "cuda", tiny: bool = False,
        bench_path: Path = ROOT / "BENCHMARK.json", limits_dir: Path = BENCH / "limits") -> int:
    """One run; prints its result line. `device`, `tiny` and the paths are
    for the CPU tests, which drive every step but the look for a card."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    cell, cfg, metrics = load_cell(args.workload, bench_path)
    sys.path.insert(0, str(ROOT))
    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"perfbench: the cell needs {cell['chips']} CUDA device(s); "
                  f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        if not (ROOT / PROGRAM).is_dir():
            print(f"perfbench: no {PROGRAM} package in {ROOT}", file=sys.stderr)
            return 3
    from perfbench import traffic

    system_mod = importlib.import_module(f"perfbench.systems.{cfg['system']}")
    mix = traffic.load(cell["traffic"])
    program_environment(system_mod.environment(cfg, mix, bool(args.control)))
    import surya_tpu_torch
    from surya_tpu_torch.common import profiling

    from perfbench import devtrace

    if device == "cuda" and Path(surya_tpu_torch.__file__).resolve().parent != ROOT / PROGRAM:
        print(f"perfbench: {PROGRAM} was imported from {surya_tpu_torch.__file__}, not this checkout", file=sys.stderr)
        return 3
    limits = json.loads((limits_dir / f"{cell['name']}.json").read_text())

    t_imported = time.perf_counter()
    system = system_mod.System(cfg, mix, args.seed, device, control=bool(args.control), tiny=tiny)
    t_built = time.perf_counter()
    # warm-up: every distinct call of the window once (their shapes, graphs
    # and caches), twice where the first is the only one
    for k in range(max(2, system.distinct_calls())):
        system.call(k)
    sync(device)
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    setup_s = time.perf_counter() - t_start
    print(f"perfbench: set-up {setup_s:.2f} s: imports {t_imported - t_start:.2f}, build and weights "
          f"{t_built - t_imported:.2f}, warm-up ({max(2, system.distinct_calls())} calls) "
          f"{t_start + setup_s - t_built:.2f}", file=sys.stderr)

    rec = Run()
    trace_calls = mix["trace_calls"] if args.trace else 0
    system.recording = True
    profiling.report(reset=True)
    system.reset_counters()
    captures = system.captures()
    walls = []

    def call(k: int) -> int:
        t0 = time.perf_counter()
        result["attempted"] += 1
        try:
            with torch.profiler.record_function("perfbench.call"):
                n = system.call(k)
        except Exception:  # a failed call is counted and the run goes on
            traceback.print_exc()
            result["failed"] += 1
            n = 0
        walls.append(time.perf_counter() - t0)
        return n

    # with --trace 1: the first calls under one profiler session, then the window
    prof = start_profiler(device) if trace_calls else None
    rec.traced_pages = sum(call(k) for k in range(trace_calls))
    if prof is not None:
        sync(device)
        stop_profiler(prof)
        profiling.report(reset=True)
        system.reset_counters()
    pages, k = 0, trace_calls
    first_start = time.perf_counter()
    while True:
        pages += call(k)
        k += 1
        if time.perf_counter() - first_start >= args.seconds:
            break
    sync(device)
    wall = time.perf_counter() - first_start
    rec.untraced_wall_s = wall
    rec.stages = profiling.report(reset=True)
    rec.stage_pages = pages
    rec.counters = system.counters()
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if prof is not None and device == "cuda":
        rec.trace = devtrace.read(prof, system_mod.STAGE_PREFIXES)
    if args.trace:
        rec.work = system.work(range(trace_calls))
    print(f"perfbench: window {wall:.3f} s, {k - trace_calls} calls, {pages} pages; call walls "
          f"{[round(w, 3) for w in walls]}"
          + (f"; traced calls {trace_calls}, their wall {rec.trace.window_s:.3f} s, busy {rec.trace.busy_s:.3f} s"
             if rec.trace is not None else ""), file=sys.stderr)
    new_captures = system.captures() - captures
    if new_captures:
        print(f"perfbench: {new_captures} CUDA graph(s) captured inside the window", file=sys.stderr)
    stray = forbidden_modules()
    if stray:
        print(f"perfbench: the run loaded {', '.join(stray)}", file=sys.stderr)
        return 4

    e2e = {}
    if pages:  # all the pages of the window's calls over its whole time
        e2e[cfg["rate_metric"]] = pages / wall
    e2e["setup_s"] = setup_s
    layer = {}
    if args.trace:  # a reader with nothing to read returns None, and its metric is left out
        for m in metrics["per_layer"]:
            value = load_reader(m["name"])(rec)
            if value is not None:
                layer[m["name"]] = value
    units = {m["name"]: m["unit"] for m in metrics["end_to_end"] + metrics["per_layer"]}
    chosen = layer if args.trace else e2e
    result["metrics"] = {name: {"value": v, "unit": units[name]} for name, v in chosen.items() if name in units}
    result["device"] = device_info(device, memory_peak, rec if args.trace else None)
    if args.trace and rec.trace is not None:
        result["breakdown"] = {"device_ops": rec.trace.top_ops(), "idle_gaps": rec.trace.top_gaps()}

    # the check, with the program's state freed
    system.release()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = system.check(limits.get("tolerances", {}))
    print(f"perfbench: check {time.perf_counter() - t_check:.2f} s", file=sys.stderr)
    limits = limits["limits"]
    checks = {name: {"value": v, "limit": limits[name]} for name, v in numbers.items() if name in limits}
    missing = sorted(set(limits) - set(numbers))
    result["correct"] = (not missing and result["failed"] == 0 and bool(pages)
                         and all(c["value"] <= c["limit"] for c in checks.values()))
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    if missing:
        print(f"check: no reading of {', '.join(missing)}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def sync(device):
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def start_profiler(device):
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    prof.window = torch.profiler.record_function("perfbench.traced_window")
    prof.window.__enter__()
    return prof


def stop_profiler(prof) -> None:
    prof.window.__exit__(None, None, None)
    prof.stop()


def device_info(device, memory_peak: int, rec: Optional[Run]) -> dict:
    import torch

    if device != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": int(memory_peak)}
    if rec is not None and rec.trace is not None:
        info.update(busy_s=rec.trace.busy_s, window_s=rec.trace.window_s)
    return info
