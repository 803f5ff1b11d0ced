"""Stage timers and counters (counterpart of surya_tpu/common/profiling.py).

- ``stage(name)`` is a context manager, or a function decorator, that adds
  the host wall time of the block to a process-wide registry (``report()``
  returns it and clears it). Stages nest freely and may run in several
  threads at once.
- ``count(name, n)`` adds n to a counter of the same registry; ``report()``
  gives it beside the stages. A name is a stage's or a counter's, not both:
  until ``report()`` clears the registry, the other kind's use of a name
  raises ValueError.
- Each stage is also a ``torch.profiler.record_function`` range, and on a
  machine with CUDA an NVTX range, so that a trace shows it on the clock of
  the device's work.
- With ``SURYA_PROFILE_DIR`` set, the outermost stage records a
  ``torch.profiler`` trace (CPU and, where present, CUDA activity) and
  writes it there as a Chrome trace, ``<stage>_<pid>_<ns>.json``. A
  recognition or layout call is one outermost stage (``recognition.call``,
  ``layout.call``), so it writes one trace. One trace runs at a time in a
  process: a stage entered in another thread meanwhile (the recognition
  builder's, the detection worker's) is timed and starts no second trace.
  The profiler loses the device events of a CUDA graph captured after an
  earlier session: capture the graphs with the variable unset, and set it
  only after a warm-up call.

A stage times the host only: it adds no device synchronisation, so a stage
around a dispatch times its enqueue and a stage around a wait times the wait.
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

import torch

from surya_tpu_torch.logging import get_logger

logger = get_logger()

_lock = threading.Lock()
_stats: Dict[str, list] = defaultdict(lambda: [0.0, 0])
_counts: Dict[str, list] = defaultdict(lambda: [0, 0])
_tracer = None  # the trace the outermost stage records


def profile_dir():
    return os.environ.get("SURYA_PROFILE_DIR")


def _trace():
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


@contextmanager
def stage(name: str):
    """Time a pipeline stage; nests freely, and decorates a function as a
    stage of each call. With SURYA_PROFILE_DIR set, the outermost stage
    records a torch.profiler trace into that directory."""
    global _tracer
    if name in _counts:
        raise ValueError(f"{name!r} is a counter, not a stage")
    tracer = None
    if profile_dir():
        with _lock:
            if _tracer is None:
                tracer = _tracer = _trace()
        if tracer is not None:
            tracer.start()
    nvtx = torch.cuda.is_available()
    try:
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        # read before the range's op, which lets go of the interpreter lock
        # and takes the range's start: read after it, the clock would miss
        # the wait to take the lock back (milliseconds, while another
        # thread runs numpy)
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                with _lock:
                    _stats[name][0] += dt
                    _stats[name][1] += 1
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
        if tracer is not None:
            tracer.stop()
            os.makedirs(profile_dir(), exist_ok=True)
            path = os.path.join(profile_dir(), f"{name}_{os.getpid()}_{time.time_ns()}.json")
            tracer.export_chrome_trace(path)
            with _lock:
                _tracer = None
            logger.info("wrote trace to %s", path)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` (one call of it)."""
    with _lock:
        if name in _stats:
            raise ValueError(f"{name!r} is a stage, not a counter")
        c = _counts[name]
        c[0] += int(n)
        c[1] += 1


def report(reset: bool = True) -> Dict[str, dict]:
    """{stage: {total_s, calls, mean_s}} and {counter: {count, calls}} in one
    dict, and optionally clear the registry."""
    with _lock:
        out = {
            name: {"total_s": total, "calls": calls, "mean_s": total / calls if calls else 0}
            for name, (total, calls) in _stats.items()
        }
        out.update({name: {"count": total, "calls": calls} for name, (total, calls) in _counts.items()})
        if reset:
            _stats.clear()
            _counts.clear()
    return out
