"""What a ``torch.profiler`` trace of part of a run's window says: the
device's intervals (kernels, copies, memsets), their union, their time by
kernel name, and the idle gaps, each named by the innermost host range (a
program stage or one of the benchmark's) open at its middle.

One profiler session a process, opened after every CUDA graph of the run is
captured: a graph captured after a session has run loses its device events.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW_RANGE = "perfbench.traced_window"
# the kinds of device work, by substrings of the kernel's name, first match
# wins (the port's profile_smoke.py KINDS, copied)
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
NON_GEMM_KINDS = ("copies, memsets, index ops", "elementwise and reductions")


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k.lower() in low for k in keys):
            return kind
    return "other"


def union_us(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    ops: List[Tuple[str, float, float]]  # (kernel name, start us, end us) inside the window
    gaps: Dict[str, float] = field(default_factory=dict)  # host range -> idle seconds

    def seconds(self, predicate) -> float:
        return sum(e - s for name, s, e in self.ops if predicate(name)) / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for name, s, e in self.ops:
            by[name] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]]


def read(prof, host_prefixes: Tuple[str, ...]) -> DeviceTrace:
    """The trace of `prof` (a finished torch.profiler.profile with CPU and
    CUDA activity) within its WINDOW_RANGE. host_prefixes: the names of the
    host ranges that name a gap (a prefix each)."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for ev in prof.events():
        r = ev.time_range
        # a host range also shows on the device's timeline, as an annotation
        # spanning its kernels: not device work
        annotation = getattr(ev, "is_user_annotation", False) or ev.name.startswith(host_prefixes + ("perfbench.",))
        if ev.device_type == DeviceType.CUDA:
            if not annotation:
                device.append((ev.name, r.start, r.end))
        elif ev.name == WINDOW_RANGE:
            window = (r.start, r.end)
        elif ev.name.startswith(host_prefixes + ("perfbench.",)):
            host.append((r.start, r.end, ev.name))
    if window is None:
        raise RuntimeError("the trace holds no window range")
    w0, w1 = window
    ops = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    if not ops:
        raise RuntimeError("torch.profiler recorded no device events in the traced window")
    busy = union_us((s, e) for _, s, e in ops)
    gaps: Dict[str, float] = defaultdict(float)
    cur = w0
    host.sort()
    for s, e in sorted((s, e) for _, s, e in ops):
        if s > cur:
            gaps[_innermost(host, cur, s)] += (s - cur) / 1e6
        cur = max(cur, e)
    if w1 > cur:
        gaps[_innermost(host, cur, w1)] += (w1 - cur) / 1e6
    return DeviceTrace((w1 - w0) / 1e6, busy / 1e6, ops, dict(gaps))


def _innermost(host, s, e) -> str:
    """The shortest host range open at the middle of [s, e]."""
    mid = (s + e) / 2
    best = None
    for hs, he, name in host:
        if hs > mid:
            break
        if he >= mid and (best is None or he - hs < best[0]):
            best = (he - hs, name)
    return best[1] if best else "outside the calls"
