"""Captured AR loops: the port's counterpart of ``jax.jit`` over a
``jax.lax.while_loop``.

The JAX package runs each of its autoregressive loops (recognition's decode
chunk, layout's and table recognition's box loops) as one compiled program
whose ``cond`` exits on the device. Here such a loop is a ``Loop``: tensors
allocated once (its static inputs, buffers and outputs) and three functions
that write them in place, ``begin``, ``step(i)`` and ``end``; ``begin`` and
every step set ``pred``, a device bool, to the JAX cond for the step after.

``LoopGraphs``, the store a predictor keeps on CUDA, captures a loop once per
key of static shapes and flags, as ``jit`` keys its programs, and replays it
once per call: ``begin``, then each of the ``max_steps`` steps inside an IF
node whose condition is ``pred`` (``csrc/graph_cond.cu``), then ``end``. Once
every row is done the card skips the remaining steps without a visit from
the host. Before each replay the call's inputs are copied into the loop's
static inputs; the outputs belong to the graph, so the caller copies or
packs them before the next replay of the same key. A failed capture or
replay raises: nothing falls back to eager launches on the card.

``EagerLoops`` is the plain version, which the CPU runs: every call builds
its loop and runs it eagerly, the cond read on the host after each step (an
exact ``break``), so it runs the same steps as the graph.

A kernel wrapper counts its launches with ``count``. Under capture nothing
runs, so a capture records the launches its steps make instead, and a
replay's ``Ran`` adds launches per step times the steps that ran (a device
count, copied to the host beside the outputs) when the caller reads it.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

from surya_tpu_torch.ops import _build


@dataclass
class Loop:
    """An AR loop in the form a graph captures: every tensor it touches
    outside a step's own temporaries is allocated when it is built, and
    begin, step(i) (i < max_steps) and end write them in place."""

    max_steps: int
    inputs: Dict[str, torch.Tensor]  # static inputs, filled by copy_ before each run
    outputs: object  # the tensors (a tuple or a dict) the caller reads
    pred: torch.Tensor  # device bool: run the next step (the JAX cond)
    begin: Callable[[], None]
    step: Callable[[int], None]
    end: Callable[[], None] = lambda: None


# -- launch counts and per-capture scratch ----------------------------------------

class _Scope(threading.local):
    capturing: Optional[Counter] = None  # launches recorded by the capture under way
    scratch: Optional[dict] = None  # the buffers of the capture being made


_scope = _Scope()


def count(owner, attr: str = "launches") -> None:
    """A kernel wrapper's launch: owner.attr += 1, or, while a loop is being
    captured in this thread, one launch recorded for each replay's step."""
    if _scope.capturing is not None:
        _scope.capturing[owner, attr] += 1
    else:
        setattr(owner, attr, getattr(owner, attr) + 1)


@contextmanager
def recording():
    """Record this thread's launches (owner, attr) -> n instead of counting them."""
    saved, _scope.capturing = _scope.capturing, Counter()
    try:
        yield _scope.capturing
    finally:
        _scope.capturing = saved


def scratch(key, make: Callable[[], torch.Tensor]) -> Optional[torch.Tensor]:
    """While a loop is being captured in this thread: the buffer its
    warm-up made for key (made now, outside capture), which the graph keeps;
    None otherwise. For state that a kernel expects zeroed and leaves zeroed
    (the decode kernel's merge counts): one buffer serves every replay."""
    if _scope.scratch is None:
        return None
    if key not in _scope.scratch:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{key}: made under capture; the loop's warm-up step must make it")
        _scope.scratch[key] = make()
    return _scope.scratch[key]


@dataclass
class Ran:
    """How many steps one run of a loop took. On CUDA the count is copied
    to pinned host memory right after the replay, so it is read once the
    caller has waited for the outputs it fetches; ``credit`` then adds the
    replay's launches to the wrappers' counts."""

    host: object  # int, or a host tensor that a copy fills
    per_step: dict = field(default_factory=dict)  # (owner, attr) -> launches a step
    event: Optional[object] = None  # recorded after the copy
    credited: bool = False

    @property
    def steps(self) -> int:
        if self.event is not None:
            self.event.synchronize()
        return int(self.host)

    def credit(self) -> int:
        """The steps that ran; the first call adds their launches."""
        n = self.steps
        if not self.credited:
            self.credited = True
            for (owner, attr), per in self.per_step.items():
                setattr(owner, attr, getattr(owner, attr) + per * n)
        return n


def _copy_inputs(loop: Loop, inputs: dict) -> None:
    if set(inputs) != set(loop.inputs):
        raise KeyError(f"loop inputs {sorted(loop.inputs)}, given {sorted(inputs)}")
    for name, t in inputs.items():
        loop.inputs[name].copy_(t)


def run_eager(loop: Loop, inputs: dict) -> tuple:
    """The plain version of a loop's graph: begin, then step i while i <
    max_steps and the cond (read on the host) holds, then end. Returns
    (outputs, Ran)."""
    _copy_inputs(loop, inputs)
    loop.begin()
    n = 0
    while n < loop.max_steps and bool(loop.pred):
        loop.step(n)
        n += 1
    loop.end()
    return loop.outputs, Ran(n)


class EagerLoops:
    """The plain store: each call builds its loop and runs it eagerly."""

    def run(self, key, build: Callable[[], Loop], inputs: dict) -> tuple:
        return run_eager(build(), inputs)

    def drop(self, match: Callable[[tuple], bool]) -> None:
        pass


# -- the CUDA graph ----------------------------------------------------------------

class CudaLoopGraph:
    """One loop captured on a device: begin on a capture stream of its own,
    each step inside an IF node whose body a second stream captures, its
    temporaries from a memory pool of the graph's (PyTorch routes only the
    capture stream's allocations to the graph's own pool). Replayed on the
    caller's current stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        self.stream = torch.cuda.Stream(device)
        self.body_stream = torch.cuda.Stream(device)
        with torch.cuda.device(device):  # a pool belongs to the device current at its making
            self.body_pool = torch.cuda.MemPool()

    def warm_up(self, loop: Loop) -> None:
        """begin and step 0 once, eagerly, on the streams the capture uses:
        library handles and workspaces are made outside the graph."""
        with torch.cuda.device(self.device):
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                loop.begin()
            self.body_stream.wait_stream(self.stream)
            with torch.cuda.stream(self.body_stream):
                if loop.max_steps:
                    loop.step(0)
            torch.cuda.current_stream().wait_stream(self.body_stream)

    def capture(self, program: Callable[["CudaLoopGraph"], None]) -> None:
        self.lib = _build.library().lib
        with torch.cuda.device(self.device):
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    program(self)
                finally:
                    self.graph.capture_end()
            torch.cuda.current_stream().wait_stream(self.stream)

    def when(self, pred: torch.Tensor, body: Callable[[], None]) -> None:
        """Capture body as an IF node that runs when pred holds."""
        _build.check(self.lib.surya_graph_if_begin(self.stream.cuda_stream, pred.data_ptr(),
                                                   self.body_stream.cuda_stream), "surya_graph_if_begin")
        try:
            with torch.cuda.stream(self.body_stream), torch.cuda.use_mem_pool(self.body_pool, self.device):
                body()
        finally:
            _build.check(self.lib.surya_graph_if_end(self.body_stream.cuda_stream), "surya_graph_if_end")

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()


@dataclass
class _Captured:
    loop: Loop
    graph: object
    steps: torch.Tensor  # device int32: the steps the last replay ran
    per_step: dict
    scratch: dict  # buffers its kernels keep (graphs.scratch)


def _program(graph, loop: Loop, steps: torch.Tensor) -> None:
    steps.zero_()
    loop.begin()
    for i in range(loop.max_steps):
        def body(i=i):
            loop.step(i)
            steps.add_(1)

        graph.when(loop.pred, body)
    loop.end()


class LoopGraphs:
    """A predictor's captured loops, by key (device, static shapes and
    flags). ``graph_class`` builds a key's graph from its device (a stand-in
    in the CPU tests). ``captures`` keeps, by key, the seconds its capture
    took and the device memory reserved meanwhile (its static buffers and
    its graph's memory pools)."""

    def __init__(self, graph_class=CudaLoopGraph):
        self.graph_class = graph_class
        self.loops: Dict[tuple, _Captured] = {}
        self.captures: Dict[tuple, dict] = {}

    def run(self, key, build: Callable[[], Loop], inputs: dict) -> tuple:
        """Replay key's loop (captured now at its first call) on inputs.
        Returns (the graph's outputs, Ran)."""
        cap = self.loops.get(key)
        if cap is None:
            cap = self.loops[key] = self._capture(key, build, inputs)
        _copy_inputs(cap.loop, inputs)
        with recording():  # a stand-in graph replays through the wrappers
            cap.graph.replay()
        if cap.steps.is_cuda:
            host = torch.empty((), dtype=torch.int32, pin_memory=True)
            host.copy_(cap.steps, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(cap.steps.device))
            return cap.loop.outputs, Ran(host, cap.per_step, event)
        return cap.loop.outputs, Ran(cap.steps.clone(), cap.per_step)

    def drop(self, match: Callable[[tuple], bool]) -> None:
        """Forget the graphs whose key matches (their memory goes with them)."""
        for key in [k for k in list(self.loops) if match(k)]:  # a snapshot: other threads may add keys
            self.loops.pop(key, None)

    def _capture(self, key, build: Callable[[], Loop], inputs: dict) -> _Captured:
        t0 = time.perf_counter()
        device = next(iter(inputs.values())).device
        cuda = device.type == "cuda"
        reserved = torch.cuda.memory_reserved(device) if cuda else 0
        loop = build()
        _copy_inputs(loop, inputs)
        graph = self.graph_class(device)
        steps = torch.zeros((), dtype=torch.int32, device=device)
        saved, _scope.scratch = _scope.scratch, {}
        try:
            graph.warm_up(loop)
            with recording() as launches:
                graph.capture(lambda g: _program(g, loop, steps))
            scratch = _scope.scratch
        finally:
            _scope.scratch = saved
        per_step = {}
        for k, n in launches.items():
            if n % loop.max_steps:
                raise RuntimeError(f"{key}: {n} launches of {k} in {loop.max_steps} captured steps")
            per_step[k] = n // loop.max_steps
        self.captures[key] = {"capture_s": time.perf_counter() - t0,
                              "pool_bytes": torch.cuda.memory_reserved(device) - reserved if cuda else 0}
        return _Captured(loop, graph, steps, per_step, scratch)


def loops_for(device) -> object:
    """The store a caller on `device` runs its loops through: captured
    graphs on CUDA, the eager loop elsewhere."""
    return LoopGraphs() if torch.device(device).type == "cuda" else EagerLoops()
