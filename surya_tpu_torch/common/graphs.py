"""Captured programs: the port's counterpart of ``jax.jit``, over a
``jax.lax.while_loop`` or over a one-shot program.

The JAX package runs each of its autoregressive loops (recognition's decode
chunk, on one device or over a mesh, and layout's and table recognition's
whole generate) as one compiled program whose ``cond`` exits on the
device. Here such a loop is a ``Loop``: tensors allocated once (its
static inputs, buffers and outputs) and three functions that write them in
place, ``begin``, ``step(i)`` and ``end``; ``begin`` and every step set
``pred``, a device bool, to the JAX cond for the step after. A ``begin``
may run a one-shot prologue from the static inputs first (layout's: the
uint8 tiles' normalisation and the encoder; table recognition's: the
encoder states' gather, the cross-attention K/V and the prompt's prefill).

``LoopGraphs``, the store a predictor keeps on CUDA, captures a loop once per
key of static shapes and flags, as ``jit`` keys its programs, and replays it
once per call: ``begin``, then each of the ``max_steps`` steps inside an IF
node whose condition is ``pred`` (``csrc/graph_cond.cu``), then ``end``. Once
every row is done the card skips the remaining steps without a visit from
the host. Before each replay the call's inputs are copied into the loop's
static inputs; the outputs belong to the graph, so the caller copies or
packs them before the next replay of the same key. A failed capture or
replay raises: nothing falls back to eager launches on the card. The
graphs of a store share their memory pools and streams on a device
(``_SharedStore``), so a store holds about its largest graph's temporaries.
A loop or a program over the shards of a mesh is captured where they all lie
on one card (``loops_for``, ``programs_for``); no graph spans several cards.

A jitted program without an AR loop is a ``Program``: static inputs, outputs
allocated when it is built, and ``body()``, which reads the one and writes
the other in place. ``ProgramGraphs`` captures one per key and replays it
once per call, as ``LoopGraphs`` does a loop. Captured so: detection's stats
and maps programs (surya_tpu detection ``forward_stats``,
``forward_resize_stats``, ``forward``, ``forward_resize``; on a mesh too),
recognition's prefill wave (surya_tpu recognition ``prefill_fn``, on one
device or over a mesh; its fused ``prefill_decode_fn`` is the prefill's
replay, then the decode chunk's), table recognition's ``encode`` and OCR
error's ``forward``. A
loop of unknown trip count inside a program, the component flood's, is
``until(pred, body)``: a WHILE node of the graph, whose condition the card
reads when the node starts and after each run of the body.

``EagerLoops`` and ``EagerPrograms`` are the plain versions, which the CPU
runs: every call builds its loop or program and runs it eagerly, a loop's
cond (and an ``until``'s) read on the host after each step, so it runs the
same steps as the graph.

A kernel wrapper counts its launches with ``count``. Under capture nothing
runs, so a capture records the launches its steps make instead: a loop's
replay's ``Ran`` adds launches per step times the steps that ran (a device
count, copied to the host beside the outputs) when the caller reads it, and
a program's replay adds the launches its capture recorded.
"""

from __future__ import annotations

import ctypes
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


@dataclass
class Program:
    """A one-shot program in the form a graph captures (one jitted function
    of the JAX package): its static inputs and outputs are allocated when it
    is built, and body() reads the one and writes the other in place; its
    temporaries come and go inside body. A loop of unknown trip count in it
    is ``until``."""

    inputs: Dict[str, torch.Tensor]  # static inputs, filled by copy_ before each run
    outputs: object  # the tensors (a tuple or a dict) the caller reads
    body: Callable[[], None]


def static_inputs(inputs: dict, device) -> Dict[str, torch.Tensor]:
    """A program's static inputs: an empty tensor like each of `inputs`
    (device or host tensors), on `device`."""
    return {name: torch.empty(t.shape, dtype=t.dtype, device=device) for name, t in inputs.items()}


# -- launch counts ---------------------------------------------------------------

class _Scope(threading.local):
    capturing: Optional[Counter] = None  # launches recorded by the capture under way
    graph: Optional[object] = None  # the graph a program is being captured (or a stand-in replayed) into


_scope = _Scope()


def count(owner, attr: str = "launches", key=None) -> None:
    """A kernel wrapper's launch: owner.attr += 1 (with a key, owner.attr
    is a dict of counts and owner.attr[key] += 1), or, while a program is
    being captured in this thread, one launch recorded for each replay (a
    loop's: for each step a replay runs)."""
    counter = (owner, attr) if key is None else (owner, attr, key)
    if _scope.capturing is not None:
        _scope.capturing[counter] += 1
    else:
        _add(counter, 1)


def _add(counter: tuple, n: int) -> None:
    """Add n launches to a counter recorded by count: (owner, attr) or (owner, attr, key)."""
    owner, attr = counter[:2]
    if len(counter) == 2:
        setattr(owner, attr, getattr(owner, attr) + n)
    else:
        counts = getattr(owner, attr)
        counts[counter[2]] = counts.get(counter[2], 0) + n


@contextmanager
def recording():
    """Record this thread's launches (owner, attr) -> n instead of counting them."""
    saved, _scope.capturing = _scope.capturing, Counter()
    try:
        yield _scope.capturing
    finally:
        _scope.capturing = saved


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
            for counter, per in self.per_step.items():
                _add(counter, per * n)
        return n


def _copy_inputs(loop, inputs: dict) -> None:
    """Copy a call's inputs (device tensors, or host tensors, pinned for a
    copy that the host does not wait for) into a loop's or a program's
    static inputs, on the current stream."""
    if set(inputs) != set(loop.inputs):
        raise KeyError(f"static inputs {sorted(loop.inputs)}, given {sorted(inputs)}")
    for name, t in inputs.items():
        loop.inputs[name].copy_(t, non_blocking=True)


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


def until(pred: torch.Tensor, body: Callable[[], None]) -> None:
    """while pred: body(), where body writes pred (a device bool), as a
    ``jax.lax.while_loop``. In a program being captured in this thread, a
    WHILE node of its graph: the card reads pred when the node starts and
    after each run of body. Elsewhere the host reads it, one sync a run. A
    kernel wrapper's launches inside body cannot be counted (the card alone
    knows the runs), so a body that counts one raises."""
    graph = _scope.graph
    if graph is None:
        while bool(pred):
            body()
        return

    def uncounted():
        before = sum(_scope.capturing.values()) if _scope.capturing is not None else 0
        body()
        if _scope.capturing is not None and sum(_scope.capturing.values()) != before:
            raise RuntimeError("a counted kernel launched inside a WHILE body: its launches cannot be credited")

    graph.until(pred, uncounted)


def run_program(program: Program, inputs: dict):
    """The plain version of a program's graph: the inputs copied in, the
    body run eagerly (an ``until`` in it loops on the host). Returns its
    outputs."""
    _copy_inputs(program, inputs)
    program.body()
    return program.outputs


class EagerPrograms:
    """The plain store of programs: each call builds its program and runs it
    eagerly."""

    def run(self, key, build: Callable[[], Program], inputs: dict):
        return run_program(build(), inputs)

    def drop(self, match: Callable[[tuple], bool]) -> None:
        pass


# -- the CUDA graph ----------------------------------------------------------------

class CudaLoopGraph:
    """One loop or program captured on a device: on a capture stream, each
    conditional node's body (an IF node a loop step, a WHILE node an
    ``until``) captured from a second stream, its temporaries from a memory
    pool of the graph's (PyTorch routes only the capture stream's
    allocations to the graph's own pool). Replayed on the caller's current
    stream. shared: (the capture's pool handle, the bodies' MemPool, the
    capture stream, the bodies' stream) that other graphs share, or None
    for its own; the allocator reuses a block that one capture freed in
    another only from the same pool and the same stream."""

    def __init__(self, device: torch.device, shared: Optional[tuple] = None):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        if shared is not None:
            self.pool, self.body_pool, self.stream, self.body_stream = shared
        else:
            self.pool = None
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

    def run_once(self, fn: Callable[[], None]) -> None:
        """fn once, eagerly, on the capture stream (a program's warm-up:
        library handles and workspaces are made outside the graph)."""
        with torch.cuda.device(self.device):
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                fn()
            torch.cuda.current_stream().wait_stream(self.stream)

    def capture(self, program: Callable[["CudaLoopGraph"], None]) -> None:
        self.lib = _build.library().lib
        with torch.cuda.device(self.device):
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                self.graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
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

    def until(self, pred: torch.Tensor, body: Callable[[], None]) -> None:
        """Capture body as a WHILE node that runs while pred holds, read when
        the node starts and after each run of body (its last kernel sets the
        condition from pred, which body writes)."""
        if torch.cuda.current_stream(self.device) != self.stream:
            raise RuntimeError("until: a WHILE node is captured from the capture stream (no nesting)")
        handle = ctypes.c_ulonglong()
        _build.check(self.lib.surya_graph_while_begin(self.stream.cuda_stream, pred.data_ptr(),
                                                      self.body_stream.cuda_stream, ctypes.byref(handle)),
                     "surya_graph_while_begin")
        try:
            with torch.cuda.stream(self.body_stream), torch.cuda.use_mem_pool(self.body_pool, self.device):
                body()
        finally:
            _build.check(self.lib.surya_graph_while_end(self.body_stream.cuda_stream, pred.data_ptr(), handle),
                         "surya_graph_while_end")

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()


@dataclass
class _Captured:
    loop: Loop
    graph: object
    steps: torch.Tensor  # device int32: the steps the last replay ran
    per_step: dict


def _program(graph, loop: Loop, steps: torch.Tensor) -> None:
    steps.zero_()
    loop.begin()
    for i in range(loop.max_steps):
        def body(i=i):
            loop.step(i)
            steps.add_(1)

        graph.when(loop.pred, body)
    loop.end()


class _SharedStore:
    """What a store's graphs on one device share: the capture's memory pool,
    the IF and WHILE bodies' ``MemPool``, the capture stream and the bodies'
    stream (the allocator reuses a block that one capture freed in another
    only from the same pool and the same stream), so that a store holds
    about its largest graph's temporaries and not their sum. A replay
    overwrites the temporaries of the store's other graphs, so the store
    orders its replays on the card (each waits for the one before, whatever
    the caller's stream) and serializes capture, input copies and replay
    across threads."""

    def __init__(self, graph_class):
        self.graph_class = graph_class
        self.captures: Dict[tuple, dict] = {}
        # device -> (capture pool handle, bodies' MemPool, capture stream, bodies' stream)
        self._shared: dict = {}
        self._last: Optional[object] = None  # an event after the last replay (CUDA)
        self._lock = threading.Lock()

    def _graphs(self) -> list:
        raise NotImplementedError

    def _shared_for(self, device: torch.device) -> Optional[tuple]:
        """What the store's graphs on `device` share: the pools, new ones
        when no graph of the store lives there (none captured yet, or all
        dropped: the allocator releases a graph pool with the last graph
        that uses it, and a capture into a released pool fails), and the
        two streams."""
        if device.type != "cuda":
            return None
        with torch.cuda.device(device):  # pools and streams belong to the device current at their making
            streams = self._shared[device][2:] if device in self._shared else (torch.cuda.Stream(device),
                                                                                 torch.cuda.Stream(device))
            if device not in self._shared or not any(g.device == device for g in self._graphs()):
                self._shared[device] = (torch.cuda.graph_pool_handle(), torch.cuda.MemPool(), *streams)
        return self._shared[device]

    def _new_graph(self, device: torch.device):
        shared = self._shared_for(device)
        return self.graph_class(device) if shared is None else self.graph_class(device, shared)

    def pool_bytes(self) -> int:
        """Device memory the shared pools hold: their segments in the
        allocator's snapshot."""
        ids = {tuple(p) for shared in self._shared.values() for p in (shared[0], shared[1].id)}
        if not ids:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) in ids)

    def _replay(self, graph) -> None:
        """Replay graph on the caller's current stream, after the store's
        last replay."""
        cuda = graph.device.type == "cuda"
        if cuda and self._last is not None:
            torch.cuda.current_stream(graph.device).wait_event(self._last)
        saved, _scope.graph = _scope.graph, graph
        try:
            with recording():  # a stand-in graph replays through the wrappers
                graph.replay()
        finally:
            _scope.graph = saved
        if cuda:
            self._last = torch.cuda.Event()
            self._last.record(torch.cuda.current_stream(graph.device))


class LoopGraphs(_SharedStore):
    """A predictor's captured loops, by key (device, static shapes and
    flags), their temporaries in the pools the store shares on a device
    (_SharedStore). ``graph_class`` builds a key's graph from its device (a
    stand-in in the CPU tests). ``captures`` keeps, by key, the seconds its
    capture took and the device memory reserved meanwhile (its static
    buffers and what the shared pools grew by)."""

    def __init__(self, graph_class=CudaLoopGraph):
        super().__init__(graph_class)
        self.loops: Dict[tuple, _Captured] = {}

    def _graphs(self) -> list:
        return [cap.graph for cap in self.loops.values()]

    def run(self, key, build: Callable[[], Loop], inputs: dict) -> tuple:
        """Replay key's loop (captured now at its first call) on inputs.
        Returns (the graph's outputs, Ran)."""
        with self._lock:
            cap = self.loops.get(key)
            if cap is None:
                cap = self.loops[key] = self._capture(key, build, inputs)
            _copy_inputs(cap.loop, inputs)
            self._replay(cap.graph)
            if cap.steps.is_cuda:
                host = torch.empty((), dtype=torch.int32, pin_memory=True)
                host.copy_(cap.steps, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(cap.steps.device))
                return cap.loop.outputs, Ran(host, cap.per_step, event)
        return cap.loop.outputs, Ran(cap.steps.clone(), cap.per_step)

    def drop(self, match: Callable[[tuple], bool]) -> None:
        """Forget the graphs whose key matches (the shared pools go with the
        last graph that uses them)."""
        with self._lock:
            for key in [k for k in self.loops if match(k)]:
                del self.loops[key]

    def _capture(self, key, build: Callable[[], Loop], inputs: dict) -> _Captured:
        t0 = time.perf_counter()
        device = next(iter(inputs.values())).device
        cuda = device.type == "cuda"
        reserved = torch.cuda.memory_reserved(device) if cuda else 0
        loop = build()
        _copy_inputs(loop, inputs)
        graph = self._new_graph(device)
        steps = torch.zeros((), dtype=torch.int32, device=device)
        graph.warm_up(loop)
        with recording() as launches:
            graph.capture(lambda g: _program(g, loop, steps))
        per_step = {}
        for k, n in launches.items():
            if n % loop.max_steps:
                raise RuntimeError(f"{key}: {n} launches of {k} in {loop.max_steps} captured steps")
            per_step[k] = n // loop.max_steps
        self.captures[key] = {"capture_s": time.perf_counter() - t0,
                              "pool_bytes": torch.cuda.memory_reserved(device) - reserved if cuda else 0}
        return _Captured(loop, graph, steps, per_step)


def loops_for(device, shard_devices=()) -> object:
    """The store a caller on `device` runs its loops through: captured
    graphs on CUDA, where every shard of its loops (shard_devices: a mesh's
    devices) lies on that card too; the eager loop elsewhere (no graph
    spans several cards)."""
    device = torch.device(device)
    one_card = all(torch.device(d) == device for d in shard_devices)
    return LoopGraphs() if device.type == "cuda" and one_card else EagerLoops()


# -- one-shot programs ---------------------------------------------------------------

@dataclass
class _CapturedProgram:
    program: Program
    graph: object
    launches: dict  # (owner, attr[, key]) -> launches a replay


class ProgramGraphs(_SharedStore):
    """A predictor's captured programs, by key (device, static shapes and
    flags, and whatever the body reads that its inputs do not carry), as
    ``jit`` keys its programs: captured at the first call of a key, then
    replayed once a call, its launches credited once a replay.

    Every program of a store takes its temporaries from the pools that the
    store shares on a device (_SharedStore: the capture's and the WHILE
    bodies'), so the store holds about the largest program's temporaries
    and not their sum; the static inputs and outputs are made outside them,
    when a program is built. The outputs belong to the graph: the caller
    reads them before the next call of the same key.

    ``graph_class`` builds a key's graph from its device and what the
    store's graphs share (a stand-in in the CPU tests). ``captures`` keeps,
    by key, the seconds its build, warm-up and capture took, the device
    memory its warm-up reserved (outside the pools: it caches it for eager
    work) and the growth of the shared pools at its capture (pool_bytes
    gives their size)."""

    def __init__(self, graph_class=CudaLoopGraph):
        super().__init__(graph_class)
        self.programs: Dict[tuple, _CapturedProgram] = {}

    def _graphs(self) -> list:
        return [cap.graph for cap in self.programs.values()]

    def run(self, key, build: Callable[[], Program], inputs: dict):
        """Replay key's program (captured now at its first call) on inputs;
        returns its outputs, the graph's."""
        with self._lock:
            cap = self.programs.get(key)
            if cap is None:
                cap = self.programs[key] = self._capture(key, build, inputs)
            _copy_inputs(cap.program, inputs)
            self._replay(cap.graph)
        for counter, n in cap.launches.items():
            _add(counter, n)
        return cap.program.outputs

    def drop(self, match: Callable[[tuple], bool]) -> None:
        """Forget the programs whose key matches (the shared pools go with the
        last graph that uses them)."""
        with self._lock:
            for key in [k for k in self.programs if match(k)]:
                del self.programs[key]

    def _capture(self, key, build: Callable[[], Program], inputs: dict) -> _CapturedProgram:
        t0 = time.perf_counter()
        program = build()
        device = next(iter(program.inputs.values())).device
        cuda = device.type == "cuda"
        reserved = torch.cuda.memory_reserved(device) if cuda else 0
        _copy_inputs(program, inputs)
        graph = self.graph_class(device, self._shared_for(device))
        graph.run_once(program.body)
        warm_up_bytes = torch.cuda.memory_reserved(device) - reserved if cuda else 0
        pooled = self.pool_bytes() if cuda else 0
        saved = _scope.graph
        try:
            with recording() as launches:
                _scope.graph = graph
                graph.capture(lambda g: program.body())
        finally:
            _scope.graph = saved
        self.captures[key] = {"capture_s": time.perf_counter() - t0, "warm_up_bytes": warm_up_bytes,
                              "pool_bytes": self.pool_bytes() - pooled if cuda else 0}
        return _CapturedProgram(program, graph, dict(launches))


def programs_for(device, shard_devices=()) -> object:
    """The store a caller on `device` runs its one-shot programs through:
    captured graphs on CUDA, where every shard of its programs
    (shard_devices: a mesh's devices) lies on that card too; the eager
    program elsewhere (no graph spans several cards), as loops_for."""
    device = torch.device(device)
    one_card = all(torch.device(d) == device for d in shard_devices)
    return ProgramGraphs() if device.type == "cuda" and one_card else EagerPrograms()
