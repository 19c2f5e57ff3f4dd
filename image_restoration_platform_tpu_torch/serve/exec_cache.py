"""The engine's executable tier: one executable per structural key, built once.

Counterpart of image_restoration_platform_tpu/serve/exec_cache.py and of the
executable tier of that package's engine (``_exec_key``, the single-flight
``_aot_executable``, ``compile_count``). There an executable is a compiled
XLA program; here, on a card, it is a program's segments
(serve/programs/segments.py) captured as CUDA graphs, one per segment and
branch, replayed with the host reading the stage flags between them:

- ``exec_key``: the tag, the structural flags (the W-fold's ``fold_w``,
  the gated stages, space-to-depth IO, the egress), then the arguments'
  shapes and types;
- ``ExecCache``: the in-memory executables, the single-flight gate (one
  thread builds a key, the others wait for it) and ``compile_count``;
- ``GraphExecutable``: static input buffers; a warm-up pass on a side
  stream that runs every branch of every segment once, so the kernels'
  nvcc builds, cuFFT and cuDNN plans, lazily loaded modules and every
  device constant (the stages' matrices, the blend's window and origin
  arrays) exist before capture; one capture per segment and branch, each
  writing its results into static buffers that both branches share; replay.
  A capture launches no kernel, so the launch counts of the hand-written
  kernels (each binding's ``launches`` in ``obs.metrics.KERNELS``, counted
  in Python where it launches) are set back after it, and every replay
  adds the launches its graph holds, and publishes them as the counter
  ``kernels.launches.<kernel name>``;
- ``EagerExecutable``: the segments run eagerly under the same key. It is
  the executable on the CPU, where nothing is captured (so the key, the
  single-flight gate and the branch selection are all exercised there); on
  the card for an engine built with ``eager=True`` to compare replay with
  eager execution, and for a mesh program whose slots are distinct devices
  (``parallel.mesh.capture_plan`` decides that from the layout before any
  capture; ``eager_by_plan`` marks it). A capture that fails raises;
  nothing falls back to eager execution;
- ``MeshExecutable``: a restore step over a mesh's data rows, one
  executable a row on the row's home device, run segment-major
  (``run_segment_major``: segment k of every row, then every row's flag,
  then segment k + 1), so the host waits on the device three times a step
  whatever the number of rows.

No disk tier: a CUDA graph holds one process's device addresses and cannot
be serialised. What does persist across processes is the kernels' nvcc
builds (``build/kernels``, ops/cuda/build.py).

Every graph of an engine shares one memory pool (the data rows' graphs
and the unsharded ones alike): a segment's results are copied into buffers
outside the pool, so nothing a graph leaves behind lives in it, and the
graphs of one device replay one at a time on its stream, so any order of
replays is safe (rows on distinct devices draw on each device's own part
of the pool). The warm-up captures the largest shapes first, so the
smaller graphs after them take blocks the larger ones left in the pool.
"""

from __future__ import annotations

import threading

import torch

from ..obs.metrics import KERNELS, get_counters
from ..parallel.sharding import gather
from .programs.segments import Program, decide


def exec_key(tag, structural: tuple, args) -> tuple:
    """The tag, the flags that change a program's structure, then each
    argument's shape and type."""
    return (tag, *structural, *((tuple(a.shape), str(a.dtype)) for a in args))


class ExecCache:
    """Executables by key, each built once: concurrent requests for one key
    build it in one thread while the others wait (single flight), and
    ``compile_count`` counts the builds."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._built: dict = {}
        self._building: dict = {}  # key -> Event of the build in flight
        self.compile_count = 0

    def get(self, key, build):
        """The executable of ``key``, ``build()`` run for it once."""
        while True:
            with self._lock:
                cached = self._built.get(key)
                if cached is not None:
                    return cached
                flight = self._building.get(key)
                if flight is None:
                    flight = self._building[key] = threading.Event()
                    break  # this thread builds it
            flight.wait()
            # either the building thread cached the executable, or it failed and the
            # next iteration takes the build over
        try:
            executable = build()
            with self._lock:
                self._built[key] = executable
                self.compile_count += 1
            return executable
        finally:
            with self._lock:
                self._building.pop(key, None)
            flight.set()

    def count(self, attribute: str) -> int:
        """The sum of an executable attribute (0 where absent) over the built executables."""
        with self._lock:
            executables = list(self._built.values())
        return sum(getattr(e, attribute, 0) for e in executables)

    def stats(self) -> dict:
        """Executables built and CUDA graphs captured."""
        with self._lock:
            built = len(self._built)
        return {"executables": built, "graphs": self.count("graph_count")}


class LaunchDelta:
    """The hand-written kernels' launches one capture recorded. Opened before
    the capture; ``close()`` after it takes the delta and sets the counts
    back (a capture launches nothing; a kernel first registered after the
    opening counts from 0); ``replay()`` adds the delta, the launches a
    replay of the graph makes, to each kernel's count and to the program
    counter ``kernels.launches.<kernel name>`` (obs/metrics.py)."""

    def __init__(self) -> None:
        self._before = {k: (k.launches, dict(k.launches_by_variant)) for k in KERNELS}
        self.delta: list = []

    def close(self) -> LaunchDelta:
        for kernel in KERNELS:
            launches, by_variant = self._before.get(kernel, (0, {}))
            added = {v: n - by_variant.get(v, 0) for v, n in kernel.launches_by_variant.items()}
            if kernel.launches != launches:
                self.delta.append((kernel, kernel.launches - launches, {v: n for v, n in added.items() if n}))
            kernel.launches = launches
            for v in kernel.launches_by_variant:
                kernel.launches_by_variant[v] = by_variant.get(v, 0)
        return self

    def replay(self) -> None:
        counters = get_counters()
        for kernel, launches, by_variant in self.delta:
            kernel.launches += launches
            counters.inc(f"kernels.launches.{kernel.name}", launches)
            for v, n in by_variant.items():
                kernel.launches_by_variant[v] += n


def run_segment_major(executables: list, shards: list) -> None:
    """Run ``executables`` (one a data row, each on its shard of the
    arguments) segment by segment across them: segment k of every row is
    queued, then every row's flag for segment k + 1 is read, then segment
    k + 1 of every row. The host waits on the device once a decision, not
    once a decision a row, and each row still takes its own branch from its
    own flag. One executable is the plain case."""
    with torch.inference_mode():  # the static buffers are inference tensors
        for executable, args in zip(executables, shards):
            executable.begin(args)
        for k in range(len(executables[0].segments)):
            taken = [executable.decide(k) for executable in executables]
            for executable, branch in zip(executables, taken):
                executable.run(k, branch)


class EagerExecutable:
    """The program's segments run eagerly on ``device`` (host arguments are
    copied there first). ``eager_by_plan``: a card runs it eagerly because
    the mesh's layout puts the program across distinct devices
    (``parallel.mesh.capture_plan``). One call at a time (the engine's run
    lock): the state of the call in progress is the executable's."""

    def __init__(self, program: Program, model, device: torch.device, eager_by_plan: bool = False):
        self.program, self.model, self.device = program, model, torch.device(device)
        self.eager_by_plan = int(eager_by_plan)

    def begin(self, args) -> None:
        args = tuple(a.to(self.device) for a in args)
        if len(args) != len(self.program.inputs):
            raise TypeError(f"the program takes {self.program.inputs}, got {len(args)} arguments")
        self.segments = self.program.segments(self.model, args)
        self._state = dict(zip(self.program.inputs, args))

    def decide(self, k: int) -> bool:
        return decide(self.segments[k], self._state)

    def run(self, k: int, taken: bool) -> None:
        self._state = {**self._state, **self.segments[k].run(self._state, taken)}
        if k == len(self.segments) - 1:  # keep the outputs, not the call's intermediates
            self._state = {name: self._state[name] for name in self.program.outputs}

    @property
    def outputs(self) -> tuple[torch.Tensor, ...]:
        return tuple(self._state[name] for name in self.program.outputs)

    def __call__(self, args) -> tuple[torch.Tensor, ...]:
        run_segment_major([self], [args])
        return self.outputs


def _spec(updates: dict) -> dict:
    return {name: (tuple(v.shape), v.dtype) for name, v in updates.items()}


def capture_stream(streams: dict, device) -> torch.cuda.Stream:
    """The capture stream of ``device`` in ``streams`` (its owner's dict,
    filled on first use). ``torch.cuda.graph``'s default capture stream is
    made once, on the card current at the process's first capture, so a
    capture for another card on it fails; and graphs that share a memory
    pool reuse each other's freed blocks only when captured on one stream,
    so an owner captures all its graphs of a card on one stream."""
    device = _indexed(device)
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


def _indexed(device) -> torch.device:
    """``device`` with its index (``cuda`` is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _check_placement(model, device: torch.device) -> None:
    """A capture records one device's stream: every parameter and buffer of
    ``model`` (a module, a list of them, or None) must be on ``device``."""
    modules = [] if model is None else model if isinstance(model, list) else [model]
    elsewhere = {str(t.device) for m in modules for t in (*m.parameters(), *m.buffers()) if t.device != device}
    if elsewhere:
        raise RuntimeError(f"a capture on {device} would touch tensors on {sorted(elsewhere)}")


class GraphExecutable:
    """The program's segments captured as CUDA graphs for arguments shaped as
    ``args`` (whose values fill the static inputs for the warm-up pass).
    Calling it copies the arguments into the static inputs, then replays
    segment after segment, the host picking each branch from the flag the
    segment before left; it returns the static output buffers, which the
    next call overwrites. ``begin``, ``decide`` and ``run`` are the steps
    of a call, which ``run_segment_major`` interleaves across data rows.
    ``stream`` is the capture stream, a stream of ``device``
    (``capture_stream``)."""

    def __init__(self, program: Program, model, args, device: torch.device, pool, stream):
        self.device = _indexed(device)
        _check_placement(model, self.device)
        with torch.inference_mode(), torch.cuda.device(self.device):
            self.inputs = tuple(torch.empty(tuple(a.shape), dtype=a.dtype, device=self.device) for a in args)
            for buf, a in zip(self.inputs, args):
                buf.copy_(a)
            self.segments = program.segments(model, self.inputs)
            # each segment's results in the warm-up: the static buffers take
            # their shapes, types and strides (a copy in other strides could
            # change the kernels the next segment runs). The executable holds
            # every segment's buffers: a later segment may replace a name in
            # the state (``canvas``, ``cond``), but the earlier graphs still
            # write and read the buffer it had
            self._buffers = [{name: torch.empty_like(v) for name, v in outs.items()}
                             for outs in self._warm_up(program)]
            state = dict(zip(program.inputs, self.inputs))
            self._graphs: list[dict] = []
            for segment, buffers in zip(self.segments, self._buffers):
                spec = _spec(buffers)
                branches = {}
                for taken in segment.branches:
                    graph = torch.cuda.CUDAGraph()
                    counts = LaunchDelta()
                    try:
                        with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
                            updates = segment.run(state, taken)
                            if _spec(updates) != spec:
                                raise RuntimeError(f"segment {segment.decision} changed its outputs under capture")
                            for name in spec:
                                buffers[name].copy_(updates[name])
                            del updates  # the segment's intermediates go back to the pool
                    finally:
                        counts.close()
                    branches[taken] = (graph, counts)
                state.update(buffers)
                self._graphs.append(branches)
            self._state = state
            self.outputs = tuple(state[name] for name in program.outputs)
        self.graph_count = sum(len(b) for b in self._graphs)

    def _warm_up(self, program: Program) -> list[dict]:
        """Every branch of every segment once, eagerly, on a side stream;
        each segment's results on its first branch (both branches of a
        decision must leave the same names, shapes and types)."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        results = []
        with torch.cuda.stream(side):
            state = dict(zip(program.inputs, self.inputs))
            for segment in self.segments:
                outs = [segment.run(state, taken) for taken in segment.branches]
                if any(_spec(other) != _spec(outs[0]) for other in outs[1:]):
                    raise RuntimeError(f"the branches of {segment.decision} leave different outputs")
                results.append(outs[0])
                state = {**state, **outs[0]}
            del state, outs
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        return results

    def begin(self, args) -> None:
        with torch.cuda.device(self.device):
            for buf, a in zip(self.inputs, args):
                buf.copy_(a)

    def decide(self, k: int) -> bool:
        return decide(self.segments[k], self._state)

    def run(self, k: int, taken: bool) -> None:
        graph, counts = self._graphs[k][taken]
        with torch.cuda.device(self.device):  # a replay goes to the current device's stream
            graph.replay()
        counts.replay()

    def __call__(self, args) -> tuple[torch.Tensor, ...]:
        run_segment_major([self], [args])
        return self.outputs


class MeshExecutable:
    """A restore step over a mesh's data rows: one executable a row (a
    ``GraphExecutable`` on the row's home device, or an ``EagerExecutable``
    where the layout plan puts the row across distinct devices), each with
    its own replica, static inputs, segments and branches, run
    segment-major (``run_segment_major``). Calling it splits the host
    batch into equal shards, one a row, which each row copies into its own
    inputs, and gathers the rows' outputs into fixed buffers on ``primary``
    (the first slot, where the engine's one fetch reads them); the next
    call overwrites those."""

    def __init__(self, rows: list, primary: torch.device):
        self.rows, self.primary = rows, torch.device(primary)
        self.graph_count = sum(getattr(row, "graph_count", 0) for row in rows)
        self.eager_by_plan = sum(getattr(row, "eager_by_plan", 0) for row in rows)
        self._outputs: tuple | None = None

    def __call__(self, args) -> tuple[torch.Tensor, ...]:
        n = len(self.rows)
        if any(a.shape[0] % n for a in args):
            raise ValueError(f"batch {args[0].shape[0]} not divisible by {n} data rows")
        run_segment_major(self.rows, list(zip(*(a.chunk(n) for a in args))))
        parts = list(zip(*(row.outputs for row in self.rows)))
        with torch.inference_mode():
            if self._outputs is None:
                self._outputs = tuple(
                    torch.empty((n * p[0].shape[0], *p[0].shape[1:]), dtype=p[0].dtype, device=self.primary)
                    for p in parts)
            return tuple(gather(list(p), self.primary, out=buf) for p, buf in zip(parts, self._outputs))
