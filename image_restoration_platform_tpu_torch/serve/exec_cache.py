"""The engine's executable tier: one executable per structural key, built once.

Counterpart of image_restoration_platform_tpu/serve/exec_cache.py and of the
executable tier of that package's engine (``_exec_key``, the single-flight
``_aot_executable``, ``compile_count``). There an executable is a compiled
XLA program; here, on a card, it is a program's segments
(serve/programs/segments.py) captured as CUDA graphs, one per segment and
branch, replayed with the host reading the stage flags between them:

- ``exec_key``: the tag, the structural flags, then the arguments' shapes
  and types (the port has no W-fold, so no ``fold_w``);
- ``ExecCache``: the in-memory executables, the single-flight gate (one
  thread builds a key, the others wait for it) and ``compile_count``;
- ``GraphExecutable``: static input buffers; a warm-up pass on a side
  stream that runs every branch of every segment once, so the kernels'
  nvcc builds, cuFFT and cuDNN plans, lazily loaded modules and every
  device constant (the stages' matrices, the blend's window and origin
  arrays) exist before capture; one capture per segment and branch, each
  writing its results into static buffers that both branches share; replay.
  A capture launches no kernel, so the launch counts of the hand-written
  kernels (``FlashKernel.launches``, ``BlendKernel.launches``, counted in
  Python where they launch) are set back after it, and every replay adds
  the launches its graph holds;
- ``EagerExecutable``: the segments run eagerly under the same key. It is
  the executable on the CPU, where nothing is captured (so the key, the
  single-flight gate and the branch selection are all exercised there), and
  on the card only for an engine built with ``eager=True`` to compare
  replay with eager execution. A capture that fails raises; nothing falls
  back to eager execution.

No disk tier: a CUDA graph holds one process's device addresses and cannot
be serialised. What does persist across processes is the kernels' nvcc
builds (``build/kernels``, ops/cuda/build.py).

Every graph of an engine shares one memory pool: a segment's results are
copied into buffers outside the pool, so nothing a graph leaves behind
lives in it, and the engine replays one executable at a time, so any order
of replays is safe. The warm-up captures the largest shapes first, so the
smaller graphs after them take blocks the larger ones left in the pool.
"""

from __future__ import annotations

import threading

import torch

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

    def stats(self) -> dict:
        """Executables built and CUDA graphs captured."""
        with self._lock:
            executables = list(self._built.values())
        return {"executables": len(executables),
                "graphs": sum(getattr(e, "graph_count", 0) for e in executables)}


def _kernels() -> tuple:
    from ..ops.cuda.attention import flash_kernel
    from ..ops.cuda.blend import blend_kernel

    return (flash_kernel, blend_kernel)


class LaunchDelta:
    """The hand-written kernels' launches one capture recorded. Opened before
    the capture; ``close()`` after it takes the delta and sets the counts
    back (a capture launches nothing); ``replay()`` adds the delta, the
    launches a replay of the graph makes."""

    def __init__(self) -> None:
        self._before = [(k, k.launches, dict(k.launches_by_variant)) for k in _kernels()]
        self.delta: list = []

    def close(self) -> LaunchDelta:
        for kernel, launches, by_variant in self._before:
            added = {v: n - by_variant.get(v, 0) for v, n in kernel.launches_by_variant.items()}
            if kernel.launches != launches:
                self.delta.append((kernel, kernel.launches - launches, {v: n for v, n in added.items() if n}))
            kernel.launches = launches
            for v in kernel.launches_by_variant:
                kernel.launches_by_variant[v] = by_variant.get(v, 0)
        return self

    def replay(self) -> None:
        for kernel, launches, by_variant in self.delta:
            kernel.launches += launches
            for v, n in by_variant.items():
                kernel.launches_by_variant[v] += n


class EagerExecutable:
    """The program's segments run eagerly on ``device`` (host arguments are
    copied there first)."""

    def __init__(self, program: Program, model, device: torch.device):
        self.program, self.model, self.device = program, model, torch.device(device)

    def __call__(self, args) -> tuple[torch.Tensor, ...]:
        return self.program.run(self.model, tuple(a.to(self.device) for a in args))[1]


def _spec(updates: dict) -> dict:
    return {name: (tuple(v.shape), v.dtype) for name, v in updates.items()}


class GraphExecutable:
    """The program's segments captured as CUDA graphs for arguments shaped as
    ``args`` (whose values fill the static inputs for the warm-up pass).
    Calling it copies the arguments into the static inputs, then replays
    segment after segment, the host picking each branch from the flag the
    segment before left; it returns the static output buffers, which the
    next call overwrites."""

    def __init__(self, program: Program, model, args, device: torch.device, pool):
        self.device = torch.device(device)
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
                        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
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

    def __call__(self, args) -> tuple[torch.Tensor, ...]:
        with torch.inference_mode():  # the static buffers are inference tensors
            for buf, a in zip(self.inputs, args):
                buf.copy_(a)
            for segment, branches in zip(self.segments, self._graphs):
                graph, counts = branches[decide(segment, self._state)]
                graph.replay()
                counts.replay()
        return self.outputs
