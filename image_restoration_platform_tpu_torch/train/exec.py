"""The trainer's executables on a card: the train step and each data
distribution's draw as CUDA graphs.

Counterpart of the reference's two compiled programs outside serving:
``jax.jit(train_step)`` (image_restoration_platform_tpu/train/trainer.py)
and ``synthetic_batch`` jitted once per ``DataConfig``
(image_restoration_platform_tpu/train/data.py). ``Trainer`` builds them
through serve/exec_cache.py's ``ExecCache`` (``exec_key``, the single-flight
gate, ``compile_count``), one graph memory pool per trainer, and runs the
same step and draw eagerly under the same keys on the CPU, with
``eager=True`` and for a mesh that one capture cannot hold
(``EagerStep``):

- ``TrainGraph``: one step (``TrainStep.update``: forward, loss, backward,
  global-norm clip, fused AdamW; under a mesh every data row's forward and
  backward, the copies' gradients summed into the model's, the process
  group's collectives, and the updated parameters copied into the
  replicas) captured whole, after
  PyTorch's recipe for capturing a network: static inputs for the batch
  (degraded, clean, cond, anchor); gradients (the replicas' too)
  allocated before the capture and zeroed inside it, never set to
  ``None``; warm-up steps on a side stream (the kernels' builds, cuDNN and
  cuBLAS plans, the optimizer's state, an NCCL group's communicator) whose
  updates are undone before the capture, the replicas' with the model's,
  so the trainer's state is what it was; the loss written into a static
  buffer. The host
  part of a step (``TrainStep.prepare``: the schedule's lr into the
  optimizer's device tensor, the step's noise seed) runs before every
  replay. The diffusion branches' generator is registered with the graph,
  so a replay draws the numbers an eager step would from the seed the host
  set. ``LaunchDelta`` adds the attention launches the capture recorded to
  the kernel's count on every replay;
- ``DataGraph``: one ``synthetic_batch`` draw captured with the trainer's
  data generator registered, so replays continue its stream exactly as
  eager draws would; the outputs are static buffers.

A trainer captures all its graphs on one capture stream of its card
(serve/exec_cache.py ``capture_stream``). Every graph's results are copied
into buffers outside the pool (the gradients, the optimizer's state and the
parameters were never in it), so
nothing a graph leaves behind lives there, and the trainer replays one
graph at a time, in any order.
"""

from __future__ import annotations

import torch

from ..serve.exec_cache import LaunchDelta

# steps run eagerly on a side stream before a capture, their updates undone
WARMUP_STEPS = 2


def _side_stream_run(device: torch.device, fn, times: int):
    """``fn()`` ``times`` times on a side stream, as a capture needs its
    lazily made state made first; returns the last result."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(times):
            out = fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    return out


class EagerStep:
    """The train step of ``step`` on ``state`` run eagerly under its key.
    ``eager_by_plan``: a card runs it eagerly because one capture cannot
    hold the mesh step (``Trainer._eager_by_plan``)."""

    graph_count = 0

    def __init__(self, step, state, eager_by_plan: bool = False):
        self.step, self.state, self.eager_by_plan = step, state, int(eager_by_plan)

    def __call__(self, batch) -> torch.Tensor:
        return self.step(self.state, *batch)


class TrainGraph:
    """The train step of ``step`` on ``state`` captured as one CUDA graph
    for batches shaped as ``batch``. Calling it with a batch
    copies it into the static inputs, runs the step's host part, replays
    and advances ``state.step``; it returns the static loss buffer, which
    the next call overwrites."""

    graph_count = 1

    def __init__(self, step, state, batch, pool, stream):
        device = step.device
        self.step, self.state = step, state
        optimizer = state.optimizer
        step.allocate_grads_(state)
        with torch.cuda.device(device):
            self.inputs = tuple(torch.empty(tuple(a.shape), dtype=a.dtype, device=device) for a in batch)
            for buf, a in zip(self.inputs, batch):
                buf.copy_(a)
            params = [p for group in optimizer.param_groups for p in group["params"]]
            with torch.no_grad():
                kept = [p.clone() for p in params]
                moments = {p: {k: v.clone() for k, v in optimizer.state[p].items()} for p in params}

            def warm_step():
                step.prepare(state)
                return step.update(state, *self.inputs)

            self.loss = torch.empty_like(_side_stream_run(device, warm_step, WARMUP_STEPS))
            with torch.no_grad():  # the warm-up's updates undone: the state is what it was
                for p, value in zip(params, kept):
                    p.copy_(value)
                for p in params:
                    for key, value in optimizer.state[p].items():
                        if key in moments[p]:
                            value.copy_(moments[p][key])
                        else:  # made by the warm-up: a fresh optimizer's zeros
                            value.zero_()
                step.sync_replicas(state)  # the copies of the model hold its restored parameters
            del kept, moments
            self.graph = torch.cuda.CUDAGraph()
            if step.is_diffusion:
                self.graph.register_generator_state(step.noise_gen)
            step.prepare(state)
            counts = LaunchDelta()
            try:
                with torch.cuda.graph(self.graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
                    self.loss.copy_(step.update(state, *self.inputs))
            finally:
                self.counts = counts.close()

    def __call__(self, batch) -> torch.Tensor:
        for buf, a in zip(self.inputs, batch):
            buf.copy_(a)
        self.step.prepare(self.state)
        self.graph.replay()
        self.counts.replay()
        self.state.step += 1
        return self.loss


class DataGraph:
    """``draw()`` (one ``synthetic_batch`` call on ``gen``) captured as one
    CUDA graph. Calling it replays the draw and returns the static output
    buffers, which the next call overwrites; ``gen`` advances as an eager
    draw advances it."""

    graph_count = 1

    def __init__(self, draw, gen: torch.Generator, pool, stream):
        device = gen.device
        with torch.cuda.device(device):
            before = gen.get_state()
            self.outputs = tuple(torch.empty_like(o) for o in _side_stream_run(device, draw, 1))
            gen.set_state(before)  # the warm-up's draw undone
            self.graph = torch.cuda.CUDAGraph()
            self.graph.register_generator_state(gen)
            with torch.cuda.graph(self.graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
                for buf, out in zip(self.outputs, draw()):
                    buf.copy_(out)

    def __call__(self) -> tuple[torch.Tensor, ...]:
        self.graph.replay()
        return self.outputs
