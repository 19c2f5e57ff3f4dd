"""RestorationEngine — owns the models and runs the device programs.

Counterpart of the single-device surfaces of
image_restoration_platform_tpu/serve/engine.py: ``restore_batch`` and
``restore_batch_async`` (the standard and the diffusion families),
``fuse_batch``, ``hdr_deblur_batch`` (the 16-bit PNG pre-pass), ``sr_batch``,
``sr_tiled``, and the boot-time ``warmup`` / ``warmup_serving``. Restore
batches are padded to a power-of-two bucket by repeating the last row; every
surface runs its program on the engine's device and fetches all outputs in
one synchronising device->host copy, which also carries the deblock and
deblur stages' per-image fire flags (counted under ``stage_fires.*``).
A synchronous call's device seconds on a card are its CUDA events' (``_run_sync``);
restore batches, which pipeline, and every call on the CPU or across cards
take the host clock, overlap-corrected across batches in flight.

With a ``mesh`` of more than one slot (parallel/mesh.py), ``restore_batch``
pads the bucket to a multiple of the data size and splits it over the data
slots, each running the program on its own model replica (column-parallel
over its tensor slots when the tensor axis is larger than 1); ``sr_tiled``
splits the tile axis over the data slots and blends once on the first slot;
``sr_spatial`` row-shards one canvas over the spatial slots. Every output
comes back to the first slot for the one fetch. The other surfaces run on the
first slot. A mesh of one slot is the single-device path.

With ``ServingConfig.fold_w`` (on by default in the port) the restore UNets,
and with ``fold_w_sr`` (off by default) the SR families, are served in the
W-folded layout (models/folded.py): ``model()`` folds the family's weights once,
``sr_batch``, ``sr_tiled`` (the mesh's too), ``restore_batch`` and
``fuse_batch`` take the folded module, a folded family has no space-to-depth
IO, and the fold is part of every executable's key. ``sr_spatial`` keeps the
unfolded weights: its halo exchange is defined on them.

The engine runs on ``device="cuda"`` (or its mesh's slots) unless the caller
asks for the CPU; it never falls back to the CPU by itself, and loading a
family on a card first checks the shapes its hand-written kernels will take
(``ModelFamily.check_kernel_shapes``).

Every single-device surface goes through the executable tier
(serve/exec_cache.py), as the reference's ``_aot_executable`` does: one
executable per structural key (``_exec_key``), built once under a
single-flight gate and counted in ``compile_count``. On a card an
executable is the program's segments, split at the three stage decisions,
captured as CUDA graphs and replayed; on the CPU it is the same segments run
eagerly. ``eager=True`` runs them eagerly on the card too, for comparisons;
a capture that fails raises. One lock (``_run_lock``) is held from the copy
into an executable's static inputs, through its replays and host flags, to
the enqueue of the packed copy of its outputs, so two batches in flight
never share the static buffers; a restore batch's fetch runs outside it, a
synchronous call's inside it (``_run_sync``).

Every call is traced (obs/tracing.py): ``engine.call`` with the program's
label, and under it ``engine.queue`` (the wait for the run lock),
``engine.launch`` (inputs, replays, ``_pack``) and ``engine.fetch``.

The mesh surfaces go through the same tier under the reference's tags,
which carry the mesh's shape (``_mesh_key``): ``("mesh", family, mesh)``
for ``restore_batch`` (one executable a data row, on the row's home device
with its own replica, replayed segment-major: serve/exec_cache.py
``MeshExecutable``), ``("sr_tiled_mesh", family, tile, overlap,
tile_batch, output, mesh)`` and ``("sr_spatial", family, canvas shape,
mesh)``, each captured whole. A program whose slots are distinct devices
runs eagerly under its key (``parallel.mesh.capture_plan``, decided from
the layout before any capture; ``exec_stats()["eager_executables"]``).
"""

from __future__ import annotations

import threading
import time
import uuid

import numpy as np
import torch

from ..config import ServingConfig
from ..models import ParamCache, get_family
from ..models.folded import folded_model
from ..models.nn import cast_for_compute
from ..obs.metrics import get_counters
from ..obs.tracing import device_trace, get_tracer
from ..ops.cuda.fetch import fetch
from ..parallel.mesh import AXIS_DATA, AXIS_SPATIAL, capture_plan
from ..parallel.sharding import replicate, shard_params
from ..utils.logging import get_logger
from .exec_cache import EagerExecutable, ExecCache, GraphExecutable, MeshExecutable, capture_stream, exec_key
from .programs import sr as sr_programs
from .programs.restore import STAGE_FIRES


def resolve_device(device: str | torch.device) -> torch.device:
    """The requested device; CUDA raises when no card is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port on the CPU"
        )
    return device


def uses_folded(family_name: str, config: ServingConfig) -> bool:
    """Whether an engine of ``config`` serves ``family_name`` in the W-folded
    layout (models/folded.py; ``ModelFamily.uses_folded``)."""
    return get_family(family_name).uses_folded(config)


def uses_s2d_io(family_name: str, config: ServingConfig) -> bool:
    """Whether an engine of ``config`` serves ``family_name`` with
    space-to-depth IO (``ModelFamily.uses_s2d_io``)."""
    return get_family(family_name).uses_s2d_io(config)


def _pack(tensors) -> torch.Tensor:
    """One flat byte buffer of the tensors, so a fetch is one device->host
    copy."""
    return torch.cat([t.contiguous().view(torch.uint8).reshape(-1) for t in tensors])


def _host(array: np.ndarray) -> torch.Tensor:
    """A host tensor over ``array`` (C-contiguous and writable, copied only
    where it is not), for an executable to copy to the device."""
    return torch.from_numpy(np.require(array, requirements=("C", "W")))


def _unpack(host: np.ndarray, tensors) -> list[np.ndarray]:
    """The arrays of ``_pack(tensors)`` fetched as ``host``, in the tensors'
    shapes and types."""
    arrays, offset = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        dtype = np.float32 if t.dtype == torch.float32 else np.uint8
        arrays.append(host[offset : offset + nbytes].view(dtype).reshape(tuple(t.shape)))
        offset += nbytes
    return arrays


def _batch_bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return b


class RestorationEngine:
    def __init__(
        self,
        device: str | torch.device | None = None,
        dtype: torch.dtype | None = None,
        serving_config: ServingConfig | None = None,
        param_cache: ParamCache | None = None,
        seed: int = 0,
        mesh=None,
        eager: bool = False,
    ):
        """``device`` defaults to "cuda", or with a ``mesh`` to its first
        slot (a device of another type raises). ``eager`` runs the programs
        eagerly on a card instead of replaying their CUDA graphs, to compare
        the two; on the CPU the programs always run eagerly."""
        if mesh is not None:
            if device is not None and torch.device(device).type != mesh.primary.type:
                raise ValueError(f"engine device {device} is not on the mesh's slots ({mesh.primary})")
            device = mesh.primary
        self.mesh = mesh  # None: the single-device path
        self.device = resolve_device("cuda" if device is None else device)
        # bf16 on the card, as the reference serves; f32 on the CPU, where
        # bf16 convolutions are slow and the tests compare in f32
        self.dtype = dtype or (torch.bfloat16 if self.device.type == "cuda" else torch.float32)
        if self.device.type == "cuda":
            # f32 means f32: no TF32 in cuDNN convolutions or in matmuls
            # (cuDNN's default would be TF32 for f32 convolutions)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.config = serving_config or ServingConfig()
        self.params_cache = param_cache or ParamCache(seed)
        self.logger = get_logger("engine")
        self._tracer = get_tracer("engine")
        self._models: dict[tuple, torch.nn.Module] = {}
        self._replicas: dict[tuple, list[torch.nn.Module]] = {}
        self._programs: dict = {}
        self._lock = threading.Lock()
        self.eager = eager
        self._exec_cache = ExecCache()
        self._run_lock = threading.Lock()  # static buffers: one executable runs at a time
        self._graph_pool = None  # every graph's memory pool, made at the first capture
        self._capture_streams: dict = {}  # one capture stream a card
        self.device_seconds_total = 0.0
        self._acct_lock = threading.Lock()
        self._device_busy_until = 0.0
        # one card's stream runs a synchronous call whole: its events time it
        self._events_time_calls = self.device.type == "cuda" and (
            mesh is None or len({str(d) for d in mesh.devices.flat}) == 1
        )
        self._events = None
        # the diffusion sampler's noise source, in place of a split PRNG key
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._rng_lock = threading.Lock()

    @property
    def compile_count(self) -> int:
        """Executables built (cache misses), as the reference counts its
        XLA compiles."""
        return self._exec_cache.compile_count

    def _account_device_time(self, t0: float) -> float:
        """Record a device-busy span [t0, now] on the host clock, clipped to
        start no earlier than the end of the previous span, so pipelined
        batches whose windows overlap never count the same time twice."""
        t_end = time.perf_counter()
        with self._acct_lock:
            start = max(t0, self._device_busy_until)
            device_s = max(t_end - start, 0.0)
            self._device_busy_until = t_end
            self.device_seconds_total += device_s
        return device_s

    def _call_events(self) -> list | None:
        """The engine's three timing events of a synchronous call on the card
        (its start, after ``_pack``, after the fetch), made on first use; or
        None where its device seconds take the host clock: on the CPU, and
        where the program spans cards. A call holds the run lock from its
        first record to reading them, so one set serves every call."""
        if not self._events_time_calls:
            return None
        if self._events is None:
            self._events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            for event in self._events:  # an event exists once recorded
                event.record(torch.cuda.current_stream(self.device))
        return self._events

    def _is_multi_device(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def _mesh_key(self) -> tuple:
        """The mesh's shape, the component of the mesh surfaces' keys."""
        if self.mesh is None:
            return ()
        return tuple(sorted(self.mesh.shape.items()))

    def _homes(self) -> list[torch.device]:
        """Each data row's first slot, where its shard of a batch goes."""
        return [self.mesh.tensor_slots(i)[0] for i in range(self.mesh.shape[AXIS_DATA])]

    # ----------------------------------------------------- models/programs

    def _uses_folded(self, family_name: str) -> bool:
        return uses_folded(family_name, self.config)

    def _uses_s2d_io(self, family_name: str) -> bool:
        return uses_s2d_io(family_name, self.config)

    def model(self, family_name: str, folded: bool | None = None) -> torch.nn.Module:
        """The family's model on this engine's device, conv and dense
        weights in the compute type: in the layout the engine serves it in
        (``folded=None``), or folded or not as asked. A folded model's
        weights are folded once, here (models/folded.py)."""
        folded = self._uses_folded(family_name) if folded is None else folded
        with self._lock:
            if (family_name, folded) not in self._models:
                family = get_family(family_name)
                if self.device.type == "cuda":
                    family.check_kernel_shapes(self.config.size_buckets, self.config.max_batch, self.dtype)
                state = self.params_cache.get(family_name)
                if folded:
                    m = folded_model(family.config, state)
                else:
                    m = family.build()
                    m.load_state_dict(state, strict=True)
                m = cast_for_compute(m, self.dtype, channels_last=self.device.type == "cuda")
                self._models[(family_name, folded)] = m.to(self.device).eval()
            return self._models[(family_name, folded)]

    def _data_replicas(self, family_name: str) -> list[torch.nn.Module]:
        """The family's model for each data row of the mesh, column-parallel
        over the row's tensor slots when the tensor axis is larger than 1."""
        model = self.model(family_name)
        with self._lock:
            key = ("data", family_name)
            if key not in self._replicas:
                self._replicas[key] = [
                    shard_params(model, self.mesh, i).eval() for i in range(self.mesh.shape[AXIS_DATA])
                ]
            return self._replicas[key]

    def _spatial_replicas(self, family_name: str) -> list[torch.nn.Module]:
        """The family's unfolded model on each spatial slot (the halo
        exchange is defined on unfolded weights, as in the reference)."""
        model = self.model(family_name, folded=False)
        with self._lock:
            key = ("spatial", family_name)
            if key not in self._replicas:
                self._replicas[key] = [replicate(model, d).eval() for d in self.mesh.slots(AXIS_SPATIAL)]
            return self._replicas[key]

    def _cached_program(self, key: tuple, build):
        with self._lock:
            if key not in self._programs:
                self._programs[key] = build()
            return self._programs[key]

    def _program(self, family_name: str, egress: str):
        from .programs import build_restore_program

        return self._cached_program(
            (family_name, egress),
            lambda: build_restore_program(
                family_name,
                dtype=self.dtype,
                use_folded=self._uses_folded(family_name),
                use_s2d_io=self._uses_s2d_io(family_name),
                use_deblur=self.config.deblur,
                use_deblock=self.config.deblock,
                egress=egress,
            ),
        )

    # ---------------------------------------------------- executable tier

    def _exec_key(self, tag, args, egress: str | None = None) -> tuple:
        """The executable's key: the tag, the flags that change the
        program's structure (the W-fold changes the model's layout and
        weights, the gated stages add or remove segments, s2d IO changes the
        backbone's layout), the egress, then the arguments' shapes and
        types. The HDR pre-pass has no such structure."""
        family_name = tag if isinstance(tag, str) else tag[1]
        if isinstance(tag, tuple) and tag[0] == "hdr_deblur":
            structural: tuple = ()
        else:
            structural = (
                ("fold_w", self._uses_folded(family_name)),
                ("stages", self.config.deblur, self.config.deblock),
                ("s2d_io", self._uses_s2d_io(family_name)),
            )
        if egress is not None:
            structural += (("egress", egress),)
        return exec_key(tag, structural, args)

    def _executable(self, tag, args, program, model, egress: str | None = None, across_devices: bool = False):
        """The executable of ``program`` for ``args`` (host tensors), built
        on first use (single flight, counted in ``compile_count``);
        ``across_devices``: the layout plan puts the program's slots on
        distinct devices."""
        return self._exec_cache.get(
            self._exec_key(tag, args, egress), lambda: self._build(program, model, args, across_devices=across_devices)
        )

    def _build(self, program, model, args, home: torch.device | None = None, across_devices: bool = False):
        """``program``'s executable on ``home`` (the engine's device by
        default): CUDA graphs on a card, its segments run eagerly on the
        CPU, with ``eager=True``, or where the program spans devices."""
        home = self.device if home is None else home
        if self.device.type != "cuda" or self.eager:
            return EagerExecutable(program, model, home)
        if across_devices:
            self.logger.warning("a mesh program runs eagerly: its slots are distinct devices",
                                {"mesh": repr(self.mesh), "home": str(home)})
            return EagerExecutable(program, model, home, eager_by_plan=True)
        with self._run_lock:  # no replay may run while a capture allocates from the shared pool
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            return GraphExecutable(program, model, args, home, self._graph_pool,
                                   capture_stream(self._capture_streams, home))

    def _mesh_executable(self, family_name: str, program, args, egress: str):
        """The restore step of ``args`` (the whole bucket) over the data
        rows: one executable a row, each on its row's home device with the
        row's replica (serve/exec_cache.py ``MeshExecutable``)."""
        replicas = self._data_replicas(family_name)

        def build():
            shards = list(zip(*(a.chunk(len(replicas)) for a in args)))
            rows = [self._build(program, replica, shard, home, across_devices=one is None)
                    for replica, shard, home, one in zip(replicas, shards, self._homes(), capture_plan(self.mesh).rows)]
            return MeshExecutable(rows, self.device)

        tag = ("mesh", family_name, self._mesh_key())
        return self._exec_cache.get(self._exec_key(tag, args, egress), build)

    def exec_stats(self) -> dict:
        """compile_count, the executables built and the CUDA graphs
        captured; on a mesh also the executables (or data rows of one) that
        a card runs eagerly because their slots are distinct devices."""
        stats = {"compile_count": self.compile_count, **self._exec_cache.stats()}
        if self.mesh is not None:
            stats["eager_executables"] = self._exec_cache.count("eager_by_plan")
        return stats

    # ------------------------------------------------------------ serving

    def restore_batch(
        self,
        canvas_u8: np.ndarray,
        valid_hw: np.ndarray | None = None,
        is_jpeg: np.ndarray | None = None,
        family_name: str = "restore-unet",
        egress: str = "rgb",
    ):
        """Synchronous ``restore_batch_async(...)()``: (restored [N,B,B,3] u8
        or the (Y, Cb, Cr) plane batch, scores [N,7], meta)."""
        return self.restore_batch_async(canvas_u8, valid_hw, is_jpeg, family_name, egress)()

    def restore_batch_async(
        self,
        canvas_u8: np.ndarray,
        valid_hw: np.ndarray | None = None,
        is_jpeg: np.ndarray | None = None,
        family_name: str = "restore-unet",
        egress: str = "rgb",
        trace_ids: tuple[str, ...] = (),
    ):
        """Copy the batch to the device and launch the restore program;
        returns a fetch() closure that synchronises and returns (out, scores
        [N,7], meta). The stages' host branches synchronise inside the
        launch (ops/deblock.py, ops/deblur.py), so the launch returns once
        the last of them is decided, with the backbone still queued. On a
        mesh the bucket is padded to a multiple of the data size and each
        data slot runs its shard. The diffusion family has RGB egress only
        and draws its sampler's noise (for the whole bucket) from the
        engine's seeded generator. The batch's ``engine.call`` span runs
        from the launch to the end of the fetch and carries ``trace_ids``,
        the traces of the requests it serves (the batcher's)."""
        n = canvas_u8.shape[0]
        if valid_hw is None:
            valid_hw = np.tile(np.asarray([canvas_u8.shape[1], canvas_u8.shape[2]], np.int32), (n, 1))
        if is_jpeg is None:
            is_jpeg = np.zeros((n,), dtype=np.float32)
        valid_hw = np.asarray(valid_hw, dtype=np.int32)
        is_jpeg_f = np.asarray(is_jpeg, dtype=np.float32)

        dp = self.mesh.shape[AXIS_DATA] if self._is_multi_device() else 1
        bucket = _batch_bucket(n, self.config.max_batch)
        if dp > 1:  # at least one image a data slot, and a multiple of them
            bucket = -(-max(bucket, dp) // dp) * dp
        if bucket > n:
            pad = bucket - n
            canvas_u8 = np.concatenate([canvas_u8, np.repeat(canvas_u8[-1:], pad, axis=0)], axis=0)
            valid_hw = np.concatenate([valid_hw, np.repeat(valid_hw[-1:], pad, axis=0)], axis=0)
            is_jpeg_f = np.concatenate([is_jpeg_f, np.repeat(is_jpeg_f[-1:], pad, axis=0)], axis=0)

        diffusion = get_family(family_name).kind == "diffusion"
        if diffusion:
            egress = "rgb"  # the diffusion program has no plane egress
        model = self.model(family_name)
        program = self._program(family_name, egress)
        # batches by family kind and size: the counts a run holds kernel
        # launches to (one UNet forward per restore batch, sample_steps per
        # diffusion batch)
        kind = "diffusion_batches" if diffusion else "restore_batches"
        get_counters().inc(f"{kind}.{canvas_u8.shape[1]}")
        trace_label = f"restore/{family_name}/{canvas_u8.shape[1]}x{canvas_u8.shape[2]}b{bucket}"
        call = self._tracer.start_span("engine.call", {"engine.program": trace_label,
                                                       "engine.trace_ids": ",".join(trace_ids)})
        t0 = time.perf_counter()
        with device_trace(trace_label):
            args = (_host(canvas_u8), torch.from_numpy(valid_hw), torch.from_numpy(is_jpeg_f))
            if diffusion:
                with self._rng_lock:  # drawn outside any graph, copied into its static input
                    noise = torch.randn(
                        tuple(args[0].shape), generator=self._generator, device=self.device, dtype=self.dtype
                    )
                args += (noise,)
            if dp == 1:
                executable = self._executable(family_name, args, program, model, egress)
            else:
                executable = self._mesh_executable(family_name, program, args, egress)
            with self._tracer.span("engine.queue", parent=call):
                self._run_lock.acquire()
            try:
                with self._tracer.span("engine.launch", parent=call):
                    outs = executable(args)  # (*out, scores, flags)
                    packed = _pack(outs)
            finally:
                self._run_lock.release()

        def fetch():
            with self._tracer.span("engine.fetch", parent=call):
                t_fetch = time.perf_counter()
                host = packed.cpu().numpy()
            self._tracer.end_span(call)
            wall_s = time.perf_counter() - t0
            device_s = self._account_device_time(t0)
            *arrays, scores_h, flags_h = (a[:n] for a in _unpack(host, outs))
            counters = get_counters()
            for name, count in zip(STAGE_FIRES, flags_h.sum(axis=0, dtype=np.int64)):
                counters.inc(f"stage_fires.{name}", int(count))
            meta = {
                "engineRequestId": uuid.uuid4().hex,
                "deviceSeconds": device_s,
                "wallSeconds": wall_s,
                "fetchSeconds": time.perf_counter() - t_fetch,
                "batchBucket": bucket,
                "batchOccupancy": n / bucket,
                "family": family_name,
            }
            if len(arrays) > 1:  # yuv420 plane egress
                return tuple(arrays), scores_h, meta
            return arrays[0], scores_h, meta

        return fetch

    # ------------------------------------------- fusion, super-resolution

    def _run_sync(self, label: str, run, family_name: str, **extra):
        """Run a device program under the run lock, fetch its outputs in one
        synchronising copy and assemble the standard meta. ``run()`` returns
        a tuple of tensors; so does this, as arrays.

        The lock is held through the fetch, so on a card the call's work is
        one unbroken stretch of the stream (the next call's input copy and
        replay cannot land between this call's ``_pack`` and its copy): CUDA
        events at its start, after ``_pack`` and right behind the copy
        (ops/cuda/fetch.py) give ``deviceSeconds`` (start to fetched) and the
        fetch's part of it, added to the counters
        ``engine.device_s.<kind>`` and ``engine.fetch_s.<kind>`` (``kind``:
        the label's first part, e.g. ``sr_tiled``). On the CPU and across
        cards ``deviceSeconds`` is the host clock's (``_account_device_time``)
        and the fetch's part the host's wait for the copy, which
        ``fetchSeconds`` is everywhere.

        On one card the copy lands in a page-locked block of the fetch's
        cache, counted under ``engine.fetch_pinned.<kind>``, and the arrays
        returned are views of it: the block is not lent to another call
        until every one of them is gone. On the CPU and across cards they
        are views of a host tensor of their own."""
        kind = label.split("/", 1)[0]
        with self._tracer.span("engine.call", {"engine.program": label}):
            t0 = time.perf_counter()
            with self._tracer.span("engine.queue"):
                self._run_lock.acquire()
            try:
                # the profiler's label opens once the lock is held: its range
                # then spans this call's own work, however long the queue
                with device_trace(label):
                    events = self._call_events()
                    stream = torch.cuda.current_stream(self.device) if events else None
                    with self._tracer.span("engine.launch"):
                        if events:
                            events[0].record(stream)
                        outs = run()
                        packed = _pack(outs)
                        if events:
                            events[1].record(stream)
                    with self._tracer.span("engine.fetch"):
                        t_fetch = time.perf_counter()
                        if events:
                            host = fetch(packed, stream, events[2])
                            device_s = events[0].elapsed_time(events[2]) * 1e-3
                            fetch_device_s = events[1].elapsed_time(events[2]) * 1e-3
                        else:
                            host = packed.cpu().numpy()
                        arrays = _unpack(host, outs)
                        fetch_s = time.perf_counter() - t_fetch
            finally:
                self._run_lock.release()
            if events:
                with self._acct_lock:
                    self.device_seconds_total += device_s
            else:
                device_s, fetch_device_s = self._account_device_time(t0), fetch_s
        counters = get_counters()
        counters.inc(f"engine.device_s.{kind}", device_s)
        counters.inc(f"engine.fetch_s.{kind}", fetch_device_s)
        if events:
            counters.inc(f"engine.fetch_pinned.{kind}")
        meta = {
            "engineRequestId": uuid.uuid4().hex,
            "deviceSeconds": device_s,
            "fetchSeconds": fetch_s,
            "family": family_name,
            **extra,
        }
        return tuple(arrays), meta

    def _run_executable(self, label: str, tag, program, model, args, family_name: str, across_devices: bool = False,
                        **extra):
        """``_run_sync`` of the executable of ``tag`` for ``args``."""
        executable = self._executable(tag, args, program, model, across_devices=across_devices)
        return self._run_sync(label, lambda: executable(args), family_name, **extra)

    def fuse_batch(
        self,
        canvas_u8: np.ndarray,
        valid_hw: np.ndarray,
        is_jpeg: np.ndarray,
        family_name: str = "restore-unet",
    ) -> tuple[np.ndarray, np.ndarray, dict]:
        """Multi-image fusion: restore K aligned exposures [K,B,B,3] (K <= 3,
        not padded to a batch bucket) and composite them with weights from
        their degradation scores, in one device program. Returns (fused
        [B,B,3] u8, scores [K,7], meta)."""
        from .programs import build_fusion_program

        k = canvas_u8.shape[0]
        model = self.model(family_name)
        program = self._cached_program(
            ("fusion", family_name),
            lambda: build_fusion_program(family_name, dtype=self.dtype, use_folded=self._uses_folded(family_name)),
        )
        get_counters().inc(f"fusion_batches.{canvas_u8.shape[1]}")
        args = (
            _host(canvas_u8),
            torch.from_numpy(np.asarray(valid_hw, np.int32)),
            torch.from_numpy(np.asarray(is_jpeg, np.float32)),
        )
        (fused, scores), meta = self._run_executable(
            f"fuse/{family_name}/k{k}/{canvas_u8.shape[1]}", ("fusion", family_name), program, model, args,
            family_name, fusionInputs=k,
        )
        return fused, scores, meta

    def hdr_deblur_batch(
        self, x_f32: np.ndarray, valid_hw: np.ndarray, compression: np.ndarray
    ) -> tuple[np.ndarray, dict]:
        """Float Wiener deblur with the disk channel on: the 16-bit PNG
        pre-pass (ops/deblur.py deblur_canvas_f32, as the segments of
        ``build_hdr_deblur_program``). x_f32 [N,B,B,3] in [0, 1], before any
        8-bit quantization."""
        from .programs import build_hdr_deblur_program

        program = self._cached_program(("hdr_deblur",), build_hdr_deblur_program)
        args = (
            _host(np.asarray(x_f32, np.float32)),
            torch.from_numpy(np.asarray(valid_hw, np.int32)),
            torch.from_numpy(np.asarray(compression, np.float32)),
        )
        (out,), meta = self._run_executable(
            f"hdr_deblur/{x_f32.shape[1]}", ("hdr_deblur", x_f32.shape[1]), program, None, args, "hdr_deblur"
        )
        return out, meta

    def sr_batch(self, imgs_u8: np.ndarray, family_name: str = "sr-x2") -> tuple[np.ndarray, dict]:
        """Super-resolution batch [N,H,W,3] u8 -> [N,H*scale,W*scale,3] u8
        (no conditioning, no tiling)."""
        model = self.model(family_name)
        program = self._program(family_name, "rgb")
        get_counters().inc(f"sr_batches.{imgs_u8.shape[1]}")
        (out,), meta = self._run_executable(
            f"sr/{family_name}/{imgs_u8.shape[1]}x{imgs_u8.shape[2]}", ("sr", family_name), program, model,
            (_host(imgs_u8),), family_name,
        )
        return out, meta

    def sr_tiled(
        self,
        canvas_u8: np.ndarray,
        family_name: str = "sr-x2",
        tile: int = sr_programs.TILE,
        overlap: int = sr_programs.OVERLAP,
        tile_batch: int = sr_programs.TILE_BATCH,
        output: str = "rgb",
    ) -> tuple[np.ndarray, dict]:
        """Tiled super-resolution of one [H,W,3] u8 canvas with seam-free
        overlap-blend (2K -> 4K): tile extraction, batched SRNet calls over
        tile chunks and one windowed fold, all on the device; on a mesh the
        tile chunks are split over the data slots. Returns the
        [H*scale,W*scale,3] u8 canvas, or with ``output="yuv420"`` its
        (Y, Cb, Cr) u8 planes."""
        from .programs import build_sr_tiled_mesh_program, build_sr_tiled_program

        size = canvas_u8.shape[0]
        get_counters().inc(f"sr_tiled_calls.{size}")
        label = f"sr_tiled/{family_name}/{size}t{tile}"
        if self._is_multi_device():
            models = self._data_replicas(family_name)
            tag = ("sr_tiled_mesh", family_name, tile, overlap, tile_batch, output)
            program = self._cached_program(
                tag,
                lambda: build_sr_tiled_mesh_program(
                    family_name, dtype=self.dtype, use_folded=self._uses_folded(family_name), slots=self._homes(),
                    tile=tile, overlap=overlap, tile_batch=tile_batch, output=output,
                ),
            )
            outs, meta = self._run_executable(
                label, (*tag, self._mesh_key()), program, models, (_host(canvas_u8),), family_name,
                across_devices=capture_plan(self.mesh).grid is None, tile=tile, overlap=overlap,
            )
        else:
            tag = ("sr_tiled", family_name, tile, overlap, tile_batch, output)
            program = self._cached_program(
                tag,
                lambda: build_sr_tiled_program(
                    family_name, dtype=self.dtype, use_folded=self._uses_folded(family_name), tile=tile,
                    overlap=overlap, tile_batch=tile_batch, output=output,
                ),
            )
            outs, meta = self._run_executable(
                label, tag, program, self.model(family_name), (_host(canvas_u8),), family_name,
                tile=tile, overlap=overlap,
            )
        return (outs if output == "yuv420" else outs[0]), meta

    def sr_spatial(self, canvas_u8: np.ndarray, family_name: str = "sr-x2") -> tuple[np.ndarray, dict]:
        """Super-resolve ONE [H,W,3] u8 canvas row-sharded over the mesh's
        spatial slots, a one-row halo exchanged at every convolution
        (parallel/halo.py), the limiter run on the gathered canvas. Rows are
        padded by repeating the last one to a multiple of the spatial size
        and the output cropped back: the result is the single-device
        forward of the padded canvas, cropped, up to convolution round-off.
        meta adds ``spatialShards``, ``halo`` (the receptive field in input
        rows) and ``paddedRows``. Only SRNet families row-shard: the halo
        exchange is defined on convolutions."""
        from .programs import build_sr_spatial_program

        if not get_family(family_name).row_shards:
            raise ValueError(f"sr_spatial row-shards SRNet families only; model family {family_name!r} "
                             "has no row-sharded form (its halo exchange covers convolutions only)")
        if self.mesh is None or self.mesh.shape[AXIS_SPATIAL] <= 1:
            raise ValueError("sr_spatial requires a mesh with a spatial axis > 1")
        program, halo, scale, sp = self._cached_program(
            ("sr_spatial", family_name),
            lambda: build_sr_spatial_program(family_name, dtype=self.dtype, mesh=self.mesh),
        )
        h_in = canvas_u8.shape[0]
        pad_rows = (-h_in) % sp
        if pad_rows:
            canvas_u8 = np.concatenate([canvas_u8, np.repeat(canvas_u8[-1:], pad_rows, axis=0)], axis=0)
        h = canvas_u8.shape[0]
        models = self._spatial_replicas(family_name)
        get_counters().inc(f"sr_spatial_calls.{h}")
        (out,), meta = self._run_executable(
            f"sr_spatial/{family_name}/{h}", ("sr_spatial", family_name, canvas_u8.shape, self._mesh_key()), program,
            models, (_host(canvas_u8),), family_name, across_devices=capture_plan(self.mesh).spatial is None,
            spatialShards=sp, halo=halo, paddedRows=pad_rows,
        )
        return (out[: h_in * scale] if pad_rows else out), meta

    def warmup(self, family_name="restore-unet", sizes=None, batches=None) -> float:
        """Run the restore programs once per serving bucket (serve/warmup.py)."""
        from .warmup import warmup_restore

        return warmup_restore(self, family_name, sizes, batches)

    def warmup_serving(self, families=("restore-unet",), sizes=None, batches=None,
                       fusion_k=(3,), sr_tiled_canvas=None) -> dict:
        """Run every serving surface ``families`` names once, so no endpoint
        pays the first launch's kernel builds and cuDNN plan searches in a
        request (serve/warmup.py)."""
        from .warmup import warmup_serving

        return warmup_serving(self, families, sizes, batches, fusion_k, sr_tiled_canvas)
