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
Device seconds are overlap-corrected across pipelined batches.

With a ``mesh`` of more than one slot (parallel/mesh.py), ``restore_batch``
pads the bucket to a multiple of the data size and splits it over the data
slots, each running the program on its own model replica (column-parallel
over its tensor slots when the tensor axis is larger than 1); ``sr_tiled``
splits the tile axis over the data slots and blends once on the first slot;
``sr_spatial`` row-shards one canvas over the spatial slots. Every output
comes back to the first slot for the one fetch. The other surfaces run on the
first slot. A mesh of one slot is the single-device path.

The engine runs on ``device="cuda"`` (or its mesh's slots) unless the caller
asks for the CPU; it never falls back to the CPU by itself, and loading a
family on a card first checks the attention shapes it will launch
(``models.registry.check_attention_shapes``). The executable disk cache
(serve/exec_cache.py) has no counterpart: it stores compiled XLA
executables, and an eager program has none.
"""

from __future__ import annotations

import threading
import time
import uuid

import numpy as np
import torch

from ..config import ServingConfig
from ..models import ParamCache, get_family
from ..models.nn import cast_for_compute
from ..models.registry import check_attention_shapes
from ..obs.metrics import get_counters
from ..obs.tracing import device_trace, get_tracer
from ..parallel.mesh import AXIS_DATA, AXIS_SPATIAL
from ..parallel.sharding import gather, replicate, shard_params, split_batch
from ..utils.logging import get_logger
from .programs.restore import STAGE_FIRES


def resolve_device(device: str | torch.device) -> torch.device:
    """The requested device; CUDA raises when no card is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port on the CPU"
        )
    return device


def uses_s2d_io(family_name: str, config: ServingConfig) -> bool:
    """Whether an engine of ``config`` serves ``family_name`` with
    space-to-depth IO (the s2d-stem UNets with RGB in and out)."""
    if not config.s2d_io:
        return False
    cfg = get_family(family_name).config
    return (
        getattr(cfg, "input_scale", 1) > 1
        and getattr(cfg, "in_channels", 0) == getattr(cfg, "out_channels", -1)
        and not getattr(cfg, "time_conditioned", False)
    )


def _pack(tensors) -> torch.Tensor:
    """One flat byte buffer of the tensors, so a fetch is one device->host
    copy."""
    return torch.cat([t.contiguous().view(torch.uint8).reshape(-1) for t in tensors])


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


def _fire_flags(fires: dict, rows: int, device: torch.device) -> torch.Tensor:
    """[rows, len(STAGE_FIRES)] u8 of the stages' fire masks (0 where a
    stage did not run)."""
    zeros = torch.zeros(rows, dtype=torch.bool, device=device)
    return torch.stack([fires.get(name, zeros) for name in STAGE_FIRES], dim=1).to(torch.uint8)


class RestorationEngine:
    def __init__(
        self,
        device: str | torch.device | None = None,
        dtype: torch.dtype | None = None,
        serving_config: ServingConfig | None = None,
        param_cache: ParamCache | None = None,
        seed: int = 0,
        mesh=None,
    ):
        """``device`` defaults to "cuda", or with a ``mesh`` to its first
        slot (a device of another type raises)."""
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
        self._models: dict[str, torch.nn.Module] = {}
        self._replicas: dict[tuple, list[torch.nn.Module]] = {}
        self._programs: dict = {}
        self._lock = threading.Lock()
        self.device_seconds_total = 0.0
        self._acct_lock = threading.Lock()
        self._device_busy_until = 0.0
        # the diffusion sampler's noise source, in place of a split PRNG key
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._rng_lock = threading.Lock()

    def _account_device_time(self, t0: float) -> float:
        """Record a device-busy span [t0, now], clipped to start no earlier
        than the end of the previous span, so pipelined batches whose
        windows overlap never count the same time twice."""
        t_end = time.perf_counter()
        with self._acct_lock:
            start = max(t0, self._device_busy_until)
            device_s = max(t_end - start, 0.0)
            self._device_busy_until = t_end
            self.device_seconds_total += device_s
        return device_s

    def _is_multi_device(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    # ----------------------------------------------------- models/programs

    def _uses_s2d_io(self, family_name: str) -> bool:
        return uses_s2d_io(family_name, self.config)

    def model(self, family_name: str) -> torch.nn.Module:
        """The family's model on this engine's device, conv and dense
        weights in the compute type."""
        with self._lock:
            if family_name not in self._models:
                family = get_family(family_name)
                if self.device.type == "cuda":
                    check_attention_shapes(family_name, self.config.size_buckets, self.config.max_batch, self.dtype)
                m = family.build()
                m.load_state_dict(self.params_cache.get(family_name), strict=True)
                m = cast_for_compute(m, self.dtype, channels_last=self.device.type == "cuda")
                self._models[family_name] = m.to(self.device).eval()
            return self._models[family_name]

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
        """The family's model on each spatial slot."""
        model = self.model(family_name)
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
                use_s2d_io=self._uses_s2d_io(family_name),
                use_deblur=self.config.deblur,
                use_deblock=self.config.deblock,
                egress=egress,
            ),
        )

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
    ):
        """Copy the batch to the device and launch the restore program;
        returns a fetch() closure that synchronises and returns (out, scores
        [N,7], meta). The stages' host branches synchronise inside the
        launch (ops/deblock.py, ops/deblur.py), so the launch returns once
        the last of them is decided, with the backbone still queued. On a
        mesh the bucket is padded to a multiple of the data size and each
        data slot runs its shard. The diffusion family has RGB egress only
        and draws its sampler's noise (for the whole bucket) from the
        engine's seeded generator."""
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

        if family_name == "diffusion-restore":
            egress = "rgb"  # the diffusion program has no plane egress
        model = self.model(family_name)
        program = self._program(family_name, egress)
        # batches by family kind and size: the counts a run holds kernel
        # launches to (one UNet forward per restore batch, sample_steps per
        # diffusion batch)
        kind = "diffusion_batches" if family_name == "diffusion-restore" else "restore_batches"
        get_counters().inc(f"{kind}.{canvas_u8.shape[1]}")
        t0 = time.perf_counter()
        trace_label = f"restore/{family_name}/{canvas_u8.shape[1]}x{canvas_u8.shape[2]}b{bucket}"
        with device_trace(trace_label):
            args = (
                self._to_device(canvas_u8),
                torch.from_numpy(valid_hw).to(self.device),
                torch.from_numpy(is_jpeg_f).to(self.device),
            )
            if family_name == "diffusion-restore":
                with self._rng_lock:
                    noise = torch.randn(
                        tuple(args[0].shape), generator=self._generator, device=self.device, dtype=self.dtype
                    )
                args += (noise,)
            if dp == 1:
                fires: dict = {}
                out, scores = program(model, *args, fires=fires)
                flags = _fire_flags(fires, bucket, self.device)
            else:
                out, scores, flags = self._run_data_parallel(family_name, program, args)
            outs = out if isinstance(out, tuple) else (out,)
            packed = _pack([*outs, scores, flags])

        def fetch():
            t_fetch = time.perf_counter()
            host = packed.cpu().numpy()
            wall_s = time.perf_counter() - t0
            device_s = self._account_device_time(t0)
            *arrays, scores_h, flags_h = (a[:n] for a in _unpack(host, [*outs, scores, flags]))
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
            if isinstance(out, tuple):  # yuv420 plane egress
                return tuple(arrays), scores_h, meta
            return arrays[0], scores_h, meta

        return fetch

    def _run_data_parallel(self, family_name: str, program, args: tuple):
        """The program on every data slot's shard of ``args`` with that
        slot's replica; (out, scores, fire flags) gathered on the first
        slot."""
        replicas = self._data_replicas(family_name)
        homes = [self.mesh.tensor_slots(i)[0] for i in range(len(replicas))]
        shards = [split_batch(a, homes) for a in args]
        outs, scores, flags = [], [], []
        for i, (model, home) in enumerate(zip(replicas, homes)):
            fires: dict = {}
            out_i, scores_i = program(model, *(s[i] for s in shards), fires=fires)
            outs.append(out_i)
            scores.append(scores_i)
            flags.append(_fire_flags(fires, scores_i.shape[0], home))
        if isinstance(outs[0], tuple):  # plane egress: gather plane by plane
            out = tuple(gather([o[k] for o in outs], self.device) for k in range(len(outs[0])))
        else:
            out = gather(outs, self.device)
        return out, gather(scores, self.device), gather(flags, self.device)

    # ------------------------------------------- fusion, super-resolution

    SR_TILE_THRESHOLD = 512  # mirror of RestoratorService.SR_TILE_THRESHOLD
    SR_TILED_CANVAS = 2048  # the documented 2K -> 4K bucket

    def _run_sync(self, label: str, run, family_name: str, **extra):
        """Run a device program, fetch its outputs in one synchronising
        copy and assemble the standard meta with overlap-corrected
        deviceSeconds. ``run()`` returns a tensor or a tuple of tensors."""
        t0 = time.perf_counter()
        with device_trace(label):
            out = run()
            outs = out if isinstance(out, tuple) else (out,)
            packed = _pack(outs)
            t_fetch = time.perf_counter()
            arrays = _unpack(packed.cpu().numpy(), outs)
        device_s = self._account_device_time(t0)
        meta = {
            "engineRequestId": uuid.uuid4().hex,
            "deviceSeconds": device_s,
            "fetchSeconds": time.perf_counter() - t_fetch,
            "family": family_name,
            **extra,
        }
        return (tuple(arrays) if isinstance(out, tuple) else arrays[0]), meta

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.require(array, requirements=("C", "W"))).to(self.device)

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
            ("fusion", family_name), lambda: build_fusion_program(family_name, dtype=self.dtype)
        )
        get_counters().inc(f"fusion_batches.{canvas_u8.shape[1]}")
        args = (
            self._to_device(canvas_u8),
            torch.from_numpy(np.asarray(valid_hw, np.int32)).to(self.device),
            torch.from_numpy(np.asarray(is_jpeg, np.float32)).to(self.device),
        )
        (fused, scores), meta = self._run_sync(
            f"fuse/{family_name}/k{k}/{canvas_u8.shape[1]}",
            lambda: program(model, *args), family_name, fusionInputs=k,
        )
        return fused, scores, meta

    def hdr_deblur_batch(
        self, x_f32: np.ndarray, valid_hw: np.ndarray, compression: np.ndarray
    ) -> tuple[np.ndarray, dict]:
        """Float Wiener deblur with the disk channel on: the 16-bit PNG
        pre-pass (ops/deblur.py deblur_canvas_f32). x_f32 [N,B,B,3] in
        [0, 1], before any 8-bit quantization."""
        from ..ops.deblur import deblur_canvas_f32

        args = (
            self._to_device(np.asarray(x_f32, np.float32)),
            torch.from_numpy(np.asarray(valid_hw, np.int32)).to(self.device),
            torch.from_numpy(np.asarray(compression, np.float32)).to(self.device),
        )
        return self._run_sync(f"hdr_deblur/{x_f32.shape[1]}", lambda: deblur_canvas_f32(*args), "hdr_deblur")

    def sr_batch(self, imgs_u8: np.ndarray, family_name: str = "sr-x2") -> tuple[np.ndarray, dict]:
        """Super-resolution batch [N,H,W,3] u8 -> [N,H*scale,W*scale,3] u8
        (no conditioning, no tiling)."""
        model = self.model(family_name)
        program = self._program(family_name, "rgb")
        get_counters().inc(f"sr_batches.{imgs_u8.shape[1]}")
        imgs = self._to_device(imgs_u8)
        return self._run_sync(
            f"sr/{family_name}/{imgs_u8.shape[1]}x{imgs_u8.shape[2]}",
            lambda: program(model, imgs), family_name,
        )

    def sr_tiled(
        self,
        canvas_u8: np.ndarray,
        family_name: str = "sr-x2",
        tile: int = 256,
        overlap: int = 32,
        tile_batch: int = 8,
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
        if self._is_multi_device():
            model = self._data_replicas(family_name)
            slots = [self.mesh.tensor_slots(i)[0] for i in range(len(model))]
            program = self._cached_program(
                ("sr_tiled_mesh", family_name, tile, overlap, tile_batch, output),
                lambda: build_sr_tiled_mesh_program(
                    family_name, dtype=self.dtype, slots=slots, tile=tile, overlap=overlap,
                    tile_batch=tile_batch, output=output,
                ),
            )
        else:
            model = self.model(family_name)
            program = self._cached_program(
                ("sr_tiled", family_name, tile, overlap, tile_batch, output),
                lambda: build_sr_tiled_program(
                    family_name, dtype=self.dtype, tile=tile, overlap=overlap, tile_batch=tile_batch,
                    output=output,
                ),
            )
        get_counters().inc(f"sr_tiled_calls.{size}")
        canvas = self._to_device(canvas_u8)
        return self._run_sync(
            f"sr_tiled/{family_name}/{size}t{tile}",
            lambda: program(model, canvas), family_name, tile=tile, overlap=overlap,
        )

    def sr_spatial(self, canvas_u8: np.ndarray, family_name: str = "sr-x2") -> tuple[np.ndarray, dict]:
        """Super-resolve ONE [H,W,3] u8 canvas row-sharded over the mesh's
        spatial slots, a one-row halo exchanged at every convolution
        (parallel/halo.py), the limiter run on the gathered canvas. Rows are
        padded by repeating the last one to a multiple of the spatial size
        and the output cropped back: the result is the single-device
        forward of the padded canvas, cropped, up to convolution round-off.
        meta adds ``spatialShards``, ``halo`` (the receptive field in input
        rows) and ``paddedRows``."""
        from .programs import build_sr_spatial_program

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
        canvas = self._to_device(canvas_u8)
        out, meta = self._run_sync(
            f"sr_spatial/{family_name}/{h}", lambda: program(models, canvas), family_name,
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
