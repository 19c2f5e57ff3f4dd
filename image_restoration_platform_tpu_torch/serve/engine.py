"""RestorationEngine — owns the models and runs the restore program.

Counterpart of the restore surfaces of
image_restoration_platform_tpu/serve/engine.py (``restore_batch`` and
``restore_batch_async``): batches are padded to a power-of-two bucket by
repeating the last row, the program runs on the engine's device, and one
synchronising device->host copy fetches the outputs. Device seconds are
overlap-corrected across pipelined batches.

The engine runs on ``device="cuda"`` unless the caller asks for the CPU; it
never falls back to the CPU by itself. Mesh serving, sharding and the
executable disk cache are not ported.
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
from ..obs.metrics import get_counters
from ..obs.tracing import device_trace, get_tracer
from ..utils.logging import get_logger


def resolve_device(device: str | torch.device) -> torch.device:
    """The requested device; CUDA raises when no card is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port on the CPU"
        )
    return device


def _batch_bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return b


class RestorationEngine:
    def __init__(
        self,
        device: str | torch.device = "cuda",
        dtype: torch.dtype | None = None,
        serving_config: ServingConfig | None = None,
        param_cache: ParamCache | None = None,
        seed: int = 0,
    ):
        self.device = resolve_device(device)
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
        self._programs: dict = {}
        self._lock = threading.Lock()
        self.device_seconds_total = 0.0
        self._acct_lock = threading.Lock()
        self._device_busy_until = 0.0

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

    # ----------------------------------------------------- models/programs

    def _uses_s2d_io(self, family_name: str) -> bool:
        if not self.config.s2d_io:
            return False
        cfg = get_family(family_name).config
        return cfg.input_scale > 1 and cfg.in_channels == cfg.out_channels

    def model(self, family_name: str) -> torch.nn.Module:
        """The family's model on this engine's device, conv and dense
        weights in the compute type."""
        with self._lock:
            if family_name not in self._models:
                family = get_family(family_name)
                m = family.build()
                m.load_state_dict(self.params_cache.get(family_name), strict=True)
                m = cast_for_compute(m, self.dtype, channels_last=self.device.type == "cuda")
                self._models[family_name] = m.to(self.device).eval()
            return self._models[family_name]

    def _program(self, family_name: str, egress: str):
        from .programs import build_restore_program

        key = (family_name, egress)
        with self._lock:
            if key not in self._programs:
                self._programs[key] = build_restore_program(
                    family_name,
                    dtype=self.dtype,
                    use_s2d_io=self._uses_s2d_io(family_name),
                    use_deblur=self.config.deblur,
                    use_deblock=self.config.deblock,
                    egress=egress,
                )
            return self._programs[key]

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
        the last of them is decided, with the backbone still queued."""
        n = canvas_u8.shape[0]
        if valid_hw is None:
            valid_hw = np.tile(np.asarray([canvas_u8.shape[1], canvas_u8.shape[2]], np.int32), (n, 1))
        if is_jpeg is None:
            is_jpeg = np.zeros((n,), dtype=np.float32)
        valid_hw = np.asarray(valid_hw, dtype=np.int32)
        is_jpeg_f = np.asarray(is_jpeg, dtype=np.float32)

        bucket = _batch_bucket(n, self.config.max_batch)
        if bucket > n:
            pad = bucket - n
            canvas_u8 = np.concatenate([canvas_u8, np.repeat(canvas_u8[-1:], pad, axis=0)], axis=0)
            valid_hw = np.concatenate([valid_hw, np.repeat(valid_hw[-1:], pad, axis=0)], axis=0)
            is_jpeg_f = np.concatenate([is_jpeg_f, np.repeat(is_jpeg_f[-1:], pad, axis=0)], axis=0)

        model = self.model(family_name)
        program = self._program(family_name, egress)
        # one UNet forward per batch: the count a run holds kernel launches to
        get_counters().inc(f"restore_batches.{canvas_u8.shape[1]}")
        t0 = time.perf_counter()
        trace_label = f"restore/{family_name}/{canvas_u8.shape[1]}x{canvas_u8.shape[2]}b{bucket}"
        with device_trace(trace_label):
            args = (
                torch.from_numpy(np.require(canvas_u8, requirements=("C", "W"))).to(self.device),
                torch.from_numpy(valid_hw).to(self.device),
                torch.from_numpy(is_jpeg_f).to(self.device),
            )
            out, scores = program(model, *args)
            outs = out if isinstance(out, tuple) else (out,)
            # one flat byte buffer, so the fetch is one device->host copy
            packed = torch.cat([o.reshape(-1) for o in outs] + [scores.contiguous().view(torch.uint8).reshape(-1)])

        def fetch():
            t_fetch = time.perf_counter()
            host = packed.cpu().numpy()
            wall_s = time.perf_counter() - t0
            device_s = self._account_device_time(t0)
            arrays, offset = [], 0
            for o in outs:
                arrays.append(host[offset : offset + o.numel()].reshape(tuple(o.shape))[:n])
                offset += o.numel()
            scores_h = host[offset:].view(np.float32).reshape(tuple(scores.shape))[:n]
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
