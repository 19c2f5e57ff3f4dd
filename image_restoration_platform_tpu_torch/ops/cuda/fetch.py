"""The engine's blocking fetch on the card (csrc/fetch.cu): a CUDA tensor's
bytes copied into a new pageable host array, with an event recorded right
behind the copy on the same stream without returning to the interpreter
first, so the event marks the copy's end and not the host's return.

The library builds at the first fetch (ops/cuda/build.py), never when this
module is imported."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

SOURCE = "fetch.cu"

_fn = None


def _bind():
    global _fn
    if _fn is None:  # a second binding in a race is the same function
        fn = build.load(SOURCE).irp_fetch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fetch(src: torch.Tensor, stream: torch.cuda.Stream, fetched: torch.cuda.Event) -> np.ndarray:
    """The bytes of the contiguous uint8 CUDA tensor ``src`` as a new host
    array, copied on ``stream``, with ``fetched`` recorded behind the copy
    (an event already recorded once, so that it exists)."""
    if src.device.type != "cuda" or src.dtype != torch.uint8 or not src.is_contiguous() or src.dim() != 1:
        raise ValueError(f"fetch takes a contiguous 1-D uint8 CUDA tensor, got {src.dtype} {tuple(src.shape)} on {src.device}")
    host = np.empty(src.numel(), np.uint8)
    err = _bind()(host.ctypes.data, src.data_ptr(), src.numel(), stream.cuda_stream, fetched.cuda_event)
    if err:
        raise RuntimeError(f"irp_fetch failed: CUDA error {err}")
    return host
