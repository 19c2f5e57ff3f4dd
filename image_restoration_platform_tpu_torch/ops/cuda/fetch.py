"""The engine's blocking fetch on the card (csrc/fetch.cu): a CUDA tensor's
bytes copied by DMA into a page-locked host block, with an event recorded
right behind the copy on the same stream without returning to the
interpreter first, so the event marks the copy's end and not the host's
return.

The blocks come from the process's cache of pinned blocks
(``PinnedBlocks``). A fetch returns its block as a NumPy array, and the
block is lent again only once that array and every array made from it are
gone, so no later fetch writes under an array a caller still holds. Blocks
are kept for the life of the process: fetches of one size pin new memory
only while the number of their results alive at once grows.

The library builds at the first fetch (ops/cuda/build.py), never when this
module is imported."""

from __future__ import annotations

import ctypes
import threading
import weakref

import numpy as np
import torch

from ...obs.metrics import get_counters
from . import build

SOURCE = "fetch.cu"

_fn = None


def _bind():
    global _fn
    if _fn is None:
        _fn = build.bind(SOURCE, "irp_fetch", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                               ctypes.c_void_p])
    return _fn


def _pinned(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


class PinnedBlocks:
    """Page-locked host blocks, each lent to one result at a time.

    A request of n bytes takes a free block of n rounded up to a power of
    two, the size PyTorch's pinned allocator gives such a request, or pins a
    new one and adds its bytes to the counter ``engine.pinned_alloc_bytes``.
    A block is lent as a NumPy array over its first n bytes; every view of
    that array holds it through its ``base``, so the block is free once the
    array has been collected."""

    def __init__(self):
        self._lock = threading.Lock()
        self._blocks: list[list] = []  # [block, weak reference to the array it is lent as]

    def lend(self, nbytes: int) -> np.ndarray:
        size = 1 << max(nbytes - 1, 0).bit_length()
        with self._lock:
            entry = next((e for e in self._blocks if e[0].numel() == size and e[1]() is None), None)
            if entry is None:
                entry = [_pinned(size), None]
                self._blocks.append(entry)
                get_counters().inc("engine.pinned_alloc_bytes", size)
            host = entry[0][:nbytes].numpy()
            entry[1] = weakref.ref(host)
        return host


_blocks = PinnedBlocks()


def fetch(src: torch.Tensor, stream: torch.cuda.Stream, fetched: torch.cuda.Event) -> np.ndarray:
    """The bytes of the contiguous uint8 CUDA tensor ``src`` as a host array
    over a pinned block of the process's cache, copied on ``stream``, with
    ``fetched`` recorded behind the copy (an event already recorded once, so
    that it exists). The block is the array's until the array and its views
    are gone."""
    if src.device.type != "cuda" or src.dtype != torch.uint8 or not src.is_contiguous() or src.dim() != 1:
        raise ValueError(f"fetch takes a contiguous 1-D uint8 CUDA tensor, got {src.dtype} {tuple(src.shape)} on {src.device}")
    host = _blocks.lend(src.numel())
    err = _bind()(host.ctypes.data, src.data_ptr(), src.numel(), stream.cuda_stream, fetched.cuda_event)
    if err:
        raise RuntimeError(f"irp_fetch failed: CUDA error {err}")
    return host
