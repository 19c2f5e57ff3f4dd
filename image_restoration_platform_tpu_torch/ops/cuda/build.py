"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each kernel source under ``csrc/`` exposes a plain C interface, so it
compiles in seconds without PyTorch's headers. The library lands in
``build/kernels/`` at the repository root (listed in ``.gitignore``), named
after a digest of its source and flags, so a changed source rebuilds and an
unchanged one is reused. Nothing is built when a module is imported: the
first launch of a kernel builds it. ``Kernel`` is the binding every
hand-written kernel shares: a new kernel is its ``csrc/`` file and one
subclass beside its plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from ...obs.metrics import KERNELS

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict = {}


def nvcc_path() -> str:
    for candidate in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path(source: str) -> str:
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def compile_source(source: str) -> str:
    """Run nvcc for ``source`` unless its library exists; returns nvcc's
    log (ptxas register and spill counts), empty when the library was reused."""
    path = library_path(source)
    if os.path.exists(path):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, path)  # atomic: concurrent processes never load a partial file
    return log


def bind(source: str, symbol: str, argtypes):
    """The C function ``symbol`` of ``source``'s library with ``argtypes``
    and an int result (a CUDA error code), bound once; the library is built
    on first use."""
    with _lock:
        fn = _fns.get((source, symbol))
        if fn is None:
            lib = _libs.get(source)
            if lib is None:
                compile_source(source)
                lib = _libs[source] = ctypes.CDLL(library_path(source))
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            _fns[(source, symbol)] = fn
        return fn


class Kernel:
    """One hand-written kernel's binding with its launch counts. A subclass
    names the kernel (its counter is ``kernels.launches.<name>``), its
    ``variants``, its library ``source``, its C ``symbol`` and that symbol's
    ``argtypes`` less the trailing stream; its ``__call__`` checks the
    inputs and hands the arguments to ``launch``. Each instance joins
    ``obs.metrics.KERNELS`` as it is made."""

    name: str
    variants: tuple[str, ...]
    source: str
    symbol: str
    argtypes: tuple

    def __init__(self) -> None:
        self.launches = 0
        self.launches_by_variant = {variant: 0 for variant in self.variants}
        self._fn = None
        KERNELS.append(self)

    def launch(self, device: torch.device, variant: str, *args) -> None:
        """Launch the kernel with ``args`` on ``device``'s current stream and
        count it under ``variant``; raise on a CUDA error."""
        if self._fn is None:
            self._fn = bind(self.source, self.symbol, (*self.argtypes, ctypes.c_void_p))
        with torch.cuda.device(device):
            err = self._fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed ({variant}): {self.describe_error(err)}")
        self.launches += 1
        self.launches_by_variant[variant] += 1

    def describe_error(self, err: int) -> str:
        return f"cudaError {err}"
