"""Overlap-blend of tiles: the hand-written Hopper kernel and its dispatch.

Counterpart of image_restoration_platform_tpu/ops/pallas/blend.py. The
kernel (csrc/blend_tiles.cu) computes the Hann-windowed overlap-add of
``[n, T, T, C]`` f32 tiles at origins ``(ys, xs)`` into an ``[H, W, C]`` f32
canvas, divided by the summed window, each output element written once. Its
plain version is ``ops.tile.blend_tiles`` (scale 1), which adds the tiles in
the same row-major order.

``blend_tiles`` takes the kernel for CUDA tensors and the plain fold for CPU
tensors; there is no other branch and no fallback between them.

The kernel has two variants, chosen by ``kernel_variant`` from the geometry
alone (plain Python, so the CPU tests reach it): ``vector`` moves 16 bytes a
thread and needs every tile edge on a 4-float boundary of the flattened
``[H, W*C]`` canvas; ``scalar`` is the same code with 4-byte accesses and
takes any geometry.
"""

from __future__ import annotations

import ctypes

import torch

from .. import tile as plain
from . import build

SOURCE = "blend_tiles.cu"
# floats a thread of the vector variant owns (16 bytes)
VECTOR_FLOATS = 4
# variant name -> floats per thread, as irp_blend_tiles takes it
VARIANTS = {"scalar": 1, "vector": VECTOR_FLOATS}


def kernel_variant(t: int, c: int, out_w: int, xs: tuple) -> str:
    """``vector`` where a thread's four consecutive floats of a canvas row
    always lie inside or outside a tile together and both sides of the copy
    are 16-byte aligned: the row length W*C, the tile row length T*C and the
    first float xs[cx]*C of every tile column are multiples of 4. Any other
    geometry (odd clamped origins, odd widths) is ``scalar``."""
    lengths = (out_w * c, t * c, *(int(x) * c for x in xs))
    return "vector" if all(v % VECTOR_FLOATS == 0 for v in lengths) else "scalar"


class BlendKernel:
    """ctypes binding of ``irp_blend_tiles`` with its launch count."""

    name = "blend_tiles"

    def __init__(self) -> None:
        self.launches = 0
        self.launches_by_variant = {name: 0 for name in VARIANTS}
        self._fn = None
        # per device: the [T, T] window table and the origin arrays of a grid
        # (a handful each: canvases come in buckets and tiles in one size)
        self._windows: dict = {}
        self._origins: dict = {}

    def _bind(self):
        if self._fn is None:
            fn = build.load(SOURCE).irp_blend_tiles
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _window(self, t: int, device: torch.device) -> torch.Tensor:
        key = (t, device)
        if key not in self._windows:
            # the host's float64 outer product cast to f32: a 1-D f32 window
            # multiplied in the kernel would round differently
            self._windows[key] = torch.from_numpy(plain._hann_window(t)).to(device).contiguous()
        return self._windows[key]

    def _origin_array(self, origins: tuple, device: torch.device) -> torch.Tensor:
        key = (origins, device)
        if key not in self._origins:
            self._origins[key] = torch.tensor(origins, dtype=torch.int32, device=device)
        return self._origins[key]

    def __call__(self, tiles: torch.Tensor, out_hw: tuple[int, int], ys: tuple, xs: tuple,
                 variant: str | None = None) -> torch.Tensor:
        """[n, T, T, C] CUDA f32 contiguous tiles, row-major over (ys, xs) ->
        the blended [H, W, C] f32 canvas. ``variant`` overrides the choice of
        ``kernel_variant`` (a check may ask for ``scalar`` anywhere; asking
        for ``vector`` where the geometry does not allow it raises)."""
        if not tiles.is_cuda:
            raise ValueError("the blend kernel takes CUDA tensors only")
        if tiles.dtype != torch.float32:
            raise TypeError(f"the blend kernel takes f32 tiles, got {tiles.dtype}")
        if tiles.dim() != 4 or tiles.shape[1] != tiles.shape[2]:
            raise ValueError(f"tiles must be [n, T, T, C], got {tuple(tiles.shape)}")
        if not tiles.is_contiguous():
            raise ValueError("the blend kernel takes contiguous tiles")
        n, t, _, c = tiles.shape
        ys, xs = tuple(int(y) for y in ys), tuple(int(x) for x in xs)
        if n != len(ys) * len(xs) or n == 0:
            raise ValueError(f"{n} tiles do not match a {len(ys)} x {len(xs)} grid")
        out_h, out_w = int(out_hw[0]), int(out_hw[1])
        if min(ys) < 0 or max(ys) + t > out_h or min(xs) < 0 or max(xs) + t > out_w:
            raise ValueError(f"tile origins {ys} x {xs} with T = {t} leave the {out_h} x {out_w} canvas")
        allowed = kernel_variant(t, c, out_w, xs) if tiles.data_ptr() % 16 == 0 else "scalar"
        if variant is None:
            variant = allowed
        elif variant not in VARIANTS or (variant == "vector" and allowed != "vector"):
            raise ValueError(f"blend kernel variant {variant!r} does not take this geometry ({allowed})")
        fn = self._bind()
        device = tiles.device
        window = self._window(t, device)
        ys_d, xs_d = self._origin_array(ys, device), self._origin_array(xs, device)
        out = torch.empty((out_h, out_w, c), dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            err = fn(
                tiles.data_ptr(), window.data_ptr(), ys_d.data_ptr(), xs_d.data_ptr(), out.data_ptr(),
                len(ys), len(xs), t, c, out_h, out_w, VARIANTS[variant], stream,
            )
        if err != 0:
            raise RuntimeError(f"blend kernel launch failed ({variant}): cudaError {err}")
        self.launches += 1
        self.launches_by_variant[variant] += 1
        return out


blend_kernel = BlendKernel()


def blend_tiles(tiles: torch.Tensor, out_hw: tuple[int, int], ys: tuple, xs: tuple) -> torch.Tensor:
    """Seam-free windowed blend of [n, T, T, C] tiles at output origins
    (ys, xs) -> [H, W, C] f32."""
    if tiles.device.type == "cpu":
        return plain.blend_tiles(tiles, out_hw, ys, xs)
    return blend_kernel(tiles, out_hw, ys, xs)
