"""Patch tiling with seam-free overlap-blend compositing.

Counterpart of image_restoration_platform_tpu/ops/tile.py: a large image is
split into overlapping tiles, each tile is restored on the device, and the
results are composited under a raised-cosine (Hann) window normalised by the
summed window, so the blend is seam-free.

``blend_tiles`` here is the plain version of the fold: the windowed tiles
are added one after another, in row-major tile order, into one f32
accumulator, and the sum is divided once by the summed window. The CUDA
kernel that computes the same function lives in ops/cuda/blend.py;
``tiled_apply`` goes through that module's ``blend_tiles``, which takes the
kernel for CUDA tensors and this fold for CPU tensors.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def tile_grid(size: int, tile: int, stride: int) -> tuple[int, ...]:
    """Start offsets of tiles covering [0, size) with tile length ``tile``.

    Consecutive starts step by ``stride``; the final tile is clamped so it
    ends exactly at ``size``."""
    if size <= tile:
        return (0,)
    starts = list(range(0, size - tile, stride))
    starts.append(size - tile)
    # deduplicate while preserving order (the clamped start can collide)
    seen: set[int] = set()
    out = []
    for s in starts:
        if s not in seen:
            seen.add(s)
            out.append(s)
    return tuple(out)


@lru_cache(maxsize=32)
def _hann_window(tile: int) -> np.ndarray:
    """[T, T] f32 window: the outer product of a raised cosine floored at
    1e-3 (strictly positive, so the normalisation is safe), computed in
    float64 and cast once."""
    n = np.arange(tile, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * (n + 0.5) / tile)
    w = np.maximum(w, 1e-3)
    return (w[:, None] * w[None, :]).astype(np.float32)


def tile_image(img: torch.Tensor, tile: int, overlap: int) -> tuple[torch.Tensor, tuple, tuple]:
    """Split [H, W, C] into overlapping [N, tile, tile, C] tiles, row-major."""
    h, w, _ = img.shape
    stride = tile - overlap
    ys = tile_grid(h, tile, stride)
    xs = tile_grid(w, tile, stride)
    rows = [img[y : y + tile, x : x + tile] for y in ys for x in xs]
    return torch.stack(rows, dim=0), ys, xs


def blend_tiles(
    tiles: torch.Tensor,
    out_hw: tuple[int, int],
    ys: tuple,
    xs: tuple,
    scale: int = 1,
) -> torch.Tensor:
    """Composite [N, T, T, C] tiles back to [H*scale, W*scale, C] f32.

    ``scale`` supports super-resolution tiling: tiles produced at T*scale
    from source offsets (y, x) land at (y*scale, x*scale)."""
    n, t, _, c = tiles.shape
    if n != len(ys) * len(xs):
        raise ValueError(f"{n} tiles do not match a {len(ys)} x {len(xs)} grid")
    out_h, out_w = out_hw[0] * scale, out_hw[1] * scale
    window = torch.from_numpy(_hann_window(t)).to(tiles.device)

    acc = torch.zeros((out_h, out_w, c), dtype=torch.float32, device=tiles.device)
    wacc = torch.zeros((out_h, out_w, 1), dtype=torch.float32, device=tiles.device)
    weighted = tiles.float() * window[None, :, :, None]

    idx = 0
    for y in ys:
        for x in xs:
            yo, xo = y * scale, x * scale
            acc[yo : yo + t, xo : xo + t] += weighted[idx]
            wacc[yo : yo + t, xo : xo + t] += window[:, :, None]
            idx += 1
    return acc / wacc


def tiled_apply(
    img: torch.Tensor,
    fn,
    tile: int,
    overlap: int,
    scale: int = 1,
    tile_batch: int | None = None,
) -> torch.Tensor:
    """Run ``fn`` ([N,T,T,C] -> [N,T*scale,T*scale,C'] f32) over overlapping
    tiles of [H, W, C] and blend the results seam-free.

    ``tile_batch`` chunks the tile axis so activations stay bounded for huge
    images; the last chunk is filled by repeating the last tile, so every
    call of ``fn`` sees the same shape."""
    from .cuda.blend import blend_tiles as blend

    h, w, _ = img.shape
    tiles, ys, xs = tile_image(img, tile, overlap)
    n = tiles.shape[0]
    if tile_batch is None or tile_batch >= n:
        out_tiles = fn(tiles)
    else:
        pad = (-n) % tile_batch
        padded = torch.cat([tiles, tiles[-1:].expand(pad, -1, -1, -1)], dim=0) if pad else tiles
        chunks = [fn(padded[i : i + tile_batch]) for i in range(0, padded.shape[0], tile_batch)]
        out_tiles = torch.cat(chunks, dim=0)[:n]

    out_ys = tuple(y * scale for y in ys)
    out_xs = tuple(x * scale for x in xs)
    return blend(out_tiles.contiguous(), (h * scale, w * scale), out_ys, out_xs)
