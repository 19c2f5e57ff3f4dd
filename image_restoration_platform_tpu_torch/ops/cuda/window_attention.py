"""Shifted-window attention of the Swin transformer: the hand-written Hopper
kernel and its plain version.

Ports no TPU kernel: the JAX package has no transformer. SwinIR's W-MSA and
SW-MSA (models/swinir.py) attend within each 8 x 8 window of the (rolled)
token grid, HAT's HABs (models/hat.py) within each 16 x 16 window, with a
learned relative-position bias and, on shifted layers, a -100 mask between
tokens of different regions of the rolled image. The kernel
(csrc/window_attention.cu, one instantiation a window size) reads q, k and v
straight from the qkv linear's ``[windows, T, 3C]`` output and writes
``[windows, T, C]`` for the proj linear, with the bias table read and the
mask worked out inside it.

``window_attention`` takes the kernel for CUDA tensors and the plain version
for CPU tensors; there is no other branch and no fallback between them.
``check_shapes`` states what the kernel takes; the engine calls it when it
loads a SwinIR or HAT family (``models.registry.check_attention_shapes``).
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch

from . import build

SOURCE = "window_attention.cu"
KERNEL_WINDOWS = (8, 16)
KERNEL_MAX_HEAD_DIM = 32
KERNEL_MAX_HEADS = 8
MASK_VALUE = -100.0


def check_shapes(window: int, heads: int, channels: int) -> None:
    """Raise unless the kernel takes windows of ``window`` x ``window``
    tokens with ``channels`` split over ``heads`` heads."""
    if window not in KERNEL_WINDOWS:
        raise ValueError(f"the window attention kernel takes windows of {' or '.join(map(str, KERNEL_WINDOWS))}, "
                         f"got {window}")
    if not 1 <= heads <= KERNEL_MAX_HEADS:
        raise ValueError(f"the window attention kernel takes 1 to {KERNEL_MAX_HEADS} heads, got {heads}")
    head_dim = channels // heads
    if channels % heads or head_dim % 2 or not 2 <= head_dim <= KERNEL_MAX_HEAD_DIM:
        raise ValueError(f"the window attention kernel takes an even head dim of at most {KERNEL_MAX_HEAD_DIM}, "
                         f"got {channels} channels over {heads} heads")


# ----------------------------------------------------------- plain version


@lru_cache(maxsize=8)
def relative_position_index(window: int) -> torch.Tensor:
    """[T, T] int64: the row of the bias table for query token i and key
    token j of a window, (yi - yj + w - 1) * (2w - 1) + (xi - xj + w - 1)."""
    y, x = torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij")
    y, x = y.reshape(-1), x.reshape(-1)
    return (y[:, None] - y[None, :] + window - 1) * (2 * window - 1) + (x[:, None] - x[None, :] + window - 1)


def _regions(size: int, window: int, shift: int) -> torch.Tensor:
    """The region of each row (or column) of a rolled image of ``size``:
    0 up to the last window, 1 in its first ``window - shift``, 2 after."""
    pos = torch.arange(size)
    return (pos >= size - window).long() + (pos >= size - shift).long()


@lru_cache(maxsize=16)
def region_mask(grid: tuple[int, int], window: int, shift: int) -> torch.Tensor:
    """[nW, T, T] f32: ``MASK_VALUE`` where two tokens of a window of the
    (grid_h, grid_w) grid lie in different regions of the rolled image."""
    gh, gw = grid
    ids = 3 * _regions(gh * window, window, shift)[:, None] + _regions(gw * window, window, shift)[None, :]
    ids = ids.reshape(gh, window, gw, window).permute(0, 2, 1, 3).reshape(gh * gw, window * window)
    return (ids[:, :, None] != ids[:, None, :]).float() * MASK_VALUE


def window_attention_reference(qkv: torch.Tensor, table: torch.Tensor, heads: int, shift: int,
                               grid: tuple[int, int]) -> torch.Tensor:
    """Plain [B*nW, T, 3C] qkv -> [B*nW, T, C]: f32 scores, bias and mask,
    f32 softmax, probabilities rounded to v's type, PV accumulated in f32,
    the output in qkv's type."""
    n, t, c3 = qkv.shape
    c = c3 // 3
    window = math.isqrt(t)
    q, k, v = qkv.reshape(n, t, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (c // heads) ** -0.5
    index = relative_position_index(window).to(qkv.device)
    logits = logits + table.float()[index].permute(2, 0, 1)[None]
    if shift:
        mask = region_mask(tuple(grid), window, shift).to(qkv.device)
        logits = (logits.view(n // mask.shape[0], mask.shape[0], heads, t, t) + mask[None, :, None]).view(n, heads, t, t)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float()).to(qkv.dtype)
    return out.transpose(1, 2).reshape(n, t, c)


# ------------------------------------------------------------------ kernel


class WindowAttentionKernel(build.Kernel):
    """ctypes binding of ``irp_window_attention`` with its launch count, by
    window size and shift: windows of 8 count as "window" and "shifted",
    windows of 16 as "window_16" and "shifted_16"."""

    name, variants = "window_attention", ("window", "shifted", "window_16", "shifted_16")
    source, symbol = SOURCE, "irp_window_attention"
    argtypes = (*[ctypes.c_void_p] * 3, *[ctypes.c_int] * 7, ctypes.c_float)

    def __call__(self, qkv: torch.Tensor, table: torch.Tensor, heads: int, shift: int,
                 grid: tuple[int, int]) -> torch.Tensor:
        """[B*nW, T, 3C] CUDA bf16 contiguous qkv (T = 64 or 256: windows of
        8 or 16), [(2w - 1)^2, heads] f32 table -> [B*nW, T, C] bf16."""
        if not (qkv.is_cuda and table.is_cuda):
            raise ValueError("the window attention kernel takes CUDA tensors only")
        if qkv.dtype != torch.bfloat16 or table.dtype != torch.float32:
            raise TypeError(f"the window attention kernel takes bf16 qkv and an f32 table, got {qkv.dtype}/{table.dtype}")
        tokens = [w * w for w in KERNEL_WINDOWS]
        if qkv.dim() != 3 or qkv.shape[1] not in tokens or qkv.shape[2] % 3:
            raise ValueError(f"qkv must be [windows, {' or '.join(map(str, tokens))}, 3C], got {tuple(qkv.shape)}")
        n, t, c3 = qkv.shape
        window = math.isqrt(t)
        check_shapes(window, heads, c3 // 3)
        head_dim = c3 // (3 * heads)
        if tuple(table.shape) != ((2 * window - 1) ** 2, heads):
            raise ValueError(f"the bias table must be [{(2 * window - 1) ** 2}, {heads}], got {tuple(table.shape)}")
        gh, gw = int(grid[0]), int(grid[1])
        if gh < 1 or gw < 1 or n % (gh * gw):
            raise ValueError(f"{n} windows are no whole number of {gh} x {gw} grids")
        if not 0 <= shift < window:
            raise ValueError(f"shift {shift} is outside [0, {window})")
        if not (qkv.is_contiguous() and table.is_contiguous()) or qkv.data_ptr() % 16:
            raise ValueError("the window attention kernel takes a contiguous, 16-byte aligned qkv and table")
        out = torch.empty((n, t, c3 // 3), dtype=qkv.dtype, device=qkv.device)
        variant = ("shifted" if shift else "window") + ("" if window == 8 else f"_{window}")
        self.launch(qkv.device, variant, qkv.data_ptr(), table.data_ptr(), out.data_ptr(),
                    n, window, heads, head_dim, gh, gw, shift, head_dim**-0.5)
        return out


window_attention_kernel = WindowAttentionKernel()


def window_attention(qkv: torch.Tensor, table: torch.Tensor, heads: int, shift: int,
                     grid: tuple[int, int]) -> torch.Tensor:
    """softmax(Q K^T / sqrt(D) + bias + mask) V of each window and head:
    qkv [B*nW, T, 3C] (per token the heads' q, k, v), windows batch-major
    over a (grid_h, grid_w) grid -> [B*nW, T, C]."""
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, table, heads, shift, grid)
    return window_attention_kernel(qkv, table, heads, shift, grid)
