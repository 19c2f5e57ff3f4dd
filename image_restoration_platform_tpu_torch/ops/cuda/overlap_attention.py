"""Overlapping cross-window attention of HAT's OCAB: the hand-written Hopper
kernel and its plain version.

Ports no TPU kernel: the JAX package has no transformer. HAT's overlapping
cross-attention block (models/hat.py:OCAB) takes the queries of each 16 x 16
window and the keys and values of the 24 x 24 window around it (the
published model cuts them with ``F.unfold``, kernel 24, stride 16, zero
padding 4), with a learned relative-position bias from a [39^2, heads]
table. Keys past the image's border are zero rows that take part in the
softmax with their bias. The table's row for query token (qy, qx) and key
token (ky, kx) of the overlapping window is the published
``calculate_rpi_oca``'s, ``(ky - qy - 7) * 39 + (kx - qx - 7)``, whose
negative values wrap as PyTorch's indexing wraps them (``table[-1]`` is the
last row): a permutation of the table's rows, each offset its own row.

The kernel (csrc/overlap_attention.cu) reads q, k and v straight from the
qkv linear's output in the window layout at shift 0 (``[B * nW, 256, 3C]``,
which the add-norm kernel writes), each key window's rows gathered from the
neighbouring windows' rows, no unfolded tensor written, and writes
``[B * nW, 256, C]`` for the proj linear.

``overlap_attention`` takes the kernel for CUDA tensors and the plain
version for CPU tensors; there is no other branch and no fallback between
them. ``check_shapes`` states what the kernel takes; the engine calls it
when it loads a HAT family (``models.registry.check_attention_shapes``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from . import build

SOURCE = "overlap_attention.cu"
KERNEL_WINDOW = 16
KERNEL_OVERLAP = 24  # the key window: 16 * (1 + 0.5)
KERNEL_MAX_HEAD_DIM = 32
KERNEL_MAX_HEADS = 8


def check_shapes(window: int, overlap: int, heads: int, channels: int) -> None:
    """Raise unless the kernel takes query windows of ``window`` x
    ``window`` tokens against key windows of ``overlap`` x ``overlap``, with
    ``channels`` split over ``heads`` heads."""
    if (window, overlap) != (KERNEL_WINDOW, KERNEL_OVERLAP):
        raise ValueError(f"the overlap attention kernel takes windows of {KERNEL_WINDOW} against key windows of "
                         f"{KERNEL_OVERLAP}, got {window} and {overlap}")
    if not 1 <= heads <= KERNEL_MAX_HEADS:
        raise ValueError(f"the overlap attention kernel takes 1 to {KERNEL_MAX_HEADS} heads, got {heads}")
    head_dim = channels // heads
    if channels % heads or head_dim % 2 or not 2 <= head_dim <= KERNEL_MAX_HEAD_DIM:
        raise ValueError(f"the overlap attention kernel takes an even head dim of at most {KERNEL_MAX_HEAD_DIM}, "
                         f"got {channels} channels over {heads} heads")


# ----------------------------------------------------------- plain version


@lru_cache(maxsize=8)
def overlap_position_index(window: int, overlap: int) -> torch.Tensor:
    """[window^2, overlap^2] int64: the published OCAB index of the bias
    table, (ky - qy + window - overlap + 1) * (window + overlap - 1) +
    (kx - qx + window - overlap + 1), negative entries kept."""
    qy, qx = (t.reshape(-1) for t in torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij"))
    ky, kx = (t.reshape(-1) for t in torch.meshgrid(torch.arange(overlap), torch.arange(overlap), indexing="ij"))
    lo = window - overlap + 1
    return (ky[None] - qy[:, None] + lo) * (window + overlap - 1) + (kx[None] - qx[:, None] + lo)


def overlap_attention_reference(qkv: torch.Tensor, table: torch.Tensor, heads: int, grid: tuple[int, int],
                                window: int, overlap: int) -> torch.Tensor:
    """Plain [B*nW, window^2, 3C] qkv in the window layout (shift 0) ->
    [B*nW, window^2, C]: the key windows cut from the zero-padded grid, f32
    scores and bias, f32 softmax, probabilities rounded to v's type, PV
    accumulated in f32, the output in qkv's type."""
    n, t, c3 = qkv.shape
    c, d = c3 // 3, c3 // 3 // heads
    gh, gw = grid
    b, pad = n // (gh * gw), (overlap - window) // 2
    q = qkv[..., :c].reshape(n, t, heads, d).transpose(1, 2)
    image = qkv[..., c:].reshape(b, gh, gw, window, window, 2 * c).permute(0, 1, 3, 2, 4, 5)
    image = F.pad(image.reshape(b, gh * window, gw * window, 2 * c), (0, 0, pad, pad, pad, pad))
    kv = image.unfold(1, overlap, window).unfold(2, overlap, window)  # [b, gh, gw, 2C, overlap, overlap]
    kv = kv.permute(0, 1, 2, 4, 5, 3).reshape(n, overlap * overlap, 2, heads, d).permute(2, 0, 3, 1, 4)
    k, v = kv[0], kv[1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d**-0.5
    logits = logits + table.float()[overlap_position_index(window, overlap).to(qkv.device)].permute(2, 0, 1)[None]
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float()).to(qkv.dtype)
    return out.transpose(1, 2).reshape(n, t, c)


# ------------------------------------------------------------------ kernel


class OverlapAttentionKernel(build.Kernel):
    """ctypes binding of ``irp_overlap_attention`` with its launch count."""

    name, variants = "overlap_attention", ("overlap",)
    source, symbol = SOURCE, "irp_overlap_attention"
    argtypes = (*[ctypes.c_void_p] * 3, *[ctypes.c_int] * 5, ctypes.c_float)

    def __call__(self, qkv: torch.Tensor, table: torch.Tensor, heads: int, grid: tuple[int, int]) -> torch.Tensor:
        """[B*nW, 256, 3C] CUDA bf16 contiguous qkv in the window layout,
        [39^2, heads] f32 table -> [B*nW, 256, C] bf16."""
        if not (qkv.is_cuda and table.is_cuda):
            raise ValueError("the overlap attention kernel takes CUDA tensors only")
        if qkv.dtype != torch.bfloat16 or table.dtype != torch.float32:
            raise TypeError(f"the overlap attention kernel takes bf16 qkv and an f32 table, got {qkv.dtype}/{table.dtype}")
        if qkv.dim() != 3 or qkv.shape[1] != KERNEL_WINDOW**2 or qkv.shape[2] % 3:
            raise ValueError(f"qkv must be [windows, {KERNEL_WINDOW**2}, 3C], got {tuple(qkv.shape)}")
        n, t, c3 = qkv.shape
        check_shapes(KERNEL_WINDOW, KERNEL_OVERLAP, heads, c3 // 3)
        span = (KERNEL_WINDOW + KERNEL_OVERLAP - 1) ** 2
        if tuple(table.shape) != (span, heads):
            raise ValueError(f"the bias table must be [{span}, {heads}], got {tuple(table.shape)}")
        gh, gw = int(grid[0]), int(grid[1])
        if gh < 1 or gw < 1 or n % (gh * gw):
            raise ValueError(f"{n} windows are no whole number of {gh} x {gw} grids")
        if not (qkv.is_contiguous() and table.is_contiguous()) or qkv.data_ptr() % 16:
            raise ValueError("the overlap attention kernel takes a contiguous, 16-byte aligned qkv and table")
        head_dim = c3 // (3 * heads)
        out = torch.empty((n, t, c3 // 3), dtype=qkv.dtype, device=qkv.device)
        self.launch(qkv.device, "overlap", qkv.data_ptr(), table.data_ptr(), out.data_ptr(), n, heads, head_dim, gh,
                    gw, head_dim**-0.5)
        return out


overlap_attention_kernel = OverlapAttentionKernel()


def overlap_attention(qkv: torch.Tensor, table: torch.Tensor, heads: int, grid: tuple[int, int], window: int,
                      overlap: int) -> torch.Tensor:
    """softmax(Q K^T / sqrt(D) + bias) V of each window and head, the keys
    and values of the ``overlap``-square window around each
    ``window``-square query window (zero past the border): qkv
    [B*nW, window^2, 3C] in the window layout, windows batch-major over a
    (grid_h, grid_w) grid -> [B*nW, window^2, C]."""
    if qkv.device.type == "cpu":
        return overlap_attention_reference(qkv, table, heads, grid, window, overlap)
    check_shapes(window, overlap, heads, qkv.shape[-1] // 3)
    return overlap_attention_kernel(qkv, table, heads, grid)

