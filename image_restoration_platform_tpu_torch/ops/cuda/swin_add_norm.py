"""The Swin transformer's residual add and LayerNorm with the shifted windows'
addressing: the hand-written Hopper kernel and its plain version.

Ports no TPU kernel: the JAX package has no transformer. A Swin layer of
SwinIR (models/swinir.py) normalises its token stream before the window
attention, in the rolled window layout the qkv linear reads, and again
before the MLP, in token order, after adding the attention's output back
through the inverse map. The kernel (csrc/swin_add_norm.cu) does each of the
two in one pass over the residual stream, with the residual add before it:

- ``add_norm_to_windows(x, a, ...)``: ``s = x + a`` (``a`` None: ``s`` is
  ``x``) in token order, and ``LayerNorm(s)`` rolled by ``-shift`` and cut
  into windows, ``[B * nW, window^2, C]``;
- ``add_norm_from_windows(x, p, ...)``: ``s = x + roll(+shift)(reverse(p))``
  and ``LayerNorm(s)``, both in token order ``[B, H, W, C]``.

Both take the kernel for CUDA tensors and the plain version for CPU tensors;
there is no other branch and no fallback between them. ``check_shapes``
states what the kernel takes; the engine calls it when it loads a SwinIR
family (``models.registry.check_attention_shapes``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from . import build

SOURCE = "swin_add_norm.cu"
KERNEL_WINDOW = 8
KERNEL_MAX_CHANNELS = 256


def check_shapes(window: int, channels: int) -> None:
    """Raise unless the kernel takes windows of ``window`` x ``window``
    tokens of ``channels`` channels (shifted by half a window)."""
    if window != KERNEL_WINDOW:
        raise ValueError(f"the add-norm kernel takes windows of {KERNEL_WINDOW}, got {window}")
    if channels % 4 or not 4 <= channels <= KERNEL_MAX_CHANNELS:
        raise ValueError(f"the add-norm kernel takes a multiple of 4 channels up to {KERNEL_MAX_CHANNELS}, "
                         f"got {channels}")


# ----------------------------------------------------------- plain version


@lru_cache(maxsize=16)
def window_tokens(grid: tuple[int, int], window: int, shift: int) -> torch.Tensor:
    """[gh * gw * window^2] int64: for each row of one image's rolled window
    layout, the token (y * W + x) of the image it holds:
    ((wy * window + ty + shift) mod H, (wx * window + tx + shift) mod W)."""
    gh, gw = grid
    h, w = gh * window, gw * window
    wy, wx, ty, tx = torch.meshgrid(torch.arange(gh), torch.arange(gw), torch.arange(window), torch.arange(window),
                                    indexing="ij")
    return (((wy * window + ty + shift) % h) * w + (wx * window + tx + shift) % w).reshape(-1)


@lru_cache(maxsize=16)
def token_windows(grid: tuple[int, int], window: int, shift: int) -> torch.Tensor:
    """The inverse of ``window_tokens``: for each token of the image, its
    row in the rolled window layout."""
    return torch.argsort(window_tokens(grid, window, shift))


def add_norm_to_windows_reference(x: torch.Tensor, a: torch.Tensor | None, weight: torch.Tensor,
                                  bias: torch.Tensor, eps: float, shift: int,
                                  window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain: ``s = x + a`` and F.layer_norm of ``s``'s tokens gathered into
    the rolled window layout."""
    s = x if a is None else x + a
    b, h, w, c = s.shape
    rows = window_tokens((h // window, w // window), window, shift).to(s.device)
    y = F.layer_norm(s.reshape(b, h * w, c)[:, rows], (c,), weight, bias, eps)
    return s, y.reshape(-1, window * window, c)


def add_norm_from_windows_reference(x: torch.Tensor, p: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                                    eps: float, shift: int, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain: ``s = x + p`` gathered back into token order, and
    F.layer_norm of ``s``."""
    b, h, w, c = x.shape
    rows = token_windows((h // window, w // window), window, shift).to(x.device)
    s = x + p.reshape(b, h * w, c)[:, rows].reshape(b, h, w, c)
    return s, F.layer_norm(s, (c,), weight, bias, eps)


# ------------------------------------------------------------------ kernel


class SwinAddNormKernel(build.Kernel):
    """ctypes binding of ``irp_swin_add_norm`` with its launch count."""

    name, variants = "swin_add_norm", ("to_windows", "from_windows")
    source, symbol = SOURCE, "irp_swin_add_norm"
    argtypes = (*[ctypes.c_void_p] * 6, *[ctypes.c_int] * 6, ctypes.c_float)

    def __call__(self, variant: str, x: torch.Tensor, a: torch.Tensor | None, weight: torch.Tensor,
                 bias: torch.Tensor, eps: float, shift: int) -> tuple[torch.Tensor, torch.Tensor]:
        """``variant`` "to_windows": x and a (or None) [B, H, W, C] ->
        (s [B, H, W, C], y [B * nW, 64, C]); "from_windows": x [B, H, W, C]
        and p [B * nW, 64, C] -> (s, y), both [B, H, W, C]. All CUDA bf16,
        contiguous and 16-byte aligned; weight and bias bf16 [C]."""
        if variant not in self.launches_by_variant:
            raise ValueError(f"unknown add-norm variant {variant!r}")
        to_windows = variant == "to_windows"
        if a is None and not to_windows:
            raise ValueError("from_windows needs the window-layout operand")
        tensors = [t for t in (x, a, weight, bias) if t is not None]
        if not all(t.is_cuda and t.device == x.device for t in tensors):
            raise ValueError("the add-norm kernel takes CUDA tensors on one device only")
        if any(t.dtype != torch.bfloat16 for t in tensors):
            raise TypeError(f"the add-norm kernel takes bf16 tensors, got {[t.dtype for t in tensors]}")
        if x.dim() != 4:
            raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
        b, h, w, c = x.shape
        check_shapes(KERNEL_WINDOW, c)
        if h % KERNEL_WINDOW or w % KERNEL_WINDOW or not (h and w and b):
            raise ValueError(f"the token grid {h} x {w} is no whole number of {KERNEL_WINDOW} x {KERNEL_WINDOW} windows")
        gh, gw = h // KERNEL_WINDOW, w // KERNEL_WINDOW
        windows = b * gh * gw
        a_shape = tuple(x.shape) if to_windows else (windows, KERNEL_WINDOW**2, c)
        if a is not None and tuple(a.shape) != a_shape:
            raise ValueError(f"the operand must be {list(a_shape)}, got {tuple(a.shape)}")
        if tuple(weight.shape) != (c,) or tuple(bias.shape) != (c,):
            raise ValueError(f"the affine must be [{c}], got {tuple(weight.shape)} and {tuple(bias.shape)}")
        if shift % 2 or not 0 <= shift < KERNEL_WINDOW:
            raise ValueError(f"the add-norm kernel takes an even shift in [0, {KERNEL_WINDOW}), got {shift}")
        if not all(t.is_contiguous() for t in tensors) or any(t.data_ptr() % 16 for t in (x, a) if t is not None) \
                or any(t.data_ptr() % 4 for t in (weight, bias)):
            raise ValueError("the add-norm kernel takes contiguous tensors, x and the operand 16-byte aligned")
        s = torch.empty_like(x) if a is not None else x
        y = torch.empty((windows, KERNEL_WINDOW**2, c) if to_windows else (b, h, w, c), dtype=x.dtype, device=x.device)
        self.launch(x.device, variant, x.data_ptr(), a.data_ptr() if a is not None else None, weight.data_ptr(),
                    bias.data_ptr(), s.data_ptr() if a is not None else None, y.data_ptr(), int(to_windows), windows,
                    c, gh, gw, shift, float(eps))
        return s, y


swin_add_norm_kernel = SwinAddNormKernel()


def add_norm_to_windows(x: torch.Tensor, a: torch.Tensor | None, weight: torch.Tensor, bias: torch.Tensor,
                        eps: float, shift: int, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x, a [B, H, W, C] in token order (``a`` None: no add) ->
    (s = x + a [B, H, W, C], LayerNorm(s) rolled by ``-shift`` and cut into
    windows [B * nW, window^2, C], windows batch-major and row-major over the
    grid, tokens row-major in a window)."""
    if x.device.type == "cpu":
        return add_norm_to_windows_reference(x, a, weight, bias, eps, shift, window)
    check_shapes(window, x.shape[-1])
    return swin_add_norm_kernel("to_windows", x, a, weight, bias, eps, shift)


def add_norm_from_windows(x: torch.Tensor, p: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                          shift: int, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, H, W, C] in token order, p [B * nW, window^2, C] in the rolled
    window layout -> (s = x + roll(+shift)(reverse(p)), LayerNorm(s)), both
    [B, H, W, C]."""
    if x.device.type == "cpu":
        return add_norm_from_windows_reference(x, p, weight, bias, eps, shift, window)
    check_shapes(window, x.shape[-1])
    return swin_add_norm_kernel("from_windows", x, p, weight, bias, eps, shift)
