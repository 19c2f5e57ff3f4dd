"""The UNet's GroupNorm as two fused passes: the hand-written Hopper kernels
and their plain versions.

Ports no TPU kernel: it is the reference's XLA fusion of GroupNorm,
image_restoration_platform_tpu/models/nn.py:81-125, which computes one-pass
moments for the producing conv's epilogue and one folded per-(n, c) affine
for the SiLU and the next conv's prologue. The kernels
(csrc/group_norm.cu) give the port that traffic:

- ``gn_moments``: the per-(n, c) f32 sums s1 = sum_hw y and s2 = sum_hw y^2
  of an NHWC tensor; ``gn_film_moments`` first builds y from the raw conv
  output, y = film(r + conv bias), writes it and sums it;
- ``gn_affine_silu``: silu(cast(x * scale[n, c] + bias[n, c])) with the
  folded [N, C] f32 affine, or the cast affine alone.

Each public function takes the kernel for CUDA tensors, through an autograd
Function whose backward is the plain composition's own gradient recomputed in
PyTorch, and the plain version for CPU tensors; there is no other branch and
no fallback between them. The plain versions are the eager code the model
ran before (``models/nn.py``), moved here.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .attention import H100_SM_COUNT

SOURCE = "group_norm.cu"
THREADS = 256
# channels a thread owns (16 bytes) by activation type
VEC = {torch.bfloat16: 8, torch.float32: 4}
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the moments' H*W split: about eight blocks of 256 threads an SM of an H100
# SXM, but at least MIN_PIXELS_PER_THREAD pixels a thread
TARGET_BLOCKS = 8 * H100_SM_COUNT
MIN_PIXELS_PER_THREAD = 2


# ----------------------------------------------------------- plain versions


def moments_reference(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """NHWC x -> (s1, s2), the [N, C] f32 sums of x and x^2 over H and W."""
    xf = x.float()
    return xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))


def film_modulate(x: torch.Tensor, gamma_beta: torch.Tensor) -> torch.Tensor:
    """x * (1 + gamma) + beta, gamma and beta the halves of [N, 2C]."""
    gamma, beta = gamma_beta.chunk(2, dim=-1)
    return x * (1.0 + gamma[:, None, None, :]) + beta[:, None, None, :]


def film_moments_reference(raw: torch.Tensor, conv_bias: torch.Tensor, gamma_beta: torch.Tensor):
    """The conv bias add and FiLM on the raw conv output, then the moments:
    (y, s1, s2) with y = film_modulate(raw + conv_bias, gamma_beta) in raw's
    type."""
    y = film_modulate(raw + conv_bias.to(raw.dtype), gamma_beta.to(raw.dtype))
    return (y, *moments_reference(y))


def affine_silu_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, silu: bool = True):
    """cast(x * scale + bias) with [N, C] f32 scale and bias, then SiLU."""
    out = (x.float() * scale[:, None, None, :] + bias[:, None, None, :]).to(x.dtype)
    return torch.nn.functional.silu(out) if silu else out


# ----------------------------------------------------------------- kernels


def moments_plan(n: int, hw: int, c: int, dtype: torch.dtype) -> tuple[int, int, int]:
    """(splits, pixels a split, channel tiles) of the moments kernel: blocks
    of 256 threads, each a thread a channel vector of a pixel, so a block
    walks 256 / (C / vec) pixels at a time; H*W splits into chunks until
    N * splits * tiles reaches TARGET_BLOCKS or a thread would get fewer
    than MIN_PIXELS_PER_THREAD pixels."""
    vectors = c // VEC[dtype]
    tiles = -(-vectors // THREADS)
    rows = THREADS // min(THREADS, vectors)
    max_splits = max(1, hw // (rows * MIN_PIXELS_PER_THREAD))
    splits = max(1, min(-(-TARGET_BLOCKS // (n * tiles)), max_splits))
    chunk = -(-hw // splits)
    return -(-hw // chunk), chunk, tiles


def _check(name: str, x: torch.Tensor, dtype: torch.dtype | None = None, shape: tuple | None = None,
           rows: bool = False) -> None:
    """Device, type, shape and layout; ``rows``: an [N, C] f32 matrix whose
    rows may lie further apart than C (a column slice), 16-byte aligned."""
    if not x.is_cuda:
        raise ValueError(f"{name}: the fused GroupNorm kernels take CUDA tensors only")
    if dtype is not None and x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if shape is not None and tuple(x.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(x.shape)}")
    if rows:
        if x.stride(1) != 1 or x.stride(0) < x.shape[1] or x.stride(0) % 4:
            raise ValueError(f"{name}: the affine takes [N, C] rows of unit stride a multiple of 4 floats apart, "
                             f"got strides {x.stride()}")
    elif not x.is_contiguous():
        raise ValueError(f"{name}: the fused GroupNorm kernels take contiguous tensors, got strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: the fused GroupNorm kernels take 16-byte aligned tensors")


def _check_activation(x: torch.Tensor) -> tuple[int, int, int, int]:
    if x.dtype not in VEC:
        raise TypeError(f"the fused GroupNorm kernels take bf16 or f32 activations, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"the fused GroupNorm kernels take NHWC tensors, got {tuple(x.shape)}")
    _check("x", x)
    n, h, w, c = x.shape
    if c % VEC[x.dtype]:
        raise ValueError(f"the fused GroupNorm kernels take C a multiple of {VEC[x.dtype]} in {x.dtype}, got {c}")
    return n, h, w, c


class MomentsKernel(build.Kernel):
    """ctypes binding of ``irp_gn_moments`` with its launch count; the FiLM
    prologue is a variant of the same kernel."""

    name, variants = "gn_moments", ("moments", "film")
    source, symbol = SOURCE, "irp_gn_moments"
    argtypes = (*[ctypes.c_void_p] * 6, *[ctypes.c_int] * 7)

    def __call__(self, x: torch.Tensor, conv_bias: torch.Tensor | None = None,
                 gamma_beta: torch.Tensor | None = None):
        """(s1, s2) of x, both [N, C] f32; with ``conv_bias`` [C] and
        ``gamma_beta`` [N, 2C] in x's type, x is the raw conv output and the
        result is (y, s1, s2) with y = film_modulate(x + conv_bias,
        gamma_beta)."""
        n, h, w, c = _check_activation(x)
        film = conv_bias is not None
        if film != (gamma_beta is not None):
            raise ValueError("the FiLM prologue takes the conv bias and (gamma, beta) together")
        if film:
            _check("conv_bias", conv_bias, x.dtype, (c,))
            _check("gamma_beta", gamma_beta, x.dtype, (n, 2 * c))
        splits, chunk, _ = moments_plan(n, h * w, c, x.dtype)
        out = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
        partial = torch.empty((2, n, splits, c) if splits > 1 else (0,), dtype=torch.float32, device=x.device)
        y = torch.empty_like(x) if film else None
        self.launch(
            x.device, "film" if film else "moments",
            x.data_ptr(), conv_bias.data_ptr() if film else None, gamma_beta.data_ptr() if film else None,
            y.data_ptr() if film else None, partial.data_ptr() if splits > 1 else None, out.data_ptr(),
            n, h * w, c, splits, chunk, DTYPE_CODE[x.dtype], int(film),
        )
        return (y, out[0], out[1]) if film else (out[0], out[1])


class AffineSiluKernel(build.Kernel):
    """ctypes binding of ``irp_gn_affine_silu`` with its launch count."""

    name, variants = "gn_affine_silu", ("silu", "affine")
    source, symbol = SOURCE, "irp_gn_affine_silu"
    argtypes = (*[ctypes.c_void_p] * 4, *[ctypes.c_int] * 6)

    def __call__(self, x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, silu: bool = True) -> torch.Tensor:
        """silu(cast(x * scale + bias)) of NHWC x with [N, C] f32 scale and
        bias (``silu=False``: the cast affine alone), in x's type. Scale and
        bias may be column slices of wider [N, C'] matrices (one part of a
        virtual concat), with one row stride between them."""
        n, h, w, c = _check_activation(x)
        _check("scale", scale, torch.float32, (n, c), rows=True)
        _check("bias", bias, torch.float32, (n, c), rows=True)
        if scale.stride() != bias.stride():
            raise ValueError(f"scale and bias strides differ: {scale.stride()} and {bias.stride()}")
        out = torch.empty_like(x)
        self.launch(x.device, "silu" if silu else "affine", x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), n, h * w, c, scale.stride(0), DTYPE_CODE[x.dtype], int(silu))
        return out


moments_kernel = MomentsKernel()
affine_silu_kernel = AffineSiluKernel()


# ---------------------------------------------------------------- autograd


def _recomputed_grads(ctx, plain, grads) -> tuple:
    """The gradients of ``plain`` at the saved inputs: the plain
    composition's own backward, with its forward run again in PyTorch."""
    inputs = ctx.saved_tensors
    wanted = [i for i, need in enumerate(ctx.needs_input_grad[: len(inputs)]) if need]
    out: list = [None] * len(ctx.needs_input_grad)
    if not wanted:
        return tuple(out)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(inputs)]
        results = plain(*leaves)
        results = results if isinstance(results, tuple) else (results,)
        got = torch.autograd.grad(results, [leaves[i] for i in wanted], grads, allow_unused=True)
    for i, g in zip(wanted, got):
        out[i] = g
    return tuple(out)


class GNMoments(torch.autograd.Function):
    """Kernel forward (CUDA) or plain forward (CPU) of ``moments_reference``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return moments_reference(x) if x.device.type == "cpu" else moments_kernel(x)

    @staticmethod
    def backward(ctx, ds1, ds2):
        return _recomputed_grads(ctx, moments_reference, (ds1, ds2))


class GNFilmMoments(torch.autograd.Function):
    """Kernel forward (CUDA) or plain forward (CPU) of
    ``film_moments_reference``."""

    @staticmethod
    def forward(ctx, raw, conv_bias, gamma_beta):
        ctx.save_for_backward(raw, conv_bias, gamma_beta)
        if raw.device.type == "cpu":
            return film_moments_reference(raw, conv_bias, gamma_beta)
        return moments_kernel(raw, conv_bias, gamma_beta)

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        return _recomputed_grads(ctx, film_moments_reference, (dy, ds1, ds2))


class GNAffineSilu(torch.autograd.Function):
    """Kernel forward (CUDA) or plain forward (CPU) of
    ``affine_silu_reference``."""

    @staticmethod
    def forward(ctx, x, scale, bias, silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.silu = silu
        if x.device.type == "cpu":
            return affine_silu_reference(x, scale, bias, silu)
        return affine_silu_kernel(x, scale, bias, silu)

    @staticmethod
    def backward(ctx, dout):
        return _recomputed_grads(ctx, lambda x, s, b: affine_silu_reference(x, s, b, ctx.silu), (dout,))


# ----------------------------------------------------------- public entries


def gn_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """NHWC x -> (s1, s2), the [N, C] f32 sums of x and x^2 over H and W."""
    if x.device.type == "cpu":
        return moments_reference(x)
    return GNMoments.apply(x)


def gn_film_moments(raw: torch.Tensor, conv_bias: torch.Tensor, gamma_beta: torch.Tensor):
    """(y, s1, s2): y = film_modulate(raw + conv_bias, gamma_beta) from the
    raw (bias-free) conv output, and its moments. ``conv_bias`` [C] and
    ``gamma_beta`` [N, 2C] are cast to raw's type, as the eager chain does."""
    if raw.device.type == "cpu":
        return film_moments_reference(raw, conv_bias, gamma_beta)
    return GNFilmMoments.apply(raw, conv_bias.to(raw.dtype), gamma_beta.to(raw.dtype))


def gn_affine_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, silu: bool = True) -> torch.Tensor:
    """silu(cast(x * scale + bias)) with the folded [N, C] f32 affine
    (``silu=False``: the cast affine alone), in x's type."""
    if x.device.type == "cpu":
        return affine_silu_reference(x, scale, bias, silu)
    return GNAffineSilu.apply(x, scale, bias, silu)
