"""Bottleneck self-attention: the hand-written Hopper kernel and its plain version.

Counterpart of image_restoration_platform_tpu/ops/pallas/attention.py. The
kernel (csrc/flash_attention.cu) computes exact non-causal
softmax(Q K^T / sqrt(D)) V with f32 logits, probabilities rounded to the
input type before the P V product, f32 accumulation and one late divide by
the row sum. ``attention_reference`` is the same function in plain PyTorch.

``flash_attention`` takes the kernel for CUDA tensors and the plain version
for CPU tensors; there is no other branch and no fallback between them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

# the reference's query block: T must be a multiple of min(BQ, T)
BQ = 256
# the CUDA kernel's query and key tile
KERNEL_BLOCK = 64
KERNEL_HEAD_DIMS = (32, 64)
SOURCE = "flash_attention.cu"


def bf16_parity_bar(ref: torch.Tensor) -> float:
    """max |kernel - plain| allowed on bf16 outputs: 0.02 (the reference's
    own bar, tests/test_pallas_attention.py), and at most 4 bf16 units in
    the last place of max |ref|. At T = 4096 and unit-variance inputs a
    typical output is ~0.03, as large as 0.02 itself; the second term keeps
    the bar relative to the outputs."""
    peak = float(ref.detach().float().abs().max())
    return min(0.02, 4.0 * 2.0 ** (math.floor(math.log2(peak)) - 7))


def _check_tokens(t: int) -> None:
    if t % min(BQ, t) != 0:
        raise ValueError(f"token count {t} must be a multiple of the {BQ} query block")


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain [N, H, T, D] attention: f32 logits and softmax, probabilities
    cast to V's type, P V accumulated in f32, output in q's type."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


class FlashKernel:
    """ctypes binding of ``irp_flash_attention_fwd`` with its launch count."""

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    def _bind(self):
        if self._fn is None:
            fn = build.load(SOURCE).irp_flash_attention_fwd
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """[N, H, T, D] CUDA q/k/v (bf16 or f32, contiguous) -> [N, H, T, D]."""
        if not (q.is_cuda and k.is_cuda and v.is_cuda):
            raise ValueError("the flash attention kernel takes CUDA tensors only")
        if not (q.shape == k.shape == v.shape) or q.dim() != 4:
            raise ValueError(f"q/k/v must share one [N, H, T, D] shape: {q.shape} {k.shape} {v.shape}")
        if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"flash attention kernel takes bf16 or f32, got {q.dtype}/{k.dtype}/{v.dtype}")
        if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
            raise ValueError("flash attention kernel takes contiguous q/k/v")
        n, h, t, d = q.shape
        if d not in KERNEL_HEAD_DIMS:
            raise ValueError(f"flash attention kernel takes head dim {KERNEL_HEAD_DIMS}, got {d}")
        if t % KERNEL_BLOCK != 0:
            raise ValueError(f"flash attention kernel takes T a multiple of {KERNEL_BLOCK}, got {t}")
        fn = self._bind()
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            err = fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                n * h, t, d, int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d), stream,
            )
        if err != 0:
            raise RuntimeError(f"flash attention launch failed: cudaError {err}")
        self.launches += 1
        return out


flash_kernel = FlashKernel()


class FlashAttention(torch.autograd.Function):
    """Kernel forward (CUDA) or plain forward (CPU); backward recomputes
    the probabilities in plain PyTorch and applies the exact softmax VJP,
    as the reference's custom VJP does in plain XLA."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return attention_reference(q, k, v)
        return flash_kernel(q, k, v)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        scale = 1.0 / math.sqrt(q.shape[-1])
        qf, kf, vf = q.float(), k.float(), v.float()
        probs = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
        do = dout.float()
        dv = torch.matmul(probs.transpose(-1, -2), do)
        dp = torch.matmul(do, vf.transpose(-1, -2))
        ds = probs * (dp - torch.sum(dp * probs, dim=-1, keepdim=True))
        dq = torch.matmul(ds, kf) * scale
        dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[N, H, T, D] q/k/v -> [N, H, T, D]; exact softmax(Q K^T / sqrt(D)) V."""
    _check_tokens(q.shape[2])
    return FlashAttention.apply(q, k, v)
