"""Bottleneck self-attention: the hand-written Hopper kernel and its plain version.

Counterpart of image_restoration_platform_tpu/ops/pallas/attention.py. The
kernel (csrc/flash_attention.cu) computes exact non-causal
softmax(Q K^T / sqrt(D)) V with f32 logits, probabilities rounded to the
input type before the P V product, f32 accumulation and one late divide by
the row sum. ``attention_reference`` is the same function in plain PyTorch.

``flash_attention`` takes the kernel for CUDA tensors and the plain version
for CPU tensors; there is no other branch and no fallback between them.

The source holds four variants of the kernel; ``launch_plan`` picks one per
call from the shape, the type and the number of SMs, and sizes its grid and
shared memory. It is plain Python, so the CPU tests reach it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from . import build

# the reference's query block: T must be a multiple of min(BQ, T)
BQ = 256
# the smallest query and key tile of any variant: T must be a multiple of it
KERNEL_BLOCK = 64
KERNEL_HEAD_DIMS = (32, 64)
SOURCE = "flash_attention.cu"

# what a block may use of an SM's shared memory, and the SMs of an H100 SXM
MAX_SHARED_BYTES = 232_448
H100_SM_COUNT = 132
# the wgmma variants: 128-key K/V stages of 16 KB each for K and for V, 8 KB of
# Q per consumer warpgroup (64 queries), 1 KB of slack to align the ring to the
# 1024 bytes over which the 128-byte swizzle repeats
WGMMA_TILE_KEYS = 128
WGMMA_WARPGROUP_ROWS = 64
WGMMA_MAX_STAGES = 4
WGMMA_ALIGN = 1024
# What one block costs beside a block of three consumer warpgroups (192
# queries), measured on an H100 at T = 4096 (all blocks walk the same keys, so
# fewer queries make a block cheaper, but not in proportion): two warpgroups
# (128 queries) 0.80, one warpgroup in a block of its own (64 queries) 0.52.
WGMMA_COST_Q128 = 0.80
WGMMA_COST_Q64 = 0.52
# above this many waves of blocks the last wave no longer matters
WGMMA_PLANNED_WAVES = 16
# the f32 variant: 32 queries and 64-key tiles, rows padded by 4 floats
F32_BLOCK_Q, F32_BLOCK_K, F32_PAD = 32, 64, 4

# variant name -> the code irp_flash_attention_fwd takes
VARIANTS = {"mma_sync": 0, "wgmma_q64": 1, "wgmma_q192": 2, "simt_f32": 3}


@dataclass(frozen=True)
class LaunchPlan:
    """How one call launches: which variant of the kernel, its tiles, the
    depth of its K/V ring, and the grid and dynamic shared memory."""

    variant: str
    block_q: int
    block_k: int
    stages: int
    threads: int
    shared_bytes: int
    grid: tuple[int, int]
    # wgmma_q192 only: the first full_heads of the N*H heads run blocks of
    # block_q queries, the rest blocks of block_q - 64; elsewhere all N*H
    full_heads: int


def _waves(full_blocks: int, small_blocks: int, small_cost: float, sm_count: int) -> float:
    """When the last block ends, in units of one full block, if the card hands
    full_blocks blocks of cost 1 and then small_blocks blocks of small_cost to
    sm_count SMs, each to the first SM that is free, one block an SM."""
    rounds, busy = divmod(full_blocks, sm_count)  # busy SMs are free at rounds + 1, the others at rounds
    end_full = rounds + (1 if busy else 0)
    if small_blocks == 0:
        return float(end_full)
    best = math.inf
    for k in range(-(-small_blocks // sm_count) + 2):  # rounds of small blocks on the SMs free first
        rest = small_blocks - (sm_count - busy) * k
        if rest <= 0:
            end = rounds + k * small_cost
        elif busy == 0:
            continue
        else:
            end = max(rounds + k * small_cost, rounds + 1 + -(-rest // busy) * small_cost)
        best = min(best, max(end, end_full))
    return best


@functools.lru_cache(maxsize=256)
def _wgmma_split(heads: int, t: int, sm_count: int) -> tuple[float, int]:
    """(waves, full_heads) of the three-warpgroup kernel: how many heads take
    192-query blocks so that the last wave of blocks is shortest. At
    [32, 4096] on 132 SMs 704 blocks of 192 queries are 5.33 waves, six
    rounds of which the last is a third full; 24 heads of them (4 waves) and
    8 heads of 128-query blocks (1.94 waves at 0.80 each) end after 5.6."""
    per_full = -(-t // (3 * WGMMA_WARPGROUP_ROWS))
    per_small = t // (2 * WGMMA_WARPGROUP_ROWS)
    if heads * per_full > WGMMA_PLANNED_WAVES * sm_count:
        return heads * per_full / sm_count, heads
    # ties go to the plan with more full heads
    waves, minus_full = min(
        (_waves(full * per_full, (heads - full) * per_small, WGMMA_COST_Q128, sm_count), -full)
        for full in range(heads + 1))
    return waves, -minus_full


def wgmma_plan(heads: int, t: int, consumers: int, full_heads: int) -> LaunchPlan:
    """The launch of the wgmma kernel on [heads, t, 64] bf16 with one or three
    consumer warpgroups; with three, the first full_heads heads take
    192-query blocks and the rest 128-query blocks."""
    if consumers not in (1, 3) or t % WGMMA_TILE_KEYS != 0:
        raise ValueError(f"no wgmma kernel with {consumers} consumer warpgroups on T = {t}")
    if not 0 <= full_heads <= heads or (consumers == 1 and full_heads != heads):
        raise ValueError(f"{full_heads} of {heads} heads cannot take full blocks ({consumers} warpgroups)")
    block_q = consumers * WGMMA_WARPGROUP_ROWS
    stages = min(WGMMA_MAX_STAGES, t // WGMMA_TILE_KEYS)
    shared = WGMMA_ALIGN + 2 * 64 * (block_q + 2 * stages * WGMMA_TILE_KEYS)
    # the grid is sized for the heads with the smaller blocks, if any
    smallest = block_q if full_heads == heads else block_q - WGMMA_WARPGROUP_ROWS
    return LaunchPlan(f"wgmma_q{block_q}", block_q, WGMMA_TILE_KEYS, stages, (consumers + 1) * 128,
                      shared, (-(-t // smallest), heads), full_heads)


def launch_plan(shape, dtype: torch.dtype, sm_count: int = H100_SM_COUNT) -> LaunchPlan:
    """The launch of an [N, H, T, D] call; raises on what no variant takes.

    bf16 with D = 64 and T a multiple of 128 takes the wgmma kernel, with
    the tile that ends first by the count of waves: three consumer
    warpgroups on 192 queries a block (the last block of a head may reach
    past it; some heads may take 128-query blocks to shorten the last wave,
    ``_wgmma_split``), or one warpgroup on 64 queries, which gives a small
    grid three times the blocks. Other bf16 shapes take the mma.sync kernel,
    f32 the SIMT kernel."""
    if len(shape) != 4:
        raise ValueError(f"q/k/v must be [N, H, T, D], got {tuple(shape)}")
    n, h, t, d = (int(x) for x in shape)
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash attention kernel takes bf16 or f32, got {dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head dim {KERNEL_HEAD_DIMS}, got {d}")
    if n < 1 or h < 1 or t < 1 or t % KERNEL_BLOCK != 0:
        raise ValueError(f"flash attention kernel takes T a multiple of {KERNEL_BLOCK}, got {t}")
    if n * h > 65535 or n * h * t >= 2**31:
        raise ValueError(f"flash attention kernel takes at most 65535 (batch x head) and 2^31 rows, got {n * h} x {t}")
    if dtype == torch.float32:
        floats = (F32_BLOCK_Q + 4 * F32_BLOCK_K) * (d + F32_PAD) + F32_BLOCK_Q * (F32_BLOCK_K + F32_PAD)
        plan = LaunchPlan("simt_f32", F32_BLOCK_Q, F32_BLOCK_K, 2, 4 * F32_BLOCK_Q, 4 * floats,
                          (t // F32_BLOCK_Q, n * h), n * h)
    elif d == 64 and t % WGMMA_TILE_KEYS == 0:
        waves_q192, full_heads = _wgmma_split(n * h, t, sm_count)
        waves_q64 = -(-(n * h * (t // WGMMA_WARPGROUP_ROWS)) // sm_count) * WGMMA_COST_Q64
        if waves_q192 <= waves_q64:
            plan = wgmma_plan(n * h, t, 3, full_heads)
        else:
            plan = wgmma_plan(n * h, t, 1, n * h)
    else:
        plan = LaunchPlan("mma_sync", KERNEL_BLOCK, KERNEL_BLOCK, 1, 2 * KERNEL_BLOCK, 0,
                          (t // KERNEL_BLOCK, n * h), n * h)
    assert plan.shared_bytes <= MAX_SHARED_BYTES and 0 <= plan.full_heads <= n * h
    return plan


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
        self.launches_by_variant = {name: 0 for name in VARIANTS}
        self._fn = None
        self._sm_counts: dict = {}

    def _bind(self):
        if self._fn is None:
            fn = build.load(SOURCE).irp_flash_attention_fwd
            fn.argtypes = [
                *[ctypes.c_void_p] * 4,  # q, k, v, o
                *[ctypes.c_int] * 7,  # nh, t, d, variant, stages, full_heads, smem_bytes
                ctypes.c_float, ctypes.c_void_p,  # scale, stream
            ]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _sm_count(self, device: torch.device) -> int:
        if device not in self._sm_counts:
            self._sm_counts[device] = torch.cuda.get_device_properties(device).multi_processor_count
        return self._sm_counts[device]

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 plan: LaunchPlan | None = None) -> torch.Tensor:
        """[N, H, T, D] CUDA q/k/v (bf16 or f32, contiguous) -> [N, H, T, D].
        ``plan`` overrides the choice of ``launch_plan`` (a check may ask for
        any ``wgmma_plan`` on a shape the wgmma kernel takes)."""
        if not (q.is_cuda and k.is_cuda and v.is_cuda):
            raise ValueError("the flash attention kernel takes CUDA tensors only")
        if not (q.shape == k.shape == v.shape) or q.dim() != 4:
            raise ValueError(f"q/k/v must share one [N, H, T, D] shape: {q.shape} {k.shape} {v.shape}")
        if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"flash attention kernel takes bf16 or f32, got {q.dtype}/{k.dtype}/{v.dtype}")
        if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
            raise ValueError("flash attention kernel takes contiguous q/k/v")
        if any(x.data_ptr() % 16 for x in (q, k, v)):
            raise ValueError("flash attention kernel takes q/k/v aligned to 16 bytes")
        n, h, t, d = q.shape
        chosen = launch_plan(q.shape, q.dtype, self._sm_count(q.device))
        if plan is None:
            plan = chosen
        elif not (chosen.variant.startswith("wgmma") and plan.variant.startswith("wgmma")
                  and plan == wgmma_plan(n * h, t, plan.block_q // WGMMA_WARPGROUP_ROWS, plan.full_heads)):
            raise ValueError(f"{plan} is no launch of the flash attention kernel on {tuple(q.shape)}")
        fn = self._bind()
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            err = fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                n * h, t, d, VARIANTS[plan.variant], plan.stages, plan.full_heads, plan.shared_bytes,
                1.0 / math.sqrt(d), stream,
            )
        if err != 0:
            what = f"tensor-map encode, CUresult {err - 10000}" if err >= 10000 else f"cudaError {err}"
            raise RuntimeError(f"flash attention launch failed ({plan}): {what}")
        self.launches += 1
        self.launches_by_variant[plan.variant] += 1
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
