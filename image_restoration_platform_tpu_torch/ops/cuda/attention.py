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

# what a block may use of an SM's shared memory (less the kernel's static
# barriers), and the SMs of an H100 SXM
MAX_SHARED_BYTES = 232_448 - 1024
H100_SM_COUNT = 132
# the wgmma variants: 128-key K/V stages of 128 * 2D bytes each for K and for
# V, 64 * 2D bytes of Q per consumer warpgroup (64 queries), two Q buffers in
# a persistent grid, and 1 KB of slack to align the ring to the 1024 bytes
# over which the 128-byte swizzle repeats; a key split adds block 0's region
# for the other blocks' partials (per consumer thread D / 2 floats of O, the
# max and the row sums of two rows)
WGMMA_TILE_KEYS = 128
WGMMA_WARPGROUP_ROWS = 64
WGMMA_MAX_STAGES = 4
WGMMA_ALIGN = 1024
WGMMA_SPLITS = (1, 2, 4)
# What a unit takes on its SM, in microseconds: (fixed, per 128-key tile) by
# (warpgroups working on it, D). The fixed part is the block's prologue and
# epilogue (barriers, the first loads, the store); in a persistent grid a unit
# after the first pays PERSISTENT_UNIT_US of it, a key split adds
# SPLIT_COMBINE_US for the hand-over. Fitted to the times of every plan at the
# launched shapes on an H100 SXM (chip_smoke.py --plan-sweep; PERF.md section 6).
UNIT_COST_US = {
    (3, 64): (4.39, 1.398), (2, 64): (3.78, 1.082), (1, 64): (2.24, 0.760),
    (3, 32): (3.39, 1.158), (2, 32): (3.81, 0.884), (1, 32): (2.06, 0.636),
}
PERSISTENT_UNIT_US = 1.27
SPLIT_COMBINE_US = 2.30
# a persistent grid is weighed only for units of at most this many key tiles
# by D: at D = 64 and T = 4096 the model would pick persistent plans that ran
# behind the best one-block-a-unit grid on the card (5 % at [2, 4, 4096, 64];
# the model does not see why), at D = 32 and T = 4096 they ran ahead
# (PERF.md section 6)
PERSISTENT_MAX_KEY_TILES = {64: 8, 32: 32}
# above this many waves of blocks the last one no longer matters
WGMMA_PLANNED_WAVES = 16
# the f32 variant: 32 queries and 64-key tiles, rows padded by 4 floats
F32_BLOCK_Q, F32_BLOCK_K, F32_PAD = 32, 64, 4

# variant name -> the code irp_flash_attention_fwd takes
VARIANTS = {"mma_sync": 0, "wgmma_q64": 1, "wgmma_q192": 2, "simt_f32": 3}


@dataclass(frozen=True)
class LaunchPlan:
    """How one call launches: which variant of the kernel, its tiles, the
    depth of its K/V ring, the grid and dynamic shared memory, and for the
    wgmma kernel its units of work and how the grid walks them."""

    variant: str
    block_q: int
    block_k: int
    stages: int
    threads: int
    shared_bytes: int
    grid: tuple[int, int]
    # wgmma_q192 only: the first full_heads of the N*H heads run units of
    # block_q queries, the rest units of block_q - 64; elsewhere all N*H
    full_heads: int
    # (head, query block) units; the grid's clusters walk them round-robin
    units: int
    # blocks of a cluster, each on an equal share of the keys (1: no split)
    splits: int = 1

    @property
    def clusters(self) -> int:
        return self.grid[0] * self.grid[1] // self.splits

    @property
    def schedule(self) -> str:
        """``split`` (a cluster of blocks a unit), ``persistent`` (fewer
        blocks than units, each walking several) or ``grid`` (a block a unit)."""
        if self.splits > 1:
            return "split"
        return "persistent" if self.clusters < self.units else "grid"


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


def wgmma_units(heads: int, t: int, consumers: int, full_heads: int) -> int:
    """The (head, query block) units of a launch: ceil(T / 192) for each of
    the first full_heads heads, T / 128 for the others (three warpgroups);
    T / 64 a head (one)."""
    if consumers == 1:
        return heads * (t // WGMMA_WARPGROUP_ROWS)
    return full_heads * -(-t // (3 * WGMMA_WARPGROUP_ROWS)) + (heads - full_heads) * (t // (2 * WGMMA_WARPGROUP_ROWS))


def wgmma_plan(heads: int, t: int, consumers: int, full_heads: int, *, d: int = 64, splits: int = 1,
               clusters: int | None = None) -> LaunchPlan:
    """The launch of the wgmma kernel on [heads, t, d] bf16 with one or three
    consumer warpgroups; with three, the first full_heads heads take
    192-query units and the rest 128-query units. ``splits`` blocks of a
    cluster share out the keys of each unit; ``clusters`` (default: one a
    unit) below the units makes the grid persistent, which takes alike units
    and no split."""
    tiles = t // WGMMA_TILE_KEYS
    if consumers not in (1, 3) or d not in KERNEL_HEAD_DIMS or t % WGMMA_TILE_KEYS != 0 or t < 1:
        raise ValueError(f"no wgmma kernel with {consumers} consumer warpgroups on T = {t}, D = {d}")
    if not 0 <= full_heads <= heads or (consumers == 1 and full_heads != heads):
        raise ValueError(f"{full_heads} of {heads} heads cannot take full blocks ({consumers} warpgroups)")
    if splits not in WGMMA_SPLITS or tiles % splits != 0:
        raise ValueError(f"{tiles} key tiles cannot be split {splits} ways")
    units = wgmma_units(heads, t, consumers, full_heads)
    clusters = units if clusters is None else clusters
    if not 1 <= clusters <= units:
        raise ValueError(f"{clusters} clusters for {units} units")
    persistent = clusters < units
    if persistent and (splits != 1 or full_heads not in (0, heads)):
        raise ValueError("a persistent grid takes alike units and no key split")
    block_q = consumers * WGMMA_WARPGROUP_ROWS
    stages = min(WGMMA_MAX_STAGES, tiles // splits)
    shared = (WGMMA_ALIGN + (2 if persistent else 1) * consumers * WGMMA_WARPGROUP_ROWS * 2 * d
              + 2 * stages * WGMMA_TILE_KEYS * 2 * d + (splits - 1) * consumers * 128 * (d // 2 + 4) * 4)
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"a {splits}-way split of {block_q}-query units needs {shared} bytes of shared memory")
    return LaunchPlan(f"wgmma_q{block_q}", block_q, WGMMA_TILE_KEYS, stages, (consumers + 1) * 128,
                      shared, (clusters * splits, 1), full_heads, units, splits)


def plan_us(plan: LaunchPlan, t: int, d: int, sm_count: int) -> float:
    """The model's time of a wgmma plan beyond the launch, from UNIT_COST_US,
    PERSISTENT_UNIT_US and SPLIT_COMBINE_US: a grid's blocks (full units,
    then small ones; a split's blocks of a unit together) handed out in
    order to the first free SM, one block an SM (``_waves``); a persistent
    grid's clusters each walking ceil(units / clusters) alike units, the
    first at the full fixed cost."""
    tiles = t // WGMMA_TILE_KEYS // plan.splits
    consumers = plan.block_q // WGMMA_WARPGROUP_ROWS
    if plan.schedule == "persistent":
        fixed, per_tile = UNIT_COST_US[(consumers if plan.full_heads else consumers - 1, d)]
        k = -(-plan.units // plan.clusters)
        return fixed + k * per_tile * tiles + (k - 1) * PERSISTENT_UNIT_US
    extra = SPLIT_COMBINE_US if plan.splits > 1 else 0.0
    full = UNIT_COST_US[(consumers, d)][0] + UNIT_COST_US[(consumers, d)][1] * tiles + extra
    full_units = plan.full_heads * -(-t // plan.block_q)
    if full_units == plan.units:
        return full * -(-plan.units * plan.splits // sm_count)
    small = UNIT_COST_US[(consumers - 1, d)][0] + UNIT_COST_US[(consumers - 1, d)][1] * tiles + extra
    return full * _waves(full_units * plan.splits, (plan.units - full_units) * plan.splits, small / full, sm_count)


def wgmma_candidates(heads: int, t: int, d: int, sm_count: int) -> list[LaunchPlan]:
    """Every plan the wrapper weighs for [heads, t, d] bf16: three
    warpgroups with each mix of 192- and 128-query units (the first
    full_heads heads on 192, from all heads down to none; beyond
    WGMMA_PLANNED_WAVES waves of 192-query units, where the last wave no
    longer matters, all heads on 192), one warpgroup; where the units are
    fewer than the SMs, each with its keys split 2 or 4 ways (as far as
    shared memory and the key tiles allow); where they are more and short
    enough (PERSISTENT_MAX_KEY_TILES), a persistent grid of one block an SM
    on alike units (192, 128 or 64 queries)."""
    per_full = -(-t // (3 * WGMMA_WARPGROUP_ROWS))
    mixes = [heads] if heads * per_full > WGMMA_PLANNED_WAVES * sm_count else range(heads, -1, -1)
    plans = [wgmma_plan(heads, t, 3, full, d=d) for full in mixes] + [wgmma_plan(heads, t, 1, heads, d=d)]
    for base in list(plans):
        if base.units < sm_count:
            for splits in WGMMA_SPLITS[1:]:
                try:
                    plans.append(wgmma_plan(heads, t, base.block_q // 64, base.full_heads, d=d, splits=splits))
                except ValueError:  # too few key tiles, or too much shared memory
                    pass
    if t // WGMMA_TILE_KEYS <= PERSISTENT_MAX_KEY_TILES[d]:
        for consumers, full in ((3, heads), (3, 0), (1, heads)):
            if wgmma_units(heads, t, consumers, full) > sm_count:
                plans.append(wgmma_plan(heads, t, consumers, full, d=d, clusters=sm_count))
    return plans


@functools.lru_cache(maxsize=256)
def _best_wgmma_plan(heads: int, t: int, d: int, sm_count: int) -> LaunchPlan:
    plans = wgmma_candidates(heads, t, d, sm_count)
    return min(plans, key=lambda p: (plan_us(p, t, d, sm_count), plans.index(p)))


def launch_plan(shape, dtype: torch.dtype, sm_count: int = H100_SM_COUNT) -> LaunchPlan:
    """The launch of an [N, H, T, D] call; raises on what no variant takes.

    bf16 with T a multiple of 128 takes the wgmma kernel, with the plan of
    ``wgmma_candidates`` that the model of measured unit costs
    (``plan_us``) ends first; ties go to the earlier candidate. Other bf16
    shapes take the mma.sync kernel, f32 the SIMT kernel."""
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
                          (t // F32_BLOCK_Q, n * h), n * h, n * h * (t // F32_BLOCK_Q))
    elif t % WGMMA_TILE_KEYS == 0:
        plan = _best_wgmma_plan(n * h, t, d, sm_count)
    else:
        plan = LaunchPlan("mma_sync", KERNEL_BLOCK, KERNEL_BLOCK, 1, 2 * KERNEL_BLOCK, 0,
                          (t // KERNEL_BLOCK, n * h), n * h, n * h * (t // KERNEL_BLOCK))
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

    name = "flash_attention"

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
                # nh, t, d, variant, stages, full_heads, clusters, splits, smem_bytes
                *[ctypes.c_int] * 9,
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
                  and plan == wgmma_plan(n * h, t, plan.block_q // WGMMA_WARPGROUP_ROWS, plan.full_heads,
                                         d=d, splits=plan.splits, clusters=plan.clusters)):
            raise ValueError(f"{plan} is no launch of the flash attention kernel on {tuple(q.shape)}")
        fn = self._bind()
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            err = fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                n * h, t, d, VARIANTS[plan.variant], plan.stages, plan.full_heads, plan.clusters,
                plan.splits, plan.shared_bytes, 1.0 / math.sqrt(d), stream,
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
