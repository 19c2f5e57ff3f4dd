"""PyTorch port: bottleneck flash attention against the JAX Pallas kernel.

On the CPU the port's ``flash_attention`` takes its plain version (the
CUDA kernel runs only on the card); the JAX side runs the Pallas kernel in
interpret mode. Bars: in bf16 ``bf16_parity_bar`` (0.02, the reference's
own from tests/test_pallas_attention.py, and at most 4 bf16 ulps of the
largest output), 1e-5 in f32, and rtol/atol 2e-2 for gradients. The kernel
itself is held against the plain version on the card by the ``cuda``-marked
tests below and by chip_smoke.py; what surrounds it is tested here: the
launch plan (variant, tiles, grid, shared memory) and a plain emulation of
the kernel's schedule."""

import heapq
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu.ops.pallas.attention import flash_attention as jflash
from image_restoration_platform_tpu_torch.ops.cuda import attention as A

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke_module():
    """chip_smoke.py as a module (it imports nothing but the standard
    library until it runs): its shapes are the ones the plans are tested at."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _smoke_module()
SMOKE_SHAPES = [(shape, dtype) for shape, dtype, _ in SMOKE.KERNEL_SHAPES]


def _inputs(shape, seed, np_dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np_dtype) for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 4, 256, 64), (1, 2, 512, 64), (2, 4, 16, 8)])
def test_bf16_matches_jax_kernel(shape):
    q, k, v = _inputs(shape, 0)
    ref = jflash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    got = A.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    assert float((got.float() - ref).abs().max()) <= A.bf16_parity_bar(ref)


def test_f32_matches_jax_kernel():
    q, k, v = _inputs((1, 2, 256, 32), 1)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jflash(*(jnp.asarray(a) for a in (q, k, v))))
    got = A.flash_attention(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_gradients_match_jax():
    q, k, v = _inputs((1, 2, 64, 16), 2)

    def loss_jax(q, k, v):
        return jnp.sum(jnp.square(jflash(q, k, v).astype(jnp.float32)))

    with jax.default_matmul_precision("highest"):
        gj = jax.grad(loss_jax, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    torch.sum(A.flash_attention(qt, kt, vt) ** 2).backward()
    for got, ref in zip((qt.grad, kt.grad, vt.grad), gj):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-2, atol=2e-2)


def test_odd_token_count_rejected():
    q = torch.zeros((1, 1, 300, 8))
    with pytest.raises(ValueError):
        A.flash_attention(q, q, q)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper has no CPU path: the plain version is chosen by
    flash_attention only for CPU tensors, never inside the wrapper."""
    q = torch.zeros((1, 1, 64, 32), dtype=torch.bfloat16)
    launches = A.flash_kernel.launches
    with pytest.raises(ValueError):
        A.flash_kernel(q, q, q)
    assert A.flash_kernel.launches == launches


def test_reference_rounds_probs_to_value_dtype():
    """P is cast to V's type before P V (the TPU kernel's contract): in bf16
    the plain version differs from an f32-probability product."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs((1, 1, 64, 32), 3))
    got = A.attention_reference(q, k, v).float()
    probs = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / np.sqrt(32)), -1)
    exact = (probs @ v.float()).to(torch.bfloat16).float()
    rounded = (probs.to(torch.bfloat16).float() @ v.float()).to(torch.bfloat16).float()
    assert torch.equal(got, rounded)
    assert float((got - exact).abs().max()) < 0.02


def _randn(shape, device, dtype, q_scale=1.0, v_scale=1.0):
    """Seeded q/k/v; q_scale 4 peaks the logits (std 4), v_scale keeps the
    outputs below 1 there. Both are powers of two, exact in bf16."""
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype) for _ in range(3))
    return q * q_scale, k, v * v_scale


@pytest.mark.parametrize("scales", [(1.0, 1.0), (4.0, 0.125)], ids=["randn", "peaked"])
@pytest.mark.parametrize("shape", [(1, 1, 4096, 64), (1, 4, 1024, 64)])
@pytest.mark.parametrize("fault", ["tile_dropped", "tile_left_out_of_pv", "tile128_dropped",
                                   "tile128_left_out_of_pv"])
def test_bf16_bar_rejects_a_skipped_key_tile(shape, scales, fault):
    """The bar the kernel is held to on the card is sharp enough to catch a
    kernel that skips one key tile (64 keys, the mma.sync variant's; 128 keys,
    the wgmma variants'), at the path's own T."""
    q, k, v = _randn(shape, "cpu", torch.bfloat16, *scales)
    ref = A.attention_reference(q, k, v)
    keys = A.WGMMA_TILE_KEYS if fault.startswith("tile128") else A.KERNEL_BLOCK
    tile = slice(3 * keys, 4 * keys)
    if fault.endswith("tile_dropped") or fault.endswith("tile128_dropped"):  # the tile is missing from the softmax
        keep = torch.ones(shape[2], dtype=torch.bool)
        keep[tile] = False
        bad = A.attention_reference(q, k[:, :, keep].contiguous(), v[:, :, keep].contiguous())
    else:  # the tile counts in the row sum but not in P V
        v_bad = v.clone()
        v_bad[:, :, tile] = 0
        bad = A.attention_reference(q, k, v_bad)
    assert float((bad.float() - ref.float()).abs().max()) > 4 * A.bf16_parity_bar(ref)


# ------------------------------------------------------------ the launch plan


def _blocks_cover(plan, heads, t):
    """Every head's query rows are covered by the blocks the grid gives it."""
    small = plan.block_q - A.WGMMA_WARPGROUP_ROWS
    for head in (0, plan.full_heads - 1, plan.full_heads, heads - 1):
        if not 0 <= head < heads:
            continue
        rows = plan.block_q if head < plan.full_heads else small
        blocks = -(-t // rows)
        assert blocks <= plan.grid[0] and blocks * rows >= t > (blocks - 1) * rows
    assert plan.grid[1] == heads


@pytest.mark.parametrize("shape,dtype", SMOKE_SHAPES + [((3, 4, 4096, 64), "bfloat16")],
                         ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else x)
def test_launch_plan_of_the_paths_shapes(shape, dtype):
    n, h, t, d = shape
    plan = A.launch_plan(shape, getattr(torch, dtype), sm_count=132)
    expected = {
        ((1, 4, 1024, 64), "bfloat16"): ("wgmma_q64", 64, 128, 4, 256, 4),
        ((8, 4, 4096, 64), "bfloat16"): ("wgmma_q192", 192, 128, 4, 512, 24),
        ((3, 4, 4096, 64), "bfloat16"): ("wgmma_q192", 192, 128, 4, 512, 12),
        ((2, 2, 1024, 32), "bfloat16"): ("mma_sync", 64, 64, 1, 128, 4),
        ((1, 4, 192, 64), "bfloat16"): ("mma_sync", 64, 64, 1, 128, 4),
        ((1, 4, 1024, 64), "float32"): ("simt_f32", 32, 64, 2, 128, 4),
        # training: 128 heads of 256 keys (two 192-query blocks a head, two
        # 128-key stages), and of 1024 keys (all heads on 192-query blocks)
        ((32, 4, 256, 64), "bfloat16"): ("wgmma_q192", 192, 128, 2, 512, 4),
        ((32, 4, 1024, 64), "bfloat16"): ("wgmma_q192", 192, 128, 4, 512, 128),
        # the mesh paths' shards: 8 and 4 heads of 4096 keys all on 128-query
        # blocks (their last wave ends sooner than with 192-query blocks), 16
        # heads with 12 on 192-query blocks; the f32 train check's slot
        ((2, 4, 4096, 64), "bfloat16"): ("wgmma_q192", 192, 128, 4, 512, 0),
        ((1, 4, 4096, 64), "bfloat16"): ("wgmma_q192", 192, 128, 4, 512, 0),
        ((4, 4, 4096, 64), "bfloat16"): ("wgmma_q192", 192, 128, 4, 512, 12),
        ((4, 4, 256, 64), "float32"): ("simt_f32", 32, 64, 2, 128, 16),
    }[(shape, dtype)]
    assert (plan.variant, plan.block_q, plan.block_k, plan.stages, plan.threads, plan.full_heads) == expected
    assert plan.variant in A.VARIANTS and 0 <= plan.shared_bytes <= 232_448
    if plan.variant.startswith("wgmma"):
        consumers = plan.block_q // 64
        assert plan.threads == (consumers + 1) * 128
        # 1 KB to align, 8 KB of Q a warpgroup, 16 KB each of K and V a stage
        assert plan.shared_bytes == 1024 + consumers * 8192 + plan.stages * 2 * 16384
        assert t % plan.block_k == 0 and 1 <= plan.stages <= t // plan.block_k
        _blocks_cover(plan, n * h, t)
    else:
        assert plan.grid == (t // plan.block_q, n * h) and plan.full_heads == n * h
    if plan.variant == "simt_f32":
        assert plan.shared_bytes == 4 * ((32 + 4 * 64) * (d + 4) + 32 * (64 + 4))


def test_every_variant_has_a_smoke_shape():
    seen = {A.launch_plan(shape, getattr(torch, dtype)).variant for shape, dtype in SMOKE_SHAPES}
    assert seen == set(A.VARIANTS) == set(SMOKE.ATTENTION_VARIANTS)
    n, h, t, d = SMOKE.FORCED_PLAN_SHAPE
    forced = [A.wgmma_plan(n * h, t, consumers, full) for consumers, full in SMOKE.FORCED_PLANS]
    assert {(p.block_q, p.full_heads) for p in forced} == {(64, 20), (192, 20), (192, 7), (192, 0)}
    for plan in forced:
        _blocks_cover(plan, n * h, t)
    assert t % 192 != 0  # the last 192-query block of a head reaches past it


@pytest.mark.parametrize("shape,dtype,exc", [
    ((1, 4, 1024, 48), torch.bfloat16, ValueError),  # head dim
    ((1, 4, 1000, 64), torch.bfloat16, ValueError),  # T no multiple of 64
    ((1, 4, 1024, 64), torch.float16, TypeError),
    ((4, 1024, 64), torch.bfloat16, ValueError),
    ((16384, 4, 64, 64), torch.bfloat16, ValueError),  # more than 65535 heads
    ((0, 4, 1024, 64), torch.bfloat16, ValueError),
])
def test_launch_plan_refuses_what_no_variant_takes(shape, dtype, exc):
    with pytest.raises(exc):
        A.launch_plan(shape, dtype)


@pytest.mark.parametrize("heads,t,consumers,full", [(4, 1024, 2, 4), (4, 192, 3, 4), (4, 1024, 3, 5),
                                                   (4, 1024, 1, 3), (4, 1024, 3, -1)])
def test_wgmma_plan_refuses_bad_tiles(heads, t, consumers, full):
    with pytest.raises(ValueError):
        A.wgmma_plan(heads, t, consumers, full)


def _simulated_waves(full_blocks, small_blocks, small_cost, sm_count):
    """Brute force: each block goes to the SM that is free first."""
    free = [0.0] * sm_count
    heapq.heapify(free)
    end = 0.0
    for cost in [1.0] * full_blocks + [small_cost] * small_blocks:
        done = heapq.heappop(free) + cost
        end = max(end, done)
        heapq.heappush(free, done)
    return end


def test_waves_equal_a_simulated_card():
    rng = np.random.default_rng(0)
    for _ in range(300):
        sm = int(rng.integers(1, 140))
        full, small = int(rng.integers(0, 6 * sm)), int(rng.integers(0, 6 * sm))
        cost = float(rng.choice([0.5, 0.56, 0.77, 0.9]))
        assert A._waves(full, small, cost, sm) == pytest.approx(_simulated_waves(full, small, cost, sm)), (
            full, small, cost, sm)


@pytest.mark.parametrize("sm_count", [132, 114, 78])
@pytest.mark.parametrize("heads,t", [(32, 4096), (12, 4096), (4, 1024), (16, 1024), (160, 384), (1, 128), (7, 640)])
def test_wgmma_split_is_the_best_of_all_splits(heads, t, sm_count):
    waves, full = A._wgmma_split(heads, t, sm_count)
    per_full, per_small = -(-t // 192), t // 128
    every = [_simulated_waves(f * per_full, (heads - f) * per_small, A.WGMMA_COST_Q128, sm_count)
             for f in range(heads + 1)]
    assert waves == pytest.approx(min(every)) == pytest.approx(every[full])
    plan = A.launch_plan((1, heads, t, 64), torch.bfloat16, sm_count)
    _blocks_cover(plan, heads, t)
    assert plan.shared_bytes <= 232_448


def test_wgmma_split_leaves_large_grids_whole():
    """Beyond WGMMA_PLANNED_WAVES waves the last one no longer matters:
    every head takes 192-query blocks."""
    heads = 256  # [64, 4, 4096, 64]: 5,632 blocks, 42.7 waves
    waves, full = A._wgmma_split(heads, 4096, 132)
    assert full == heads and waves == pytest.approx(heads * 22 / 132) and waves > A.WGMMA_PLANNED_WAVES
    plan = A.launch_plan((64, 4, 4096, 64), torch.bfloat16, 132)
    assert (plan.variant, plan.full_heads, plan.grid) == ("wgmma_q192", heads, (22, heads))


def test_wgmma_split_of_the_main_shape():
    """[8, 4, 4096, 64] on 132 SMs: 24 heads of 192-query blocks are four
    full waves, the other 8 heads take 128-query blocks."""
    waves, full = A._wgmma_split(32, 4096, 132)
    assert full == 24 and waves == pytest.approx(4 + 2 * A.WGMMA_COST_Q128)
    assert waves < math.ceil(32 * 22 / 132)  # all heads on 192-query blocks: six rounds


# ------------------------------------------- the kernel's schedule, in plain PyTorch


def _scheduled_attention(q, k, v, tile=A.WGMMA_TILE_KEYS):
    """What the wgmma kernel does to [N, H, T, D] bf16 q/k/v, step by step:
    f32 logits of one 128-key tile, the running max of the raw logits, base-2
    exponentials of (logit - max) * scale * log2 e, row sums over the unrounded
    f32 probabilities, probabilities rounded to bf16 before P V, the f32
    accumulator rescaled when the max moves, one late divide."""
    scale_log2 = (1.0 / math.sqrt(q.shape[-1])) * 1.4426950408889634
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:-1], -math.inf)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape, dtype=torch.float32)
    for j in range(0, k.shape[2], tile):
        s = qf @ kf[:, :, j:j + tile].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * scale_log2)  # 0 on the first tile
        p = torch.exp2(s * scale_log2 - (m_new * scale_log2)[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vf[:, :, j:j + tile]
        m = m_new
    return (acc / l[..., None]).to(q.dtype)


@pytest.mark.parametrize("scales", [(1.0, 1.0), (4.0, 0.125)], ids=["randn", "peaked"])
@pytest.mark.parametrize("shape", [(2, 4, 256, 64), (1, 2, 512, 64), (1, 1, 1024, 64)])
@pytest.mark.parametrize("against", ["plain", "pallas"])
def test_kernel_schedule_meets_the_bf16_bar(shape, scales, against):
    q, k, v = _randn(shape, "cpu", torch.bfloat16, *scales)
    got = _scheduled_attention(q, k, v)
    if against == "plain":
        ref = A.attention_reference(q, k, v).float()
    else:
        jq, jk, jv = (jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (q, k, v))
        ref = torch.from_numpy(np.array(jflash(jq, jk, jv).astype(jnp.float32)))
    assert float((got.float() - ref).abs().max()) <= A.bf16_parity_bar(ref)


def test_kernel_schedule_rejects_a_dropped_tile():
    """The emulation is no weaker a check than the plain version: leaving a
    128-key tile out of it breaks the bar by a wide margin."""
    q, k, v = _randn((1, 1, 1024, 64), "cpu", torch.bfloat16, 4.0, 0.125)
    ref = A.attention_reference(q, k, v).float()
    keep = torch.ones(1024, dtype=torch.bool)
    keep[384:512] = False
    bad = _scheduled_attention(q, k[:, :, keep].contiguous(), v[:, :, keep].contiguous())
    assert float((bad.float() - ref).abs().max()) > 4 * A.bf16_parity_bar(ref)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,dtype,scales",
    [
        ((1, 4, 1024, 64), torch.bfloat16, (1.0, 1.0)),
        ((1, 4, 1024, 64), torch.bfloat16, (4.0, 0.125)),
        ((2, 2, 1024, 32), torch.bfloat16, (1.0, 1.0)),
        ((1, 4, 256, 64), torch.float32, (1.0, 1.0)),
        ((8, 4, 4096, 64), torch.bfloat16, (1.0, 1.0)),
        ((8, 4, 4096, 64), torch.bfloat16, (4.0, 0.125)),
        ((3, 4, 4096, 64), torch.bfloat16, (1.0, 1.0)),
        ((3, 4, 4096, 64), torch.bfloat16, (4.0, 0.125)),
        ((2, 2, 1024, 32), torch.bfloat16, (4.0, 0.125)),
        ((1, 4, 192, 64), torch.bfloat16, (1.0, 1.0)),
        ((2, 4, 128, 64), torch.bfloat16, (4.0, 0.125)),  # one key tile: a ring of one stage
        ((36, 4, 256, 64), torch.bfloat16, (1.0, 1.0)),  # 192-query blocks that end past T = 256
        ((1, 2, 8192, 64), torch.bfloat16, (1.0, 1.0)),
        ((1, 4, 1024, 64), torch.float32, (1.0, 1.0)),
        ((1, 4, 1024, 64), torch.float32, (4.0, 0.125)),
        ((3, 2, 256, 32), torch.float32, (1.0, 1.0)),
    ],
)
def test_cuda_kernel_matches_plain_version(cuda_device, shape, dtype, scales):
    q, k, v = _randn(shape, cuda_device, dtype, *scales)
    launches = A.flash_kernel.launches
    out = A.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert A.flash_kernel.launches == launches + 1
    ref = A.attention_reference(q, k, v)
    tol = A.bf16_parity_bar(ref) if dtype == torch.bfloat16 else 1e-4
    assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("scales", [(1.0, 1.0), (4.0, 0.125)], ids=["randn", "peaked"])
@pytest.mark.parametrize("consumers,full_heads", [(1, 20), (3, 20), (3, 7), (3, 0)])
def test_cuda_kernel_at_every_tile_choice(cuda_device, consumers, full_heads, scales):
    """Each tile the plan can give the wgmma kernel, forced at a T that 192
    does not divide: one warpgroup on 64 queries, three on 192, and the mix
    of 192- and 128-query blocks."""
    n, h, t, d = shape = (5, 4, 640, 64)
    q, k, v = _randn(shape, cuda_device, torch.bfloat16, *scales)
    plan = A.wgmma_plan(n * h, t, consumers, full_heads)
    by_variant = dict(A.flash_kernel.launches_by_variant)
    out = A.flash_kernel(q, k, v, plan=plan)
    torch.cuda.synchronize()
    assert A.flash_kernel.launches_by_variant[plan.variant] == by_variant[plan.variant] + 1
    ref = A.attention_reference(q, k, v)
    assert float((out.float() - ref.float()).abs().max()) <= A.bf16_parity_bar(ref)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_a_plan_of_another_shape(cuda_device):
    q, k, v = _randn((1, 4, 1024, 64), cuda_device, torch.bfloat16)
    launches = A.flash_kernel.launches
    with pytest.raises(ValueError):
        A.flash_kernel(q, k, v, plan=A.wgmma_plan(4, 512, 3, 4))
    with pytest.raises(ValueError):
        A.flash_kernel(q, k, v, plan=A.launch_plan((2, 2, 1024, 32), torch.bfloat16))
    assert A.flash_kernel.launches == launches
