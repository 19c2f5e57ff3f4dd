"""PyTorch port: bottleneck flash attention against the JAX Pallas kernel.

On the CPU the port's ``flash_attention`` takes its plain version (the
CUDA kernel runs only on the card); the JAX side runs the Pallas kernel in
interpret mode. Bars: in bf16 ``bf16_parity_bar`` (0.02, the reference's
own from tests/test_pallas_attention.py, and at most 4 bf16 ulps of the
largest output), 1e-5 in f32, and rtol/atol 2e-2 for gradients. The kernel
itself is held against the plain version on the card by the ``cuda``-marked
tests below and by chip_smoke.py; what surrounds it is tested here: the
launch plan (variant, tiles, units, schedule, grid, shared memory) and a
plain emulation of the kernel's schedule, its key split over a cluster and
the combine included."""

import heapq
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

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


def _jax():
    """jax, jax.numpy and the reference's Pallas kernel, imported by the
    tests that use them: the ``cuda`` tests also run where there is no JAX
    (``pytest -m cuda --noconftest`` on the card)."""
    import jax
    import jax.numpy as jnp

    from image_restoration_platform_tpu.ops.pallas.attention import flash_attention

    return jax, jnp, flash_attention


def _inputs(shape, seed, np_dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np_dtype) for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 4, 256, 64), (1, 2, 512, 64), (2, 4, 16, 8)])
def test_bf16_matches_jax_kernel(shape):
    jax, jnp, jflash = _jax()
    q, k, v = _inputs(shape, 0)
    ref = jflash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    got = A.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    assert float((got.float() - ref).abs().max()) <= A.bf16_parity_bar(ref)


def test_f32_matches_jax_kernel():
    jax, jnp, jflash = _jax()
    q, k, v = _inputs((1, 2, 256, 32), 1)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jflash(*(jnp.asarray(a) for a in (q, k, v))))
    got = A.flash_attention(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_gradients_match_jax():
    jax, jnp, jflash = _jax()
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
    """The plan's units cover every head's query rows (192-query units may
    reach past T, 128- and 64-query units divide it), and its grid walks
    them: one cluster of ``splits`` blocks a unit, or fewer clusters each
    walking several."""
    small = plan.block_q - A.WGMMA_WARPGROUP_ROWS
    per_full = -(-t // plan.block_q)
    assert per_full * plan.block_q >= t > (per_full - 1) * plan.block_q
    per_small = 0
    if plan.full_heads < heads:
        per_small = t // small
        assert per_small * small == t
    assert plan.units == plan.full_heads * per_full + (heads - plan.full_heads) * per_small
    assert plan.grid == (plan.clusters * plan.splits, 1) and 1 <= plan.clusters <= plan.units


@pytest.mark.parametrize("shape,dtype", SMOKE_SHAPES + [((3, 4, 4096, 64), "bfloat16")],
                         ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else x)
def test_launch_plan_of_the_paths_shapes(shape, dtype):
    n, h, t, d = shape
    plan = A.launch_plan(shape, getattr(torch, dtype), sm_count=132)
    # the model's choice, which at every row is the plan the card ran fastest
    # (chip_smoke.py --plan-sweep; PERF.md section 6)
    expected = {
        # restore-unet 256 b1: 64 units of 64 queries, the keys split over
        # clusters of 2 blocks (128 blocks for 132 SMs)
        ((1, 4, 1024, 64), "bfloat16"): ("wgmma_q64", 64, 128, 4, 256, 4, "split", 2),
        # 512: 24 heads of 192-query units and 8 of 128-query units, a block a unit
        ((8, 4, 4096, 64), "bfloat16"): ("wgmma_q192", 192, 128, 4, 512, 24, "grid", 1),
        ((3, 4, 4096, 64), "bfloat16"): ("wgmma_q192", 192, 128, 4, 512, 12, "grid", 1),
        # D = 32 takes the wgmma kernel
        ((2, 2, 1024, 32), "bfloat16"): ("wgmma_q64", 64, 128, 4, 256, 4, "split", 2),
        ((1, 4, 192, 64), "bfloat16"): ("mma_sync", 64, 64, 1, 128, 4, "grid", 1),
        ((1, 4, 1024, 64), "float32"): ("simt_f32", 32, 64, 2, 128, 4, "grid", 1),
        # training: 256 units of 128 queries on a persistent grid (two 128-key
        # stages); 768 units of 192 queries on a persistent grid
        ((32, 4, 256, 64), "bfloat16"): ("wgmma_q192", 192, 128, 2, 512, 0, "persistent", 1),
        ((32, 4, 1024, 64), "bfloat16"): ("wgmma_q192", 192, 128, 4, 512, 128, "persistent", 1),
        # the mesh paths' shards: 8 and 4 heads of 4096 keys all on 128-query
        # units (their last wave ends sooner than with 192-query units), 16
        # heads with 12 on 192-query units; the f32 train check's slot
        ((2, 4, 4096, 64), "bfloat16"): ("wgmma_q192", 192, 128, 4, 512, 0, "grid", 1),
        ((1, 4, 4096, 64), "bfloat16"): ("wgmma_q192", 192, 128, 4, 512, 0, "grid", 1),
        ((4, 4, 4096, 64), "bfloat16"): ("wgmma_q192", 192, 128, 4, 512, 12, "grid", 1),
        ((4, 4, 256, 64), "float32"): ("simt_f32", 32, 64, 2, 128, 16, "grid", 1),
        # the quality gates at 128 px: 32 heads of 256 keys on 64-query units
        # (128 blocks, two 128-key stages); 32 heads of 1024 keys on 128-query
        # units, persistent
        ((8, 4, 256, 64), "bfloat16"): ("wgmma_q64", 64, 128, 2, 256, 32, "grid", 1),
        ((8, 4, 1024, 64), "bfloat16"): ("wgmma_q192", 192, 128, 4, 512, 0, "persistent", 1),
        # training restore-unet-small 128 b32: 64 heads of 4096 keys at D = 32,
        # 192-query units on a persistent grid
        ((32, 2, 4096, 32), "bfloat16"): ("wgmma_q192", 192, 128, 4, 512, 64, "persistent", 1),
        # restore-unet 256 b2 / b4 serving
        ((2, 4, 1024, 64), "bfloat16"): ("wgmma_q64", 64, 128, 4, 256, 8, "grid", 1),
        ((4, 4, 1024, 64), "bfloat16"): ("wgmma_q192", 192, 128, 4, 512, 0, "grid", 1),
    }[(shape, dtype)]
    assert (plan.variant, plan.block_q, plan.block_k, plan.stages, plan.threads, plan.full_heads, plan.schedule,
            plan.splits) == expected
    assert plan.variant in A.VARIANTS and 0 <= plan.shared_bytes <= 232_448
    if plan.variant.startswith("wgmma"):
        consumers = plan.block_q // 64
        assert plan.threads == (consumers + 1) * 128
        # 1 KB to align, 8 KB of Q a warpgroup, 16 KB each of K and V a stage
        q_buffers = 2 if plan.schedule == "persistent" else 1
        # 1 KB to align, 128 D bytes of Q a warpgroup (two buffers when
        # persistent), 256 D bytes each of K and V a stage, and a split's partials
        assert plan.shared_bytes == (1024 + q_buffers * consumers * 128 * d + plan.stages * 2 * 256 * d
                                     + (plan.splits - 1) * consumers * 128 * (d // 2 + 4) * 4)
        assert t % (plan.block_k * plan.splits) == 0 and 1 <= plan.stages <= t // plan.block_k // plan.splits
        _blocks_cover(plan, n * h, t)
    else:
        assert plan.grid == (t // plan.block_q, n * h) and plan.full_heads == n * h
    if plan.variant == "simt_f32":
        assert plan.shared_bytes == 4 * ((32 + 4 * 64) * (d + 4) + 32 * (64 + 4))


def test_every_variant_has_a_smoke_shape():
    seen = {A.launch_plan(shape, getattr(torch, dtype)).variant for shape, dtype in SMOKE_SHAPES}
    assert seen == set(A.VARIANTS) == set(SMOKE.ATTENTION_VARIANTS)
    forced = [A.wgmma_plan(n * h, t, consumers, full, d=d, splits=splits, clusters=clusters)
              for (n, h, t, d), consumers, full, splits, clusters in SMOKE.FORCED_PLANS]
    assert {(p.block_q, p.full_heads) for p in forced[:4]} == {(64, 20), (192, 20), (192, 7), (192, 0)}
    assert {p.schedule for p in forced} == {"grid", "persistent", "split"}
    assert {p.splits for p in forced} == set(A.WGMMA_SPLITS)
    assert {shape[3] for shape, *_ in SMOKE.FORCED_PLANS} == set(A.KERNEL_HEAD_DIMS)
    for plan, ((n, h, t, d), *_) in zip(forced, SMOKE.FORCED_PLANS):
        _blocks_cover(plan, n * h, t)
    # the last 192-query unit of a head reaches past T
    assert any(p.block_q == 192 and p.full_heads and t % 192 for p, ((_, _, t, _), *_) in zip(forced, SMOKE.FORCED_PLANS))


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


def _grid_mixes(heads, t, sm_count):
    """The three-warpgroup, one-block-a-unit candidates at D = 64, by the
    heads that take 192-query units, in the order they are weighed."""
    return {p.full_heads: p for p in A.wgmma_candidates(heads, t, 64, sm_count)
            if p.block_q == 192 and p.schedule == "grid"}


def _unit_us(warpgroups, t):
    fixed, per_tile = A.UNIT_COST_US[(warpgroups, 64)]
    return fixed + per_tile * (t // A.WGMMA_TILE_KEYS)


@pytest.mark.parametrize("sm_count", [132, 114, 78])
@pytest.mark.parametrize("heads,t", [(32, 4096), (12, 4096), (4, 1024), (16, 1024), (160, 384), (1, 128), (7, 640)])
def test_wgmma_split_is_the_best_of_all_splits(heads, t, sm_count):
    """Every mix of 192- and 128-query units is weighed, from all heads on
    192 down to none (ties go to more full heads), each priced as a
    simulated card hands its blocks out; the chosen plan ends no later than
    the best of them."""
    mixes = _grid_mixes(heads, t, sm_count)
    assert list(mixes) == list(range(heads, -1, -1))
    per_full, per_small = -(-t // 192), t // 128
    full_us, small_us = _unit_us(3, t), _unit_us(2, t)
    every = {f: full_us * _simulated_waves(f * per_full, (heads - f) * per_small, small_us / full_us, sm_count)
             for f in mixes}
    for f, plan in mixes.items():
        assert A.plan_us(plan, t, 64, sm_count) == pytest.approx(every[f])
    plan = A.launch_plan((1, heads, t, 64), torch.bfloat16, sm_count)
    assert A.plan_us(plan, t, 64, sm_count) <= min(every.values()) * (1 + 1e-12)
    _blocks_cover(plan, heads, t)
    assert plan.shared_bytes <= 232_448


def test_wgmma_split_leaves_large_grids_whole():
    """Beyond WGMMA_PLANNED_WAVES waves the last one no longer matters:
    every head takes 192-query blocks, one a unit."""
    heads = 256  # [64, 4, 4096, 64]: 5,632 blocks, 42.7 waves
    assert heads * 22 / 132 > A.WGMMA_PLANNED_WAVES
    assert list(_grid_mixes(heads, 4096, 132)) == [heads]
    plan = A.launch_plan((64, 4, 4096, 64), torch.bfloat16, 132)
    assert (plan.variant, plan.full_heads) == ("wgmma_q192", heads)
    assert plan.schedule == "grid" and plan.grid == (22 * heads, 1)


def test_wgmma_split_of_the_main_shape():
    """[8, 4, 4096, 64] on 132 SMs: 24 heads of 192-query blocks are four
    full waves, the other 8 heads take 128-query blocks."""
    mixes = _grid_mixes(32, 4096, 132)
    best = min(mixes.values(), key=lambda p: A.plan_us(p, 4096, 64, 132))
    full_us, small_us = _unit_us(3, 4096), _unit_us(2, 4096)
    assert best.full_heads == 24
    assert A.plan_us(best, 4096, 64, 132) == pytest.approx(4 * full_us + 2 * small_us)
    # all heads on 192-query blocks: six rounds
    assert A.plan_us(best, 4096, 64, 132) < math.ceil(32 * 22 / 132) * full_us
    assert A.launch_plan((8, 4, 4096, 64), torch.bfloat16, 132) == best


# ------------------------------------------- the kernel's schedule, in plain PyTorch


def _online_softmax(q, k, v, keys, tile=A.WGMMA_TILE_KEYS):
    """What the wgmma kernel does to [N, H, T, D] bf16 q/k/v over the keys
    in ``keys``, step by step: f32 logits of one 128-key tile, the running
    max of the raw logits, base-2 exponentials of (logit - max) * scale *
    log2 e, row sums over the unrounded f32 probabilities, probabilities
    rounded to bf16 before P V, the f32 accumulator rescaled when the max
    moves. Returns the running max, the row sums and the unnormalised O."""
    scale_log2 = (1.0 / math.sqrt(q.shape[-1])) * 1.4426950408889634
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:-1], -math.inf)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape, dtype=torch.float32)
    for j in range(keys.start, keys.stop, tile):
        s = qf @ kf[:, :, j:j + tile].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * scale_log2)  # 0 on the first tile
        p = torch.exp2(s * scale_log2 - (m_new * scale_log2)[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vf[:, :, j:j + tile]
        m = m_new
    return m, l, acc


def _scheduled_attention(q, k, v):
    """The kernel's schedule over all keys, then one late divide."""
    _, l, acc = _online_softmax(q, k, v, range(k.shape[2]))
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
        ref = _pallas(q, k, v)
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


def _split_attention(q, k, v, splits, dropped=None):
    """What a cluster of ``splits`` blocks of the wgmma kernel does: block r
    runs ``_online_softmax`` over the r-th share of the keys with its own
    running max; block 0 takes the common max, rescales its own partial to
    it, adds the others' in split order, each rescaled by
    2^((m_r - m) * scale * log2 e), and divides once. ``dropped`` leaves one
    split's partial out of the combine (a mutation the bar must catch)."""
    scale_log2 = (1.0 / math.sqrt(q.shape[-1])) * 1.4426950408889634
    share = k.shape[2] // splits
    parts = [_online_softmax(q, k, v, range(r * share, (r + 1) * share)) for r in range(splits)]
    if dropped is not None:
        del parts[dropped]
    m_all = torch.stack([m for m, _, _ in parts]).amax(0)
    (m0, l, acc), rest = parts[0], parts[1:]
    w = torch.exp2((m0 - m_all) * scale_log2)
    l, acc = l * w, acc * w[..., None]
    for m_r, l_r, acc_r in rest:
        w = torch.exp2((m_r - m_all) * scale_log2)
        l = l + l_r * w
        acc = acc + acc_r * w[..., None]
    return (acc / l[..., None]).to(q.dtype)


def _pallas(q, k, v):
    """The reference's Pallas kernel (interpret mode on the CPU) on torch
    q/k/v, as f32."""
    _, jnp, jflash = _jax()
    jq, jk, jv = (jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (q, k, v))
    return torch.from_numpy(np.array(jflash(jq, jk, jv).astype(jnp.float32)))


@pytest.mark.parametrize("scales", [(1.0, 1.0), (4.0, 0.125)], ids=["randn", "peaked"])
@pytest.mark.parametrize("shape", [(1, 2, 512, 64), (1, 2, 512, 32), (2, 2, 1024, 32)])
@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("against", ["plain", "pallas"])
def test_key_split_schedule_meets_the_bf16_bar(shape, splits, scales, against):
    """The kernel's key split and cluster combine, emulated in its order,
    against the JAX Pallas kernel (interpret mode) and the plain version."""
    q, k, v = _randn(shape, "cpu", torch.bfloat16, *scales)
    got = _split_attention(q, k, v, splits)
    ref = A.attention_reference(q, k, v).float() if against == "plain" else _pallas(q, k, v)
    assert float((got.float() - ref).abs().max()) <= A.bf16_parity_bar(ref)


@pytest.mark.parametrize("d", [64, 32])
@pytest.mark.parametrize("splits,dropped", [(2, 1), (4, 2), (4, 3)])
def test_key_split_schedule_rejects_a_dropped_split(d, splits, dropped):
    """A combine that leaves one split's partial out breaks the bar by a
    wide margin, as a dropped tile does."""
    q, k, v = _randn((1, 2, 1024, d), "cpu", torch.bfloat16, 4.0, 0.125)
    ref = A.attention_reference(q, k, v).float()
    assert float((_split_attention(q, k, v, splits).float() - ref).abs().max()) <= A.bf16_parity_bar(ref)
    bad = _split_attention(q, k, v, splits, dropped=dropped)
    assert float((bad.float() - ref).abs().max()) > 4 * A.bf16_parity_bar(ref)


# ------------------------------------------------ the new plans, at every row


@pytest.mark.parametrize("shape,dtype", SMOKE_SHAPES, ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else x)
@pytest.mark.parametrize("sm_count", [132, 114, 78])
def test_plans_stay_inside_their_limits(shape, dtype, sm_count):
    """At every launched shape and SM count: the chosen plan is one of the
    candidates and the model's best; a persistent grid has at most one block
    an SM on alike units and no split; splits only where the units are fewer
    than the SMs, with a whole number of key tiles each."""
    n, h, t, d = shape
    plan = A.launch_plan(shape, getattr(torch, dtype), sm_count)
    if not plan.variant.startswith("wgmma"):
        assert plan.splits == 1 and plan.schedule == "grid"
        return
    candidates = A.wgmma_candidates(n * h, t, d, sm_count)
    assert plan in candidates
    assert A.plan_us(plan, t, d, sm_count) == min(A.plan_us(p, t, d, sm_count) for p in candidates)
    for p in candidates:
        _blocks_cover(p, n * h, t)
        assert p.shared_bytes <= A.MAX_SHARED_BYTES
        if p.schedule == "persistent":
            assert p.clusters == sm_count < p.units and p.full_heads in (0, n * h)
        if p.splits > 1:
            assert p.units < sm_count and (t // A.WGMMA_TILE_KEYS) % p.splits == 0
            assert p.clusters == p.units


@pytest.mark.parametrize("kwargs", [
    dict(heads=4, t=640, consumers=1, full_heads=4, splits=2),  # 5 key tiles do not split 2 ways
    dict(heads=4, t=1024, consumers=1, full_heads=4, splits=3),
    dict(heads=4, t=1024, consumers=1, full_heads=4, splits=8),
    dict(heads=4, t=1024, consumers=3, full_heads=4, splits=4),  # partials outgrow shared memory at D = 64
    dict(heads=4, t=1024, consumers=3, full_heads=2, clusters=10),  # persistent on mixed units
    dict(heads=4, t=1024, consumers=1, full_heads=4, splits=2, clusters=32),  # persistent and split
    dict(heads=4, t=1024, consumers=1, full_heads=4, clusters=65),  # more clusters than units
    dict(heads=4, t=1024, consumers=1, full_heads=4, clusters=0),
    dict(heads=4, t=1024, consumers=1, full_heads=4, d=48),
])
def test_wgmma_plan_refuses_what_the_kernel_does_not_take(kwargs):
    kwargs = dict(kwargs)
    heads, t, consumers, full = (kwargs.pop(k) for k in ("heads", "t", "consumers", "full_heads"))
    with pytest.raises(ValueError):
        A.wgmma_plan(heads, t, consumers, full, **kwargs)


def test_d32_takes_the_wgmma_kernel():
    """D = 32 at T a multiple of 128 no longer runs the mma.sync kernel;
    it stays for T a multiple of 64 only."""
    assert A.launch_plan((32, 2, 4096, 32), torch.bfloat16).variant.startswith("wgmma")
    assert A.launch_plan((2, 2, 1024, 32), torch.bfloat16).variant.startswith("wgmma")
    assert A.launch_plan((1, 2, 192, 32), torch.bfloat16).variant == "mma_sync"
    assert A.launch_plan((1, 4, 192, 64), torch.bfloat16).variant == "mma_sync"


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
        ((32, 2, 4096, 32), torch.bfloat16, (4.0, 0.125)),  # training restore-unet-small: wgmma at D = 32
        ((2, 4, 1024, 64), torch.bfloat16, (4.0, 0.125)),
        ((4, 4, 1024, 64), torch.bfloat16, (4.0, 0.125)),
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


@pytest.mark.cuda
@pytest.mark.parametrize("forced", SMOKE.FORCED_PLANS,
                         ids=lambda f: "x".join(map(str, f[0])) + f"-c{f[1]}-f{f[2]}-s{f[3]}-g{f[4]}")
def test_cuda_kernel_at_every_forced_plan(cuda_device, forced):
    """Every plan chip_smoke.py forces (grids, persistent grids, key splits;
    D = 64 and 32), on peaked inputs."""
    (n, h, t, d), consumers, full_heads, splits, clusters = forced
    q, k, v = _randn((n, h, t, d), cuda_device, torch.bfloat16, 4.0, 0.125)
    plan = A.wgmma_plan(n * h, t, consumers, full_heads, d=d, splits=splits, clusters=clusters)
    launches = A.flash_kernel.launches
    out = A.flash_kernel(q, k, v, plan=plan)
    torch.cuda.synchronize()
    assert A.flash_kernel.launches == launches + 1
    ref = A.attention_reference(q, k, v)
    assert float((out.float() - ref.float()).abs().max()) <= A.bf16_parity_bar(ref)


@pytest.mark.cuda
def test_cuda_key_split_gives_the_same_bits_every_run(cuda_device):
    """No float atomics: a key split combines in a fixed order."""
    q, k, v = _randn((1, 4, 1024, 64), cuda_device, torch.bfloat16, 4.0, 0.125)
    plan = A.wgmma_plan(4, 1024, 1, 4, splits=4)
    first = A.flash_kernel(q, k, v, plan=plan)
    for _ in range(5):
        assert torch.equal(A.flash_kernel(q, k, v, plan=plan), first)

