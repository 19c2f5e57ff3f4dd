"""PyTorch port: the Swin layer's residual add and LayerNorm with window
addressing (ops/cuda/swin_add_norm.py). On the CPU its plain version against
the composition it replaces in models/swinir.py (add, F.layer_norm,
torch.roll, the window partition and reverse, taken from the benchmark's
reference, benchmark/reference/swinir.py), bit for bit; the wrapper's and
the load check's refusals; and, under the ``cuda`` marker, the kernel
against its plain version at SwinIR-M's served shape and its launches on the
tiled path.

Bar on the card: the sums bit for bit (both round the f32 sum of two bf16
values once); the LayerNorm output within one bf16 ulp of the plain one,
taken at no less than 2^-8 (the statistics' f32 round-off, Welford's update
against two passes, is ~1e-7 absolute and outgrows an ulp only below that)."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_restoration_platform_tpu_torch.models import ModelFamily, SwinIRConfig, register, registry
from image_restoration_platform_tpu_torch.ops.cuda import swin_add_norm as SAN
from image_restoration_platform_tpu_torch.serve import RestorationEngine

torch.set_num_threads(2)

EPS = 1e-5
WINDOW = 8
# SwinIR-M's served chunk: 8 tiles of 256 x 256 tokens of 180 channels
SERVED = (8, 256, 256, 180)


def _reference():
    from benchmark import spec

    return spec.load_reference("swinir")


def _inputs(shape, dtype, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen) + 0.3
    a = 0.5 * torch.randn(shape, generator=gen)
    weight = 1.0 + 0.1 * torch.randn(shape[-1], generator=gen)
    bias = 0.1 * torch.randn(shape[-1], generator=gen)
    return [t.to(device=device, dtype=dtype) for t in (x, a, weight, bias)]


def _composed_to_windows(x, a, weight, bias, shift):
    """models/swinir.py's chain before the qkv linear: x + a, norm1, roll,
    window partition."""
    s = x if a is None else x + a
    y = F.layer_norm(s, (s.shape[-1],), weight, bias, EPS)
    if shift:
        y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
    return s, _reference().window_partition(y, WINDOW)


def _composed_from_windows(x, p, weight, bias, shift):
    """The chain after the proj linear: window reverse, roll back, the
    residual add, norm2."""
    b, h, w, c = x.shape
    y = _reference().window_reverse(p, WINDOW, b, h, w)
    if shift:
        y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
    s = x + y
    return s, F.layer_norm(s, (c,), weight, bias, EPS)


@pytest.mark.parametrize("grid", [(2, 2), (3, 4)], ids=["2x2", "3x4"])
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("variant", ["to_windows", "to_windows_no_add", "from_windows"])
def test_plain_version_equals_the_composition_it_replaces(variant, dtype, shift, grid):
    shape = (2, grid[0] * WINDOW, grid[1] * WINDOW, 12)
    x, a, weight, bias = _inputs(shape, dtype, 7)
    if variant == "from_windows":
        p = _reference().window_partition(a, WINDOW)  # any window-layout operand
        got = SAN.add_norm_from_windows(x, p, weight, bias, EPS, shift, WINDOW)
        want = _composed_from_windows(x, p, weight, bias, shift)
    else:
        a = a if variant == "to_windows" else None
        got = SAN.add_norm_to_windows(x, a, weight, bias, EPS, shift, WINDOW)
        want = _composed_to_windows(x, a, weight, bias, shift)
        assert (got[0] is x) == (a is None)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("shift", [0, 2, 4, 6])
def test_window_tokens_is_roll_then_partition_and_its_inverse_undoes_it(shift):
    grid = (3, 5)
    h, w = grid[0] * WINDOW, grid[1] * WINDOW
    ids = torch.arange(h * w).reshape(1, h, w, 1)
    want = _reference().window_partition(torch.roll(ids, (-shift, -shift), (1, 2)), WINDOW).reshape(-1)
    rows = SAN.window_tokens(grid, WINDOW, shift)
    assert torch.equal(rows, want)
    assert torch.equal(rows[SAN.token_windows(grid, WINDOW, shift)], torch.arange(h * w))


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 8, 8, 12, dtype=torch.bfloat16)
    w = torch.ones(12, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        SAN.swin_add_norm_kernel("to_windows", x, None, w, w, EPS, 0)
    with pytest.raises(ValueError, match="window-layout operand"):
        SAN.swin_add_norm_kernel("from_windows", x, None, w, w, EPS, 0)
    with pytest.raises(ValueError, match="unknown"):
        SAN.swin_add_norm_kernel("rolled", x, None, w, w, EPS, 0)
    SAN.check_shapes(8, 180)
    with pytest.raises(ValueError, match="multiple of 4 channels"):
        SAN.check_shapes(8, 182)
    with pytest.raises(ValueError, match="multiple of 4 channels"):
        SAN.check_shapes(8, 260)
    with pytest.raises(ValueError, match="windows of 8"):
        SAN.check_shapes(7, 180)


def test_the_load_check_refuses_a_width_the_add_norm_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(registry, "_FAMILIES", dict(registry._FAMILIES))
    register(ModelFamily("swinir-w30", SwinIRConfig(embed_dim=30, depths=(2,), num_heads=(1,))))
    with pytest.raises(ValueError, match="swinir-w30.*add-norm kernel.*multiple of 4 channels"):
        registry.check_attention_shapes("swinir-w30", (256,), 8, torch.bfloat16)


def test_graph_replays_publish_the_add_norm_launches():
    """The kernel is one of the hand-written kernels a capture's launch
    delta carries: a replay adds them, by form, and publishes
    ``kernels.launches.swin_add_norm``."""
    from image_restoration_platform_tpu_torch.obs.metrics import get_counters
    from image_restoration_platform_tpu_torch.serve.exec_cache import LaunchDelta

    kernel = SAN.swin_add_norm_kernel
    before = kernel.launches, dict(kernel.launches_by_variant)
    delta = LaunchDelta()
    kernel.launches += 2  # what a capture of one Swin layer counts
    kernel.launches_by_variant["to_windows"] += 1
    kernel.launches_by_variant["from_windows"] += 1
    delta.close()
    assert (kernel.launches, kernel.launches_by_variant) == before
    published = get_counters().snapshot().get("kernels.launches.swin_add_norm", 0.0)
    delta.replay()
    assert get_counters().snapshot()["kernels.launches.swin_add_norm"] - published == 2
    assert kernel.launches == before[0] + 2
    assert kernel.launches_by_variant == {v: n + 1 for v, n in before[1].items()}
    kernel.launches, kernel.launches_by_variant = before[0], dict(before[1])


# ------------------------------------------------------------------- card


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The bf16 spacing at |v| (8 significant bits), at |v| >= 2^-8."""
    return torch.exp2(torch.floor(torch.log2(v.float().abs().clamp_min(2.0**-8))) - 7)


def _check(got, want):
    (gs, gy), (ws, wy) = got, want
    assert gs.shape == ws.shape and gy.shape == wy.shape and gy.dtype == torch.bfloat16
    assert torch.equal(gs, ws)
    assert bool(((gy.float() - wy.float()).abs() <= bf16_ulp(wy)).all())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the add-norm kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("variant", ["to_windows", "to_windows_no_add", "from_windows"])
def test_cuda_kernel_matches_plain_version(cuda_device, variant, shift):
    """SwinIR-M's chunk [8, 256, 256, 180] bf16, eagerly and inside a CUDA
    graph (new inputs copied in before the replay)."""
    x, a, weight, bias = _inputs(SERVED, torch.bfloat16, 11, cuda_device)
    if variant == "from_windows":
        a = a.reshape(-1, WINDOW * WINDOW, SERVED[-1])
    elif variant == "to_windows_no_add":
        a = None
    fn = SAN.add_norm_from_windows if variant == "from_windows" else SAN.add_norm_to_windows
    plain = SAN.add_norm_from_windows_reference if variant == "from_windows" else SAN.add_norm_to_windows_reference
    launches = SAN.swin_add_norm_kernel.launches
    eager = fn(x, a, weight, bias, EPS, shift, WINDOW)
    torch.cuda.synchronize()
    assert SAN.swin_add_norm_kernel.launches == launches + 1
    _check(eager, plain(x, a, weight, bias, EPS, shift, WINDOW))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn(x, a, weight, bias, EPS, shift, WINDOW)
    x2, a2, _, _ = _inputs(SERVED, torch.bfloat16, 12, cuda_device)
    x.copy_(x2)
    if a is not None:
        a.copy_(a2.reshape(a.shape))
    graph.replay()
    torch.cuda.synchronize()
    _check(captured, plain(x, a, weight, bias, EPS, shift, WINDOW))


@pytest.mark.cuda
def test_cuda_tiled_call_counts_its_add_norm_launches(cuda_device):
    """One replay of swinir-m-x2's tiled 2048 call: two launches a Swin layer
    (36) and chunk of 8 tiles (11), 792, counted as the program counter
    ``kernels.launches.swin_add_norm``, half of each form."""
    from image_restoration_platform_tpu_torch.obs.metrics import get_counters

    engine = RestorationEngine(device="cuda")
    canvas = np.zeros((2048, 2048, 3), np.uint8)
    engine.sr_tiled(canvas, "swinir-m-x2")  # builds the graph
    before = get_counters().snapshot().get("kernels.launches.swin_add_norm", 0.0)
    launches = SAN.swin_add_norm_kernel.launches
    by_variant = dict(SAN.swin_add_norm_kernel.launches_by_variant)
    out, _ = engine.sr_tiled(canvas, "swinir-m-x2")
    assert out.shape == (4096, 4096, 3)
    assert SAN.swin_add_norm_kernel.launches - launches == 792
    assert get_counters().snapshot()["kernels.launches.swin_add_norm"] - before == 792
    assert {v: n - by_variant[v] for v, n in SAN.swin_add_norm_kernel.launches_by_variant.items()} == \
        {"to_windows": 396, "from_windows": 396}
