"""PyTorch port: the Swin layer's MLP in one kernel (ops/cuda/swin_mlp.py).
On the CPU its plain version against the chain it replaces in
models/swinir.py (``linear(fc2, F.gelu(linear(fc1, x)))``), bit for bit in
f32; the packed weights read back through the 128-byte swizzle's address
map into the padded products the kernel runs; the wrapper's and the load
check's refusals; the launch counter of graph replays; and, under the
``cuda`` marker, the kernel against its plain version at SwinIR-M's chunk
and at a ragged token count, in a CUDA graph, and its launches on the tiled
path.

Bar on the card (``swin_mlp.parity_bar``, per element): the kernel and its
plain version both round the hidden value to bf16 once, from f32 sums taken
in another order, so a hidden value may land one bf16 ulp apart (at most
2^-7 of its size), and m one ulp of its own; the chain it replaces also
rounds fc1's output before GELU (at most 2^-8 of it, through GELU's slope,
below 1.13)."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_restoration_platform_tpu_torch.models import ModelFamily, SwinIRConfig, register, registry
from image_restoration_platform_tpu_torch.models import nn as L
from image_restoration_platform_tpu_torch.models.swinir import Mlp, linear
from image_restoration_platform_tpu_torch.ops.cuda import swin_mlp as SM
from image_restoration_platform_tpu_torch.serve import RestorationEngine

torch.set_num_threads(2)

# SwinIR-M's served chunk: 8 tiles of 256 x 256 tokens of 180 channels, MLP 360
CHUNK_ROWS, C, HIDDEN = 8 * 256 * 256, 180, 360


def _weights(c, hidden, seed, device="cpu", dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    w1 = 0.08 * torch.randn((c, hidden), generator=gen)
    b1 = 0.1 * torch.randn(hidden, generator=gen)
    w2 = 0.06 * torch.randn((hidden, c), generator=gen)
    b2 = 0.1 * torch.randn(c, generator=gen)
    return [t.to(device=device, dtype=dtype) for t in (w1, b1, w2, b2)]


def _tokens(rows, c, seed, device="cpu", dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((rows, c), generator=gen).to(device=device, dtype=dtype)


def _mlp_module(c, hidden, seed):
    mlp = Mlp(c, hidden)
    w1, b1, w2, b2 = _weights(c, hidden, seed)
    with torch.no_grad():
        for t, v in ((mlp.fc1.w, w1), (mlp.fc1.b, b1), (mlp.fc2.w, w2), (mlp.fc2.b, b2)):
            t.copy_(v)
    return mlp


@pytest.mark.parametrize("rows", [1, 37, 128, 300, 1000], ids=lambda r: f"M{r}")
@pytest.mark.parametrize("widths", [(24, 48), (180, 360)], ids=["24-48", "180-360"])
def test_plain_version_equals_the_chain_it_replaces_in_f32(widths, rows):
    """Row counts below, at and past a 128-token unit, ragged ones too."""
    c, hidden = widths
    mlp = _mlp_module(c, hidden, 3)
    x = _tokens(rows, c, 4)
    want = linear(mlp.fc2, F.gelu(linear(mlp.fc1, x)))
    assert torch.equal(SM.swin_mlp_reference(x, mlp.fc1.w, mlp.fc1.b, mlp.fc2.w, mlp.fc2.b), want)
    assert torch.equal(mlp(x), want)
    grid = x.reshape(1, 1, rows, c)  # the layer's [B, H, W, C] tokens
    assert torch.equal(mlp(grid), want.reshape(grid.shape))


def test_plain_version_rounds_the_hidden_value_once_in_bf16():
    """Against float64 products of the same bf16 values with the hidden
    value rounded once, within ``parity_bar``; and not the chain's two
    roundings of it."""
    w1, b1, w2, b2 = _weights(C, HIDDEN, 5, dtype=torch.bfloat16)
    x = _tokens(200, C, 6, dtype=torch.bfloat16)
    h = F.gelu(x.double() @ w1.double() + b1.double()).float().to(torch.bfloat16)
    want = (h.double() @ w2.double() + b2.double()).float()
    got = SM.swin_mlp_reference(x, w1, b1, w2, b2)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert bool(((got.float() - want).abs() <= SM.parity_bar(x, w1, b1, w2, b2)).all())
    chain = F.linear(F.gelu(F.linear(x, w1.t(), b1)), w2.t(), b2)
    assert not torch.equal(got, chain)
    assert bool(((got.float() - chain.float()).abs() <= SM.parity_bar(x, w1, b1, w2, b2, chain=True)).all())


def _read_swizzled(region: torch.Tensor, rows: int) -> torch.Tensor:
    """[rows, 64] values of a region that the hardware reads through the
    128-byte swizzle: logical byte a lies at a ^ (((a >> 7) & 7) << 4)."""
    r, k = torch.meshgrid(torch.arange(rows), torch.arange(64), indexing="ij")
    a = r * 128 + 2 * k
    return region[(a ^ (((a >> 7) & 7) << 4)) // 2]


def _kernel_emulated(x, wpack, bias, c):
    """The kernel's products in float64 over the packed layout: the tokens
    zero-padded to 192 channels, six slices of 64 hidden units, m padded to
    184 channels (the hidden value is not rounded here)."""
    xp = torch.zeros((x.shape[0], SM.KERNEL_DEPTH), dtype=torch.float64)
    xp[:, :c] = x.double()
    o = torch.zeros((x.shape[0], SM.KERNEL_MAX_CHANNELS), dtype=torch.float64)
    w1_bytes = SM.KERNEL_DEPTH * SM.KERNEL_SLICE
    for s in range(SM.KERNEL_SLICES):
        blocks = [_read_swizzled(wpack[s, b * 4096:(b + 1) * 4096], SM.KERNEL_SLICE) for b in range(3)]
        w1s = torch.cat(blocks, dim=1).double()  # [64 hidden, 192 channels]
        w2s = _read_swizzled(wpack[s, w1_bytes:], SM.KERNEL_MAX_CHANNELS).double()  # [184 channels, 64 hidden]
        hs = F.gelu(xp @ w1s.T + bias[s * 64:(s + 1) * 64].double())
        o += hs @ w2s.T
    return o[:, :c] + bias[SM.KERNEL_MAX_HIDDEN:SM.KERNEL_MAX_HIDDEN + c].double()


@pytest.mark.parametrize("widths", [(180, 360), (24, 48), (4, 384)], ids=["180-360", "24-48", "4-384"])
def test_packed_weights_read_through_the_swizzle_give_the_mlp(widths):
    c, hidden = widths
    w1, b1, w2, b2 = _weights(c, hidden, 7, dtype=torch.bfloat16)
    wpack, bias = SM.pack_weights(w1, b1, w2, b2)
    assert wpack.dtype == torch.bfloat16 and tuple(wpack.shape) == (6, 24064)
    assert bias.dtype == torch.float32 and tuple(bias.shape) == (568,)
    assert int((wpack != 0).sum()) == int((w1 != 0).sum() + (w2 != 0).sum())  # zeros everywhere else
    x = _tokens(50, c, 8, dtype=torch.bfloat16)
    want = F.gelu(x.double() @ w1.double() + b1.double()) @ w2.double() + b2.double()
    assert float((_kernel_emulated(x, wpack, bias, c) - want).abs().max()) < 1e-9


def test_packed_weights_are_laid_out_once_and_again_after_a_write():
    w1, b1, w2, b2 = _weights(24, 48, 9, dtype=torch.bfloat16)
    packed = SM.PackedWeights()
    first = packed.get(w1, b1, w2, b2)
    assert packed.get(w1, b1, w2, b2) is first
    with torch.no_grad():
        w2.mul_(2.0)
    second = packed.get(w1, b1, w2, b2)
    assert second is not first and torch.equal(second[0], SM.pack_weights(w1, b1, w2, b2)[0])
    assert packed.get(w1, b1.clone(), w2, b2) is not second  # a replaced tensor


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    wpack, bias = SM.pack_weights(*_weights(24, 48, 1, dtype=torch.bfloat16))
    x = torch.zeros(8, 24, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        SM.swin_mlp_kernel(x, wpack, bias)
    with pytest.raises(TypeError, match="bf16 tokens"):
        SM.swin_mlp_kernel(x.float(), wpack, bias)
    with pytest.raises(TypeError, match="f32 biases"):
        SM.swin_mlp_kernel(x, wpack, bias.double())
    with pytest.raises(ValueError, match="contiguous"):
        SM.swin_mlp_kernel(torch.zeros(24, 8, dtype=torch.bfloat16).t(), wpack, bias)
    with pytest.raises(ValueError, match=r"\[M, C\]"):
        SM.swin_mlp_kernel(torch.zeros(0, 24, dtype=torch.bfloat16), wpack, bias)
    with pytest.raises(ValueError, match="packed weights"):
        SM.swin_mlp_kernel(x, wpack[:5], bias)
    with pytest.raises(ValueError, match="multiple of 4 channels up to 184"):
        SM.swin_mlp_kernel(torch.zeros(8, 188, dtype=torch.bfloat16), wpack, bias)
    SM.check_shapes(180, 360)
    for c, hidden, match in ((182, 360, "multiple of 4 channels"), (188, 376, "up to 184"),
                             (180, 385, "hidden width of 1 to 384"), (180, 0, "hidden width")):
        with pytest.raises(ValueError, match=match):
            SM.check_shapes(c, hidden)
    with pytest.raises(ValueError, match="hidden width"):
        SM.pack_weights(*_weights(180, 400, 1))


def test_the_load_check_refuses_a_width_the_mlp_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(registry, "_FAMILIES", dict(registry._FAMILIES))
    registry.check_attention_shapes("swinir-m-x2", (256,), 8, torch.bfloat16)
    # 192 channels over 6 heads: the add-norm and the window attention take them, the MLP does not
    register(ModelFamily("swinir-w192", SwinIRConfig(embed_dim=192, depths=(2,), num_heads=(6,))))
    with pytest.raises(ValueError, match="swinir-w192.*MLP of 384.*MLP kernel.*up to 184"):
        registry.check_attention_shapes("swinir-w192", (256,), 8, torch.bfloat16)
    register(ModelFamily("swinir-ratio4", SwinIRConfig(mlp_ratio=4.0, depths=(2,), num_heads=(6,))))
    with pytest.raises(ValueError, match="swinir-ratio4.*MLP of 720.*hidden width of 1 to 384"):
        registry.check_attention_shapes("swinir-ratio4", (256,), 8, torch.bfloat16)


def test_graph_replays_publish_the_mlp_launches():
    """The kernel is one of the hand-written kernels a capture's launch
    delta carries: a replay adds them and publishes
    ``kernels.launches.swin_mlp``."""
    from image_restoration_platform_tpu_torch.obs.metrics import get_counters
    from image_restoration_platform_tpu_torch.serve.exec_cache import LaunchDelta

    kernel = SM.swin_mlp_kernel
    before = kernel.launches, dict(kernel.launches_by_variant)
    delta = LaunchDelta()
    kernel.launches += 36  # what a capture of one chunk's Swin layers counts
    kernel.launches_by_variant["bf16"] += 36
    delta.close()
    assert (kernel.launches, kernel.launches_by_variant) == before
    published = get_counters().snapshot().get("kernels.launches.swin_mlp", 0.0)
    delta.replay()
    assert get_counters().snapshot()["kernels.launches.swin_mlp"] - published == 36
    assert kernel.launches == before[0] + 36
    kernel.launches, kernel.launches_by_variant = before[0], dict(before[1])


def test_the_mlp_is_a_dense_pair_in_the_npz_layout():
    """fc1 and fc2 stay ``Dense`` layers ([in, out] kernels), so the family
    loads as before; the packed layout is no parameter or buffer."""
    mlp = Mlp(C, HIDDEN)
    assert isinstance(mlp.fc1, L.Dense) and tuple(mlp.fc1.w.shape) == (C, HIDDEN)
    assert sorted(mlp.state_dict()) == ["fc1.b", "fc1.w", "fc2.b", "fc2.w"]


# ------------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the MLP kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [CHUNK_ROWS, 1037], ids=["chunk", "ragged"])
def test_cuda_kernel_matches_plain_version(cuda_device, rows):
    """SwinIR-M's chunk [524288, 180] -> 360 -> 180 bf16 and a ragged 1,037
    tokens (eight units of 128 and 13 more), eagerly; against the plain
    version and the chain it replaces within ``parity_bar``."""
    w1, b1, w2, b2 = _weights(C, HIDDEN, 21, cuda_device, torch.bfloat16)
    x = _tokens(rows, C, 22, cuda_device, torch.bfloat16)
    packed = SM.PackedWeights()
    launches = SM.swin_mlp_kernel.launches
    got = SM.swin_mlp(x, w1, b1, w2, b2, packed)
    torch.cuda.synchronize()
    assert SM.swin_mlp_kernel.launches == launches + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    plain = SM.swin_mlp_reference(x, w1, b1, w2, b2)
    assert bool(((got.float() - plain.float()).abs() <= SM.parity_bar(x, w1, b1, w2, b2)).all())
    chain = F.linear(F.gelu(F.linear(x, w1.t(), b1)), w2.t(), b2)
    assert bool(((got.float() - chain.float()).abs() <= SM.parity_bar(x, w1, b1, w2, b2, chain=True)).all())
    assert float((got.float() - plain.float()).abs().max()) <= 0.05 * float(plain.float().abs().max())


@pytest.mark.cuda
def test_cuda_graph_and_eager_agree_bit_for_bit(cuda_device):
    """A capture at the chunk's shape, replayed on new tokens copied in,
    against an eager call on the same tokens."""
    w1, b1, w2, b2 = _weights(C, HIDDEN, 23, cuda_device, torch.bfloat16)
    x = _tokens(CHUNK_ROWS, C, 24, cuda_device, torch.bfloat16)
    packed = SM.PackedWeights()
    SM.swin_mlp(x, w1, b1, w2, b2, packed)  # the layout, before the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = SM.swin_mlp(x, w1, b1, w2, b2, packed)
    x.copy_(_tokens(CHUNK_ROWS, C, 25, cuda_device, torch.bfloat16))
    graph.replay()
    eager = SM.swin_mlp(x, w1, b1, w2, b2, packed)
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.cuda
def test_cuda_tiled_call_counts_its_mlp_launches(cuda_device):
    """One replay of swinir-m-x2's tiled 2048 call: one launch a Swin layer
    (36) and chunk of 8 tiles (11), 396, counted as the program counter
    ``kernels.launches.swin_mlp``."""
    from image_restoration_platform_tpu_torch.obs.metrics import get_counters

    engine = RestorationEngine(device="cuda")
    canvas = np.zeros((2048, 2048, 3), np.uint8)
    engine.sr_tiled(canvas, "swinir-m-x2")  # builds the graph
    before = get_counters().snapshot().get("kernels.launches.swin_mlp", 0.0)
    launches = SM.swin_mlp_kernel.launches
    out, _ = engine.sr_tiled(canvas, "swinir-m-x2")
    assert out.shape == (4096, 4096, 3)
    assert SM.swin_mlp_kernel.launches - launches == 396
    assert get_counters().snapshot()["kernels.launches.swin_mlp"] - before == 396
