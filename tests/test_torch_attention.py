"""PyTorch port: bottleneck flash attention against the JAX Pallas kernel.

On the CPU the port's ``flash_attention`` takes its plain version (the
CUDA kernel runs only on the card); the JAX side runs the Pallas kernel in
interpret mode. Bars: in bf16 ``bf16_parity_bar`` (0.02, the reference's
own from tests/test_pallas_attention.py, and at most 4 bf16 ulps of the
largest output), 1e-5 in f32, and rtol/atol 2e-2 for gradients. The kernel
itself is held against the plain version on the card by the ``cuda``-marked
test below and by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu.ops.pallas.attention import flash_attention as jflash
from image_restoration_platform_tpu_torch.ops.cuda import attention as A

torch.set_num_threads(2)


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
@pytest.mark.parametrize("fault", ["tile_dropped", "tile_left_out_of_pv"])
def test_bf16_bar_rejects_a_skipped_key_tile(shape, scales, fault):
    """The bar the kernel is held to on the card is sharp enough to catch a
    kernel that skips one 64-key tile, at the path's own T."""
    q, k, v = _randn(shape, "cpu", torch.bfloat16, *scales)
    ref = A.attention_reference(q, k, v)
    tile = slice(3 * A.KERNEL_BLOCK, 4 * A.KERNEL_BLOCK)
    if fault == "tile_dropped":  # the tile is missing from the softmax
        keep = torch.ones(shape[2], dtype=torch.bool)
        keep[tile] = False
        bad = A.attention_reference(q, k[:, :, keep].contiguous(), v[:, :, keep].contiguous())
    else:  # the tile counts in the row sum but not in P V
        v_bad = v.clone()
        v_bad[:, :, tile] = 0
        bad = A.attention_reference(q, k, v_bad)
    assert float((bad.float() - ref.float()).abs().max()) > 4 * A.bf16_parity_bar(ref)


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
