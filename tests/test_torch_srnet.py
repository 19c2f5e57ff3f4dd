"""PyTorch port: SRNet and its residual limiter against the JAX ``srnet``.

The limiter's parts (``upsample_tent``, ``local_detail``, ``_lowpass``,
``residual_limit``) are held at atol 1e-5 on values of order 1 (f32 sums of
a few taps in another order), the whole network with both shipped SR
checkpoints at atol 1e-4 on a 64x64 input, limiter on and off (f32 round-off
through 19 convolutions; measured 1e-6). The JAX side runs at
``precision=HIGHEST``: its ``local_detail`` takes the luma through a matrix
product, which is bf16-like by default even on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu.models import registry as jreg
from image_restoration_platform_tpu.models import srnet as jsr
from image_restoration_platform_tpu.models import weights as jweights
from image_restoration_platform_tpu_torch.models import get_family
from image_restoration_platform_tpu_torch.models import srnet as S
from image_restoration_platform_tpu_torch.models import weights as W

torch.set_num_threads(2)
PART_ATOL = 1e-5
NET_ATOL = 1e-4


def _rand(shape, seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("scale", [2, 4, 3])
def test_upsample_tent(scale):
    x = _rand((2, 9, 7, 3), 0)
    ref = np.asarray(jsr.upsample_tent(jnp.asarray(x), scale))
    got = S.upsample_tent(torch.from_numpy(x), scale)
    assert tuple(got.shape) == (2, 9 * scale, 7 * scale, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=PART_ATOL)


@pytest.mark.parametrize("kappa", [0.0, 0.7])
def test_local_detail(kappa):
    x = _rand((2, 20, 17, 3), 1)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jsr.local_detail(jnp.asarray(x), kappa))
    got = S.local_detail(torch.from_numpy(x), kappa)
    assert tuple(got.shape) == (2, 20, 17, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=PART_ATOL)


@pytest.mark.parametrize("hw,pool", [((64, 64), 32), ((70, 45), 32), ((24, 40), 8)])
def test_lowpass_pyramid(hw, pool):
    """Sizes that are no multiple of the pool take the one-sided edge pad."""
    r = _rand((1, *hw, 3), 2, -0.2, 0.2)
    ref = np.asarray(jsr._lowpass(jnp.asarray(r), pool))
    got = S._lowpass(torch.from_numpy(r), pool)
    assert tuple(got.shape) == r.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=PART_ATOL)


def test_lowpass_pyramid_equals_one_wide_tent():
    """The pyramid of log2(pool) x2 upsamples is the same filter as a single
    ``upsample_tent(lo, pool)`` (box_2(z^2) * box_2(z) = box_4(z), cubed), at
    a fraction of the full-resolution taps; only f32 round-off separates them."""
    r = torch.from_numpy(_rand((1, 128, 128, 3), 3, -0.2, 0.2))
    lo = r.reshape(1, 4, 32, 4, 32, 3).mean(dim=(2, 4))
    np.testing.assert_allclose(S._lowpass(r, 32).numpy(), S.upsample_tent(lo, 32).numpy(), rtol=0, atol=1e-6)


def test_lowpass_refuses_a_pool_that_is_no_power_of_two():
    with pytest.raises(ValueError):
        S._lowpass(torch.zeros(1, 24, 24, 3), 12)


@pytest.mark.parametrize("scale,hw", [(2, (32, 32)), (4, (16, 24)), (2, (40, 28))])
def test_residual_limit(scale, hw):
    x = _rand((2, *hw, 3), 4)
    out = _rand((2, hw[0] * scale, hw[1] * scale, 3), 5)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jsr.residual_limit(jnp.asarray(x), jnp.asarray(out), jsr.SRNetConfig(scale=scale)))
    got = S.residual_limit(torch.from_numpy(x), torch.from_numpy(out), S.SRNetConfig(scale=scale))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=PART_ATOL)


def test_residual_limit_is_f32_whatever_comes_in():
    """bf16 in, f32 out: the bounded residual is never re-quantized."""
    x = torch.from_numpy(_rand((1, 32, 32, 3), 6)).to(torch.bfloat16)
    out = torch.from_numpy(_rand((1, 64, 64, 3), 7)).to(torch.bfloat16)
    cfg = S.SRNetConfig()
    assert S.residual_limit(x, out, cfg).dtype == torch.float32
    off = dataclasses.replace(cfg, limit_pool=0)
    assert S.residual_limit(x, out, off) is out


def test_limiter_clips_hallucinated_texture_on_flat_input():
    """The reference's unit gate (tests/test_sr_gate.py): ~10 levels of noise
    added onto a flat input leave at most the ~1-level floor."""
    cfg = S.SRNetConfig(num_blocks=2)
    hall = 0.04 * np.random.default_rng(4).standard_normal((1, 64, 64, 3)).astype(np.float32)
    hall -= hall.mean()
    out = S.residual_limit(torch.full((1, 32, 32, 3), 0.5), torch.from_numpy(0.5 + hall), cfg)
    assert float((out - 0.5).abs().max()) * 255.0 <= cfg.limit_floor + 0.6


def test_config_and_halo_equal_reference():
    assert dataclasses.asdict(S.SRNetConfig()) == dataclasses.asdict(jsr.SRNetConfig())
    for blocks in (2, 8):
        assert S.receptive_halo(S.SRNetConfig(num_blocks=blocks)) == jsr.receptive_halo(
            jsr.SRNetConfig(num_blocks=blocks))
    for family in ("sr-x2", "sr-x4"):
        assert dataclasses.asdict(get_family(family).config) == dataclasses.asdict(jreg.get_family(family).config)


@pytest.mark.parametrize("limiter", [True, False], ids=["limiter-on", "limiter-off"])
@pytest.mark.parametrize("family", ["sr-x2", "sr-x4"])
def test_srnet_shipped_weights_match_jax(family, limiter):
    jcfg = jreg.get_family(family).config
    cfg = get_family(family).config
    if not limiter:
        jcfg, cfg = dataclasses.replace(jcfg, limit_pool=0), dataclasses.replace(cfg, limit_pool=0)
    path = W.weights_path(family)
    params = jweights.load_params(jsr.init(jax.random.PRNGKey(0), jcfg), path)
    x = _rand((1, 64, 64, 3), 8)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jsr.apply(params, jnp.asarray(x), jcfg))
    model = S.SRNet(cfg)
    model.load_state_dict(W.load_state_dict(path), strict=True)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x))
    assert tuple(got.shape) == (1, 64 * cfg.scale, 64 * cfg.scale, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=NET_ATOL)
    # the shipped network is not the nearest upsample: the comparison has signal
    nearest = np.repeat(np.repeat(x, cfg.scale, axis=1), cfg.scale, axis=2)
    assert np.abs(ref - nearest).max() > 0.01


def test_zero_init_is_nearest_upsample():
    cfg = S.SRNetConfig(num_blocks=2, limit_pool=0)
    model = S.SRNet(cfg).init_(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_rand((1, 16, 16, 3), 9))
    with torch.inference_mode():
        out = model(x)
    assert torch.equal(out, x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))
    assert float(model.stem.w.detach().abs().sum()) > 0
