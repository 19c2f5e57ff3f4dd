"""PyTorch port: the diffusion family against the JAX ``models/diffusion.py``.

The schedule (``alpha_bar``, ``add_noise``) and ``sinusoidal_embedding`` at
atol 1e-6; the time-conditioned UNet with the shipped diffusion-restore
weights and the 2-step DDIM ``restore`` at atol 1e-4 on a 64x64 input (f32
round-off through two UNet forwards; measured 1e-6); the whole diffusion
program with u8 outputs within 1 level. No random generator crosses the
frameworks: the noise is drawn with the JAX key the reference gets, and the
same array is handed to the port. The JAX side runs at ``precision=HIGHEST``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu.models import ParamCache as JParamCache
from image_restoration_platform_tpu.models import diffusion as jdiff
from image_restoration_platform_tpu.models import nn as jnn
from image_restoration_platform_tpu.models import unet as junet
from image_restoration_platform_tpu.serve.programs import build_restore_program as jbuild
from image_restoration_platform_tpu_torch import imageio
from image_restoration_platform_tpu_torch.config import ServingConfig
from image_restoration_platform_tpu_torch.models import diffusion as D
from image_restoration_platform_tpu_torch.models import get_family
from image_restoration_platform_tpu_torch.models import nn as tnn
from image_restoration_platform_tpu_torch.models import weights as W
from image_restoration_platform_tpu_torch.ops.cuda.attention import flash_kernel
from image_restoration_platform_tpu_torch.serve import RestorationEngine, RestoratorService
from image_restoration_platform_tpu_torch.serve.programs import build_restore_program

torch.set_num_threads(2)
FAMILY = "diffusion-restore"


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def test_alpha_bar_matches_jax():
    t = np.concatenate([np.linspace(0, 1, 33), [0.5, 0.999, 1.0]]).astype(np.float32)
    ref = np.asarray(jdiff.alpha_bar(jnp.asarray(t)))
    np.testing.assert_allclose(D.alpha_bar(torch.from_numpy(t)).numpy(), ref, rtol=0, atol=1e-6)
    # the host-side scalars the sampler uses are the same schedule
    host = np.asarray([D._alpha_bar_host(float(v)) for v in t], np.float32)
    np.testing.assert_allclose(host, ref, rtol=0, atol=1e-6)
    assert ref[0] == 1.0 and ref[-1] == np.float32(1e-5)


@pytest.mark.parametrize("t_shape", [(), (3,)], ids=["scalar-t", "per-image-t"])
def test_add_noise_matches_jax(t_shape):
    x0, noise = _rand((3, 8, 8, 3), 0) * 2 - 1, np.random.default_rng(1).normal(size=(3, 8, 8, 3)).astype(np.float32)
    t = np.asarray(0.37, np.float32) if t_shape == () else np.asarray([0.1, 0.5, 0.9], np.float32)
    ref = np.asarray(jdiff.add_noise(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)))
    got = D.add_noise(torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dim", [256, 7])
def test_sinusoidal_embedding_matches_jax(dim):
    t = np.asarray([0.0, 1.0, 2.5, 10.0], np.float32)
    ref = np.asarray(jnn.sinusoidal_embedding(jnp.asarray(t), dim))
    got = tnn.sinusoidal_embedding(torch.from_numpy(t), dim)
    assert tuple(got.shape) == (4, dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_sinusoidal_embedding_at_sampler_timesteps():
    """At t = 500 and 1000 one f32 unit in the last place of a frequency
    moves the angle by up to 6e-5, so the bar is 1e-4 there."""
    t = np.asarray([500.0, 1000.0], np.float32)
    ref = np.asarray(jnn.sinusoidal_embedding(jnp.asarray(t), 256))
    np.testing.assert_allclose(tnn.sinusoidal_embedding(torch.from_numpy(t), 256).numpy(), ref, rtol=0, atol=1e-4)


def test_config_equals_reference():
    assert dataclasses.asdict(D.DiffusionConfig()) == dataclasses.asdict(jdiff.DiffusionConfig())
    assert dataclasses.asdict(get_family(FAMILY).config) == dataclasses.asdict(jdiff.DiffusionConfig())


@pytest.fixture(scope="module")
def models():
    """(jax params, port model) with the shipped diffusion-restore weights."""
    params = JParamCache(0).get(FAMILY)
    model = get_family(FAMILY).build()
    model.load_state_dict(W.load_state_dict(W.weights_path(FAMILY)), strict=True)
    assert model.cond_mlp1.w.shape == (28 + 256, 256)
    return params, model.eval()


@pytest.mark.parametrize("t", [None, [500.0, 1000.0]], ids=["t-none-is-zeros", "t-given"])
def test_time_conditioned_unet_matches_jax(models, t):
    params, model = models
    cfg = jdiff.DiffusionConfig().unet
    x = _rand((2, 64, 64, 6), 2) * 2 - 1
    cond = _rand((2, 28), 3)
    jt = None if t is None else jnp.asarray(t, jnp.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(junet.apply(params, jnp.asarray(x), jnp.asarray(cond), t=jt, config=cfg))
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(cond), t=None if t is None else torch.tensor(t))
    assert tuple(got.shape) == (2, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("config", [D.DiffusionConfig(), D.DiffusionConfig(sample_steps=3, strength=0.6),
                                    D.DiffusionConfig(parameterization="eps", strength=0.5)],
                         ids=["served-2-step", "sdedit-3-step", "eps-prediction"])
def test_restore_with_injected_noise_matches_jax(models, config):
    params, model = models
    jconfig = jdiff.DiffusionConfig(sample_steps=config.sample_steps, strength=config.strength,
                                    parameterization=config.parameterization)
    x, cond = _rand((1, 64, 64, 3), 4), _rand((1, 28), 5)
    key = jax.random.PRNGKey(11)
    noise = np.array(jax.random.normal(key, x.shape, dtype=jnp.float32))  # what restore draws from this key
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jdiff.restore(params, jnp.asarray(x), jnp.asarray(cond), key, jconfig))
    launches = flash_kernel.launches
    with torch.inference_mode():
        got = D.restore(model, torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(noise), config)
    assert flash_kernel.launches == launches  # CPU tensors take the plain attention
    assert got.dtype == torch.float32 and float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


def test_restore_draws_from_a_generator(models):
    _, model = models
    x, cond = torch.from_numpy(_rand((1, 32, 32, 3), 6)), torch.zeros((1, 28))
    with torch.inference_mode():
        a = D.restore(model, x, cond, torch.Generator().manual_seed(5))
        b = D.restore(model, x, cond, torch.Generator().manual_seed(5))
        noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(5))
        c = D.restore(model, x, cond, noise)
    assert torch.equal(a, b) and torch.equal(a, c)


def test_bf16_carry_keeps_its_type(models):
    """The carry is cast back to the compute type after every step, whose
    arithmetic runs in f32; the embedding meets bf16 only at the concat."""
    _, model = models
    bf16 = get_family(FAMILY).build()
    bf16.load_state_dict(model.state_dict())
    bf16 = tnn.cast_for_compute(bf16, torch.bfloat16).eval()
    x = torch.from_numpy(_rand((1, 32, 32, 3), 7))
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        out = D.restore(bf16, x.to(torch.bfloat16), torch.zeros((1, 28), dtype=torch.bfloat16), noise)
        ref = D.restore(model, x, torch.zeros((1, 28)), noise)
    assert out.dtype == torch.bfloat16
    assert float((out.float() - ref).abs().mean()) < 0.02


def test_diffusion_program_matches_jax():
    """Classify -> gated stages -> 2-step sampler -> u8, at the 64 bucket."""
    rng = np.random.default_rng(8)
    canvas = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    canvas[1] = (canvas[1] // 4 + 96).astype(np.uint8)
    valid = np.asarray([[64, 64], [48, 40]], np.int32)
    is_jpeg = np.asarray([1.0, 0.0], np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, canvas.shape, dtype=jnp.float32))
    fn = jbuild(FAMILY, dtype=jnp.float32, use_folded=False, use_s2d_io=False, use_deblur=True, use_deblock=True)
    with jax.default_matmul_precision("highest"):
        ref_out, ref_scores = fn(JParamCache(0).get(FAMILY), jnp.asarray(canvas), jnp.asarray(valid),
                                 jnp.asarray(is_jpeg), key)
    engine = RestorationEngine(device="cpu", serving_config=ServingConfig(size_buckets=(64,), max_batch=2))
    program = build_restore_program(FAMILY, dtype=torch.float32, use_s2d_io=False, use_deblur=True, use_deblock=True)
    out, scores = program(engine.model(FAMILY, folded=False), torch.from_numpy(canvas), torch.from_numpy(valid),
                          torch.from_numpy(is_jpeg), torch.from_numpy(noise))
    assert out.dtype == torch.uint8 and tuple(out.shape) == (2, 64, 64, 3)
    assert np.abs(out.numpy().astype(np.int32) - np.asarray(ref_out).astype(np.int32)).max() <= 1
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), rtol=0, atol=1e-4)


def test_engine_forces_rgb_and_seeds_its_noise():
    cfg = ServingConfig(size_buckets=(64,), max_batch=2)
    canvas = np.random.default_rng(9).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    outs = []
    for seed in (0, 0, 1):
        engine = RestorationEngine(device="cpu", serving_config=cfg, seed=seed)
        out, scores, meta = engine.restore_batch(canvas, family_name=FAMILY, egress="yuv420")
        assert isinstance(out, np.ndarray) and out.shape == (1, 64, 64, 3) and scores.shape == (1, 7)
        assert meta["family"] == FAMILY
        outs.append(out)
    assert np.array_equal(outs[0], outs[1]) and not np.array_equal(outs[0], outs[2])
    again, _, _ = engine.restore_batch(canvas, family_name=FAMILY)
    assert not np.array_equal(again, outs[2])  # the generator advances between batches


def test_restorator_serves_diffusion_with_rgb_egress(monkeypatch):
    cfg = ServingConfig(size_buckets=(64,), max_batch=2)
    svc = RestoratorService(engine=RestorationEngine(device="cpu", serving_config=cfg), serving_config=cfg,
                            device="cpu")
    seen = []
    restore_batch = svc.engine.restore_batch
    monkeypatch.setattr(svc.engine, "restore_batch", lambda *a: seen.append(a[4]) or restore_batch(*a))
    img = np.random.default_rng(10).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    result = svc.restore(imageio.encode_png(img), options={"model": FAMILY})
    assert result["success"] is True, result.get("error")
    assert seen == ["rgb"] and result["metadata"]["model"] == FAMILY
    assert len(result["degradationAnalysis"]) == 7
