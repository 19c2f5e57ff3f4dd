"""PyTorch port: RestorationUNet against the JAX ``unet.apply``, f32.

restore-unet-small at 64 px from ``unet.init`` weights (perturbed with
seeded noise, so the zero-initialised FiLM and head carry signal), and the
flagship restore-unet with the shipped weights at the 256 bucket in s2d_io
layout. The JAX side runs at ``precision=HIGHEST``. Bar: atol 1e-4 on
outputs of order 1 (f32 round-off through ~40 layers; measured ~1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu.models import nn as jnn
from image_restoration_platform_tpu.models import registry as jreg
from image_restoration_platform_tpu.models import unet as junet
from image_restoration_platform_tpu.models import weights as jweights
from image_restoration_platform_tpu_torch.models import get_family
from image_restoration_platform_tpu_torch.models import nn as tnn
from image_restoration_platform_tpu_torch.models import weights as W

torch.set_num_threads(2)
ATOL = 1e-4


def _perturbed(family: str, seed: int):
    """(jax params, port state dict) of one perturbed init."""
    params = junet.init(jax.random.PRNGKey(seed), jreg.get_family(family).config)
    rng = np.random.default_rng(seed)
    flat = {
        k: (v + rng.normal(0, 0.03, v.shape)).astype(np.float32)
        for k, v in W.flatten_params(params).items()
    }
    for key, value in flat.items():
        jweights._set_path(params, key, jnp.asarray(value))
    return params, W.params_from_jax(flat)


def _port(family: str, state) -> torch.nn.Module:
    model = get_family(family).build()
    model.load_state_dict(state, strict=True)
    return model.eval()


def _run_port(model, x, cond, s2d_io=False):
    with torch.inference_mode():
        return model(torch.tensor(x), torch.tensor(cond), s2d_io=s2d_io).numpy()


def test_small_family_from_init():
    params, state = _perturbed("restore-unet-small", 0)
    cfg = jreg.get_family("restore-unet-small").config
    rng = np.random.default_rng(1)
    x = rng.random((2, 64, 64, 3)).astype(np.float32)
    cond = rng.random((2, 28)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(junet.apply(params, jnp.asarray(x), jnp.asarray(cond), config=cfg))
    got = _run_port(_port("restore-unet-small", state), x, cond)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("s2d_io", [False, True])
def test_flagship_from_init_both_layouts(s2d_io):
    params, state = _perturbed("restore-unet", 2)
    cfg = jreg.get_family("restore-unet").config
    rng = np.random.default_rng(3)
    x = rng.random((1, 64, 64, 3)).astype(np.float32)
    cond = rng.random((1, 28)).astype(np.float32)
    xin = np.asarray(jnn.space_to_depth(jnp.asarray(x), 2)) if s2d_io else x
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(junet.apply(params, jnp.asarray(xin), jnp.asarray(cond), config=cfg, s2d_io=s2d_io))
    got = _run_port(_port("restore-unet", state), xin, cond, s2d_io=s2d_io)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_flagship_shipped_weights_256_s2d_io():
    """The served configuration: 256 bucket, s2d_io, attention over T=1024."""
    cfg = jreg.get_family("restore-unet").config
    path = W.weights_path("restore-unet")
    params = jweights.load_params(junet.init(jax.random.PRNGKey(0), cfg), path)
    rng = np.random.default_rng(4)
    x = rng.random((1, 256, 256, 3)).astype(np.float32)
    cond = np.zeros((1, 28), np.float32)
    cond[0, [0, 3]] = [0.8, 0.6]
    xin = np.asarray(jnn.space_to_depth(jnp.asarray(x), 2))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(junet.apply(params, jnp.asarray(xin), jnp.asarray(cond), config=cfg, s2d_io=True))
    got = _run_port(_port("restore-unet", W.load_state_dict(path)), xin, cond, s2d_io=True)
    assert got.shape == (1, 128, 128, 12)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_s2d_io_requires_input_scale():
    model = get_family("restore-unet-small").build()
    with pytest.raises(ValueError):
        model(torch.zeros(1, 8, 8, 12), torch.zeros(1, 28), s2d_io=True)


def test_attention_skipped_above_max_tokens(monkeypatch):
    """Bottleneck attention is static-skipped above max_attn_tokens (the
    1024 bucket), as in the reference."""
    from image_restoration_platform_tpu_torch.models.unet import RestorationUNet, UNetConfig

    cfg = UNetConfig(base_channels=16, channel_mults=(1, 2), blocks_per_level=1, attn_heads=2,
                     norm_groups=8, max_attn_tokens=16)
    model = RestorationUNet(cfg).init_(torch.Generator().manual_seed(0))
    calls = []
    monkeypatch.setattr(tnn.Attention, "forward", lambda self, x, heads: calls.append(x.shape) or x)
    model(torch.rand(1, 8, 8, 3), torch.zeros(1, 28))  # bottleneck 4x4 = 16 tokens
    model(torch.rand(1, 16, 16, 3), torch.zeros(1, 28))  # 8x8 = 64 tokens: skipped
    assert len(calls) == 1
