"""PyTorch port: each layer of models/nn.py against the JAX layer, f32.

Same numpy-seeded inputs and parameters on both sides; the JAX side runs at
``precision=HIGHEST`` (its default f32 dot is not full f32). Bar: atol 1e-5
(f32 round-off of differently ordered sums)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu.models import nn as jnn
from image_restoration_platform_tpu_torch.models import nn as tnn
from image_restoration_platform_tpu_torch.models.weights import params_from_jax

torch.set_num_threads(2)
ATOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got: torch.Tensor, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=atol)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _hwio_to_oihw(w):
    return _t(w.transpose(3, 2, 0, 1))


def test_dense():
    rng = _rng(0)
    x, w, b = _f32(rng, 2, 5, 16), _f32(rng, 16, 24), _f32(rng, 24)
    with jax.default_matmul_precision("highest"):
        ref = jnn.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    _close(tnn.dense(_t(x), _t(w), _t(b)), ref)


@pytest.mark.parametrize(
    "size,kernel,stride",
    [(16, 3, 1), (16, 3, 2), (15, 3, 2), (16, 1, 1), (12, 3, 1)],
)
def test_conv2d_same_padding(size, kernel, stride):
    """Stride-2 SAME on even sizes pads (0, 1), as XLA does."""
    rng = _rng(size + kernel + stride)
    x, w, b = _f32(rng, 2, size, size, 8), _f32(rng, kernel, kernel, 8, 12, scale=0.2), _f32(rng, 12)
    with jax.default_matmul_precision("highest"):
        ref = jnn.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), stride=stride)
    got = tnn.conv2d(_t(x), _hwio_to_oihw(w), _t(b), stride=stride)
    assert tuple(got.shape) == tuple(ref.shape)
    _close(got, ref)


def test_conv2d_cat_equals_conv_of_concat():
    rng = _rng(1)
    a, c = _f32(rng, 2, 8, 8, 8), _f32(rng, 2, 8, 8, 4)
    w, b = _f32(rng, 3, 3, 12, 6, scale=0.2), _f32(rng, 6)
    with jax.default_matmul_precision("highest"):
        ref = jnn.conv2d_cat({"w": jnp.asarray(w), "b": jnp.asarray(b)}, [jnp.asarray(a), jnp.asarray(c)])
    got = tnn.conv2d_cat([_t(a), _t(c)], _hwio_to_oihw(w), _t(b))
    _close(got, ref)
    _close(got, tnn.conv2d(torch.cat([_t(a), _t(c)], -1), _hwio_to_oihw(w), _t(b)))


@pytest.mark.parametrize("channels,groups", [(64, 32), (48, 32), (12, 8), (6, 32)])
def test_group_norm(channels, groups):
    rng = _rng(channels)
    x = _f32(rng, 2, 6, 5, channels) * 3.0 + 0.5
    scale, bias = _f32(rng, channels), _f32(rng, channels)
    assert tnn.gn_groups(channels, groups) == jnn._gn_groups(channels, groups)
    ref = jnn.group_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jnp.asarray(x), groups)
    _close(tnn.group_norm(_t(x), _t(scale), _t(bias), groups), ref)


def test_group_norm_cat():
    rng = _rng(2)
    a, c = _f32(rng, 2, 4, 4, 32) + 1.0, _f32(rng, 2, 4, 4, 16) * 2.0
    scale, bias = _f32(rng, 48), _f32(rng, 48)
    refs = jnn.group_norm_cat({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, [jnp.asarray(a), jnp.asarray(c)], 8)
    gots = tnn.group_norm_cat([_t(a), _t(c)], _t(scale), _t(bias), 8)
    for got, ref in zip(gots, refs):
        _close(got, ref)


def test_film():
    rng = _rng(3)
    x, cond = _f32(rng, 2, 4, 4, 8), _f32(rng, 2, 6)
    w, b = _f32(rng, 6, 16, scale=0.3), _f32(rng, 16)
    with jax.default_matmul_precision("highest"):
        ref = jnn.film({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), jnp.asarray(cond))
    _close(tnn.film(_t(x), _t(cond), _t(w), _t(b)), ref)


@pytest.mark.parametrize(
    "hw,ch,heads",
    [
        ((8, 8), 64, 4),  # t=64, hd=16: the flash-attention branch
        ((16, 16), 64, 2),  # t=256, hd=32: the flash-attention branch
        ((4, 6), 8, 2),  # hd=4: the plain branch
    ],
)
def test_attention_layer(hw, ch, heads):
    rng = _rng(ch + heads)
    x = _f32(rng, 2, hw[0], hw[1], ch)
    params = {
        "norm": {"scale": _f32(rng, ch), "bias": _f32(rng, ch)},
        "qkv": {"w": _f32(rng, ch, 3 * ch, scale=0.2), "b": _f32(rng, 3 * ch)},
        "proj": {"w": _f32(rng, ch, ch, scale=0.2), "b": _f32(rng, ch)},
    }
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    with jax.default_matmul_precision("highest"):
        ref = jnn.attention(jparams, jnp.asarray(x), heads)
    layer = tnn.Attention(ch)
    flat = {f"{a}/{b}": v for a, d in params.items() for b, v in d.items()}
    layer.load_state_dict(params_from_jax(flat), strict=True)
    _close(layer(_t(x), heads), ref, atol=2e-5)


@pytest.mark.parametrize("factor", [2, 4])
def test_pixel_shuffle_and_space_to_depth(factor):
    rng = _rng(factor)
    x = _f32(rng, 2, 8, 8, 3)
    s2d = tnn.space_to_depth(_t(x), factor)
    np.testing.assert_array_equal(s2d.numpy(), np.asarray(jnn.space_to_depth(jnp.asarray(x), factor)))
    np.testing.assert_array_equal(tnn.pixel_shuffle(s2d, factor).numpy(), x)
    y = _f32(rng, 2, 4, 4, 3 * factor * factor)
    np.testing.assert_array_equal(
        tnn.pixel_shuffle(_t(y), factor).numpy(), np.asarray(jnn.pixel_shuffle(jnp.asarray(y), factor))
    )


def test_upsample_nearest_and_silu():
    rng = _rng(5)
    x = _f32(rng, 2, 3, 4, 5)
    np.testing.assert_array_equal(
        tnn.upsample_nearest(_t(x), 2).numpy(), np.asarray(jnn.upsample_nearest(jnp.asarray(x), 2))
    )
    _close(tnn.silu(_t(x)), jnn.silu(jnp.asarray(x)), atol=1e-6)


def test_cast_for_compute_keeps_norms_f32():
    m = tnn.Attention(16)
    tnn.cast_for_compute(m, torch.bfloat16)
    assert m.qkv.w.dtype == torch.bfloat16 and m.proj.b.dtype == torch.bfloat16
    assert m.norm.scale.dtype == torch.float32 and m.norm.bias.dtype == torch.float32
