"""PyTorch port: weight files and parameter layouts.

Every key of the shipped npz files loads into the port's modules with no
missing or extra key, and parameters made by the JAX package's ``init``
functions map onto the same modules (HWIO conv kernels become OIHW, dense
kernels stay [in, out])."""

import jax
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu.models import registry as jreg
from image_restoration_platform_tpu_torch.models import ParamCache, get_family
from image_restoration_platform_tpu_torch.models import weights as W

torch.set_num_threads(2)

FAMILIES = ["restore-unet", "restore-unet-small", "sr-x2", "sr-x4", "diffusion-restore"]


@pytest.mark.parametrize("family", FAMILIES)
def test_shipped_npz_loads_with_no_missing_or_extra_key(family):
    flat = W.load_npz(W.weights_path(family))
    state = W.params_from_jax(flat)
    model = get_family(family).build()
    assert set(state) == set(model.state_dict())
    result = model.load_state_dict(state, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert all(v.dtype == torch.float32 for v in state.values())


@pytest.mark.parametrize("family", FAMILIES)
def test_jax_init_tree_maps_onto_modules(family):
    jfamily = jreg.get_family(family)
    params = jfamily.init(jax.random.PRNGKey(0), jfamily.config)
    flat = W.flatten_params(params)
    state = W.params_from_jax(flat)
    get_family(family).build().load_state_dict(state, strict=True)
    # conv: HWIO -> OIHW; dense: [in, out] unchanged
    np.testing.assert_array_equal(state["stem.w"].numpy(), flat["stem/w"].transpose(3, 2, 0, 1))
    if family.startswith("sr-"):
        assert state["up.w"].shape == (3 * int(family[-1]) ** 2, 64, 3, 3)
        np.testing.assert_array_equal(state["blocks.7.conv2.b"].numpy(), flat["blocks/7/conv2/b"])
    else:
        np.testing.assert_array_equal(state["cond_mlp1.w"].numpy(), flat["cond_mlp1/w"])


def test_shipped_flagship_size():
    state = W.load_state_dict(W.weights_path("restore-unet"))
    assert len(state) == 174
    assert sum(v.numel() for v in state.values()) == pytest.approx(11.85e6, rel=0.01)


def test_param_cache_reads_weights_dir(tmp_path, monkeypatch):
    flat = W.load_npz(W.weights_path("restore-unet-small"))
    np.savez(tmp_path / "restore-unet-small.npz", **flat)
    monkeypatch.setenv("IRP_WEIGHTS_DIR", str(tmp_path))
    state = ParamCache(0).get("restore-unet-small")
    np.testing.assert_array_equal(state["head.b"].numpy(), flat["head/b"].astype(np.float32))


def test_param_cache_without_weights_is_seeded_random(tmp_path, monkeypatch):
    monkeypatch.setenv("IRP_WEIGHTS_DIR", str(tmp_path))
    a = ParamCache(3).get("restore-unet-small")
    b = ParamCache(3).get("restore-unet-small")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["stem.w"].abs().sum()) > 0
    assert float(a["head.w"].abs().sum()) == 0  # zero head: identity restoration


@pytest.mark.parametrize("family", ["sr-x2", "sr-x4", "diffusion-restore"])
def test_unported_families_refuse(family):
    """No shipped family is refused any more: each builds and is cached with
    its shipped weights; only an unknown name raises."""
    state = ParamCache(0).get(family)
    assert set(state) == set(get_family(family).build().state_dict())
    assert float(state["stem.w"].abs().sum()) > 0
    with pytest.raises(KeyError):
        get_family(family + "-unknown")
