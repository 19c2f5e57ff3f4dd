"""PyTorch port: the model registry's public API (``register``,
``ModelFamily``, ``ParamCache.put``), as the reference's tests use it.

Counterpart of tests/test_diffusion_serving.py, which registers a narrow
diffusion family at run time and serves it through the engine: here the
same on ``device="cpu"``, with the family's weights handed to the engine's
``ParamCache`` by ``put`` (the shipped npz is for the full-width model). A
restore and an SR family under new names are served the same way. Every
test restores the registry it found."""

import numpy as np
import pytest
import torch

from image_restoration_platform_tpu_torch import imageio, models
from image_restoration_platform_tpu_torch.config import ServingConfig
from image_restoration_platform_tpu_torch.models import (
    DiffusionConfig,
    ModelFamily,
    ParamCache,
    SRNetConfig,
    UNetConfig,
    get_family,
    list_families,
    register,
    registry,
)
from image_restoration_platform_tpu_torch.eval.common import serving_forward
from image_restoration_platform_tpu_torch.models.folded import folded_model
from image_restoration_platform_tpu_torch.serve import RestorationEngine, RestoratorService
from image_restoration_platform_tpu_torch.serve.engine import uses_folded, uses_s2d_io
from image_restoration_platform_tpu_torch.serve.programs import build_restore_program

torch.set_num_threads(2)

NARROW = dict(base_channels=32, channel_mults=(1, 2), blocks_per_level=1, attn_heads=2)


@pytest.fixture
def scratch_registry(monkeypatch):
    """The registry as it stands, restored after the test."""
    monkeypatch.setattr(registry, "_FAMILIES", dict(registry._FAMILIES))


def _put_random(cache: ParamCache, name: str, seed: int) -> dict:
    state = get_family(name).build().init_(torch.Generator().manual_seed(seed)).state_dict()
    cache.put(name, state)
    return state


@pytest.fixture
def diffusion_engine(scratch_registry):
    cfg = DiffusionConfig(sample_steps=2, strength=0.3, unet=UNetConfig(in_channels=6, time_conditioned=True, **NARROW))
    register(ModelFamily("diffusion-restore", cfg))
    engine = RestorationEngine(device="cpu", serving_config=ServingConfig(size_buckets=(32,), max_batch=2))
    _put_random(engine.params_cache, "diffusion-restore", 0)
    return engine


def test_public_names():
    for name in ("register", "ModelFamily", "ParamCache", "get_family", "list_families"):
        assert name in models.__all__ and hasattr(models, name)
    assert register is registry.register and ModelFamily is registry.ModelFamily


def test_put_replaces_the_cached_state(scratch_registry):
    cache = ParamCache(0)
    first = cache.get("restore-unet-small")
    state = _put_random(cache, "restore-unet-small", 3)
    assert cache.get("restore-unet-small") is state and state is not first


def test_register_replaces_and_adds(scratch_registry):
    before = list_families()
    family = ModelFamily("restore-narrow", UNetConfig(**NARROW))
    register(family)
    assert get_family("restore-narrow") is family
    assert list_families() == sorted(before + ["restore-narrow"])
    replacement = ModelFamily("restore-narrow", UNetConfig(residual_shrink=0.01, **NARROW))
    register(replacement)
    assert get_family("restore-narrow") is replacement


def test_registered_diffusion_family_restore_batch(diffusion_engine):
    canvas = np.full((1, 32, 32, 3), 128, dtype=np.uint8)
    out, scores, meta = diffusion_engine.restore_batch(canvas, family_name="diffusion-restore")
    assert out.shape == (1, 32, 32, 3) and out.dtype == np.uint8
    assert scores.shape == (1, 7) and meta["family"] == "diffusion-restore"
    assert diffusion_engine.model("diffusion-restore").config.base_channels == 32


def test_registered_diffusion_family_is_stochastic_but_bounded(diffusion_engine):
    canvas = np.full((1, 32, 32, 3), 100, dtype=np.uint8)
    out1, _, _ = diffusion_engine.restore_batch(canvas, family_name="diffusion-restore")
    out2, _, _ = diffusion_engine.restore_batch(canvas, family_name="diffusion-restore")
    assert not np.array_equal(out1, out2)  # the engine's generator moves on
    assert np.abs(out1.astype(int) - 100).mean() < 80  # strength 0.3 keeps the content


def test_registered_diffusion_family_through_restorator(diffusion_engine):
    svc = RestoratorService(engine=diffusion_engine, serving_config=diffusion_engine.config, device="cpu")
    image = imageio.encode_jpeg(np.full((32, 32, 3), 180, dtype=np.uint8), quality=95)
    result = svc.restore(image, options={"model": "diffusion-restore"})
    assert result["success"] is True, result
    assert result["metadata"]["model"] == "diffusion-restore"


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "folded"])
def test_registered_restore_and_sr_families_serve(scratch_registry, fold):
    """New names: a restore UNet served through the restore program, folded
    under ``fold_w`` like the shipped restore UNets, and an SR family through
    ``sr_batch``, folded under ``fold_w_sr`` like the shipped SR families."""
    register(ModelFamily("restore-narrow", UNetConfig(**NARROW)))
    register(ModelFamily("sr-narrow", SRNetConfig(scale=2, channels=16, num_blocks=2)))
    engine = RestorationEngine(device="cpu", serving_config=ServingConfig(size_buckets=(32,), max_batch=2,
                                                                          fold_w=fold, fold_w_sr=fold))
    _put_random(engine.params_cache, "restore-narrow", 1)
    canvas = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    out, scores, _ = engine.restore_batch(canvas, family_name="restore-narrow")
    assert out.shape == (2, 32, 32, 3) and scores.shape == (2, 7)
    up, meta = engine.sr_batch(canvas, "sr-narrow")  # random weights from the cache's seed
    assert up.shape == (2, 64, 64, 3) and meta["family"] == "sr-narrow"
    assert getattr(engine.model("sr-narrow"), "folded", False) == fold
    assert getattr(engine.model("restore-narrow"), "folded", False) == fold


# What each shipped family is, as the serving path reads it: its kind, whether
# models/folded.py has a W-folded layout of it and whether it row-shards, then
# (uses_folded, uses_s2d_io) under each serving config of SERVING.
SERVING = {"default": {}, "fold_w_sr": {"fold_w_sr": True}, "fold_w_off": {"fold_w": False}}
ANSWERS = {
    "restore-unet": ("restore", True, False, {"default": (True, False), "fold_w_sr": (True, False),
                                              "fold_w_off": (False, True)}),
    "restore-unet-small": ("restore", True, False, {"default": (True, False), "fold_w_sr": (True, False),
                                                    "fold_w_off": (False, False)}),
    "sr-x2": ("sr", True, True, {"default": (False, False), "fold_w_sr": (True, False),
                                 "fold_w_off": (False, False)}),
    "sr-x4": ("sr", True, True, {"default": (False, False), "fold_w_sr": (True, False),
                                 "fold_w_off": (False, False)}),
    "swinir-m-x2": ("sr", False, False, {"default": (False, False), "fold_w_sr": (False, False),
                                         "fold_w_off": (False, False)}),
    "diffusion-restore": ("diffusion", True, False, {"default": (True, False), "fold_w_sr": (True, False),
                                                     "fold_w_off": (False, False)}),
}


def _kind(name: str) -> str:
    """"sr" for a family the SR path takes, else "diffusion" where the
    restore program draws sampler noise, else "restore"."""
    if models.is_sr_family(name):
        return "sr"
    program = build_restore_program(name, dtype=torch.float32, use_s2d_io=False, use_deblur=False,
                                    use_deblock=False)
    return "diffusion" if "noise" in program.inputs else "restore"


def _has_folded_layout(name: str) -> bool:
    family = get_family(name)
    try:
        folded_model(family.config, family.build().state_dict())
    except ValueError:
        return False
    return True


def _row_shards(name: str) -> bool:
    """Whether ``sr_spatial`` takes the family: on an engine with no mesh it
    then refuses for want of a spatial axis, not for the family."""
    engine = RestorationEngine(device="cpu", serving_config=ServingConfig(size_buckets=(32,), max_batch=1))
    with pytest.raises(ValueError) as refused:
        engine.sr_spatial(np.zeros((32, 32, 3), np.uint8), name)
    return "spatial axis" in str(refused.value)


OBSERVED = {
    "kind": _kind,
    "has_folded_layout": _has_folded_layout,
    "row_shards": _row_shards,
    **{f"uses_folded[{s}]": (lambda name, s=s: uses_folded(name, ServingConfig(**SERVING[s]))) for s in SERVING},
    **{f"uses_s2d_io[{s}]": (lambda name, s=s: uses_s2d_io(name, ServingConfig(**SERVING[s]))) for s in SERVING},
}


def _expected(name: str, answer: str):
    kind, folded_layout, row_shards, by_serving = ANSWERS[name]
    if answer in ("kind", "has_folded_layout", "row_shards"):
        return {"kind": kind, "has_folded_layout": folded_layout, "row_shards": row_shards}[answer]
    which, serving = answer[:-1].split("[")
    return by_serving[serving][("uses_folded", "uses_s2d_io").index(which)]


@pytest.mark.parametrize("answer", list(OBSERVED))
@pytest.mark.parametrize("name", list(ANSWERS))
def test_shipped_family_answers(monkeypatch, name, answer):
    """Each shipped family's kind, layouts and row-sharding, as the serving
    path reads them, with no SERVE_* setting of the environment in the way."""
    for key in ("SERVE_FOLD_W", "SERVE_FOLD_W_SR", "SERVE_S2D_IO"):
        monkeypatch.delenv(key, raising=False)
    assert OBSERVED[answer](name) == _expected(name, answer)


@pytest.mark.parametrize("name", ["sr-x2", "swinir-m-x2", "diffusion-restore"])
def test_serving_forward_refuses_what_is_no_restore_unet(name):
    with pytest.raises(ValueError, match=f"restore UNet families, not {name}"):
        serving_forward(name, None, np.zeros((1, 32, 32, 3), np.float32))


def test_a_diffusion_family_under_another_name_runs_the_diffusion_program(scratch_registry):
    """The engine takes a diffusion family by its config, not its name: it
    draws the sampler's noise and counts a diffusion batch."""
    from image_restoration_platform_tpu_torch.obs.metrics import get_counters

    cfg = DiffusionConfig(sample_steps=2, strength=0.3, unet=UNetConfig(in_channels=6, time_conditioned=True, **NARROW))
    register(ModelFamily("denoise-narrow", cfg))
    engine = RestorationEngine(device="cpu", serving_config=ServingConfig(size_buckets=(32,), max_batch=2))
    _put_random(engine.params_cache, "denoise-narrow", 0)
    before = get_counters().snapshot().get("diffusion_batches.32", 0.0)
    canvas = np.full((1, 32, 32, 3), 128, dtype=np.uint8)
    out, scores, meta = engine.restore_batch(canvas, family_name="denoise-narrow")
    assert out.shape == (1, 32, 32, 3) and scores.shape == (1, 7) and meta["family"] == "denoise-narrow"
    assert get_counters().snapshot()["diffusion_batches.32"] - before == 1
    assert "noise" in engine._program("denoise-narrow", "rgb").inputs
