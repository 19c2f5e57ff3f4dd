"""PyTorch port: the repaired differences from the reference.

- cost: every result's metadata carries ``estimatedCostUsd`` (device seconds
  at ``ServingConfig.device_cost_per_hour_usd``, rounded to 8 places as the
  reference rounds) and ``restore`` adds the same to the ``tpu_cost_usd``
  counter; the counters a reference restore increments are all counted;
- the stages' fire flags: the deblock and deblur decisions are kept per
  image, come back in the engine's one fetch and are counted as
  ``stage_fires.*``, equal image for image to the reference's decisions on
  tests/test_torch_stages.py's canvases, unsharded and on data meshes of 2
  and 4 CPU slots (a shard decides its own images only); the host branches
  stay, one sync a decision and data slot;
- attention shapes: a family whose bottleneck the kernel cannot take is
  refused when a card loads it, naming the family and the shape, and every
  shipped family passes.
(The admin analytics body's ``tpu`` key is held in tests/test_torch_api.py.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu.classify import fused as jfused
from image_restoration_platform_tpu.config import ServingConfig as JServingConfig
from image_restoration_platform_tpu.obs.metrics import get_counters as jget_counters
from image_restoration_platform_tpu.ops import deblock as JK
from image_restoration_platform_tpu.ops import deblur as JD
from image_restoration_platform_tpu.serve import RestorationEngine as JEngine
from image_restoration_platform_tpu.serve import RestoratorService as JService
from image_restoration_platform_tpu_torch import imageio
from image_restoration_platform_tpu_torch.config import ServingConfig
from image_restoration_platform_tpu_torch.models import list_families, registry
from image_restoration_platform_tpu_torch.models.unet import UNetConfig
from image_restoration_platform_tpu_torch.obs.metrics import get_counters
from image_restoration_platform_tpu_torch.parallel import make_mesh
from image_restoration_platform_tpu_torch.serve import RestorationEngine, RestoratorService
from image_restoration_platform_tpu_torch.serve.programs.restore import fire_flags as _fire_flags
from test_torch_stages import _deblock_batch, _deblur_batch
from torch_reference_codec import build_reference_codec

build_reference_codec()  # before any xdist worker loads the reference's codec (see the helper)

torch.set_num_threads(2)
FAMILY = "restore-unet-small"


def _delta(before: dict, after: dict) -> dict:
    """The counters that moved (the clock's gauges left out)."""
    return {k: after[k] - before.get(k, 0.0) for k in after
            if after[k] != before.get(k, 0.0) and k not in ("uptime_s", "images_per_sec")}


# ---------------------------------------------------------------- the cost


def test_every_result_reports_its_cost_at_the_card_rate(monkeypatch):
    monkeypatch.setenv("DEVICE_COST_PER_HOUR_USD", "7.2")
    cfg = ServingConfig(size_buckets=(64,), max_batch=2)
    assert cfg.device_cost_per_hour_usd == 7.2
    svc = RestoratorService(engine=RestorationEngine(device="cpu", serving_config=cfg), serving_config=cfg,
                            device="cpu")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)
    before = get_counters().snapshot()
    single = svc.restore(imageio.encode_png(img), options={"model": FAMILY})
    counted = _delta(before, get_counters().snapshot())
    sr = svc.restore(imageio.encode_png(img), options={"model": "sr-x2"})
    fused = svc.restore_fusion([imageio.encode_png(img)] * 2, options={"model": FAMILY})
    for result in (single, sr, fused):
        meta = result["metadata"]
        assert result["success"] and meta["deviceSeconds"] > 0
        assert meta["estimatedCostUsd"] == round(meta["deviceSeconds"] * 7.2 / 3600.0, 8)
    assert counted["tpu_cost_usd"] == pytest.approx(single["metadata"]["deviceSeconds"] * 7.2 / 3600.0, rel=1e-12)
    assert ServingConfig.__dataclass_fields__["device_cost_per_hour_usd"] is not None
    monkeypatch.delenv("DEVICE_COST_PER_HOUR_USD")
    assert ServingConfig().device_cost_per_hour_usd == 3.0  # the stated default


def test_restore_counts_what_the_reference_counts():
    """One restore through each package's RestoratorService (no batcher):
    every counter the reference's increments, the port's increments too."""
    img = np.random.default_rng(1).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    jcfg = JServingConfig(size_buckets=(32,), max_batch=1)
    jsvc = JService(engine=JEngine(compute_dtype=jnp.float32, serving_config=jcfg), serving_config=jcfg)
    before = jget_counters().snapshot()
    assert jsvc.restore(imageio.encode_png(img), options={"model": FAMILY})["success"]
    ref = _delta(before, jget_counters().snapshot())
    cfg = ServingConfig(size_buckets=(32,), max_batch=1)
    svc = RestoratorService(engine=RestorationEngine(device="cpu", serving_config=cfg), serving_config=cfg,
                            device="cpu")
    before = get_counters().snapshot()
    assert svc.restore(imageio.encode_png(img), options={"model": FAMILY})["success"]
    got = _delta(before, get_counters().snapshot())
    assert {"restorations_total", "tpu_cost_usd"} <= set(ref) <= set(got)


# ----------------------------------------------------------- the stage gates


def _reference_fires(canvas: np.ndarray, valid: np.ndarray, is_jpeg: np.ndarray) -> tuple[list, list]:
    """The reference's per-image decisions in its serving order: deblock,
    then deblur on the deblocked canvas with the recomputed scores (one jit
    program, as the reference serves them)."""

    def stages(c, v, j):
        scores, cond = jfused.batch_classify_and_condition(c.astype(jnp.float32), v, j)
        _, fire_k = JK.deblock_canvas_batch(c, v)
        deblocked, stage_scores, cond = JK.deblock_and_recondition(c, v, j, scores, cond)
        deblurred, _ = JD.deblur_and_recondition(deblocked, v, j, stage_scores, cond)
        return fire_k, deblocked, deblurred

    with jax.default_matmul_precision("highest"):
        fire_k, deblocked, deblurred = jax.jit(stages)(canvas, valid, is_jpeg)
    deblocked, deblurred = np.asarray(deblocked), np.asarray(deblurred)
    fire_d = [not np.array_equal(deblurred[i], deblocked[i]) for i in range(len(canvas))]
    return np.asarray(fire_k).tolist(), fire_d


LAYOUTS = {"unsharded": 1, "data2": 2, "data4": 4}


def _fire_flags_of(engine, canvas, valid, is_jpeg) -> np.ndarray:
    """[N, 3] per-image flags (``STAGE_FIRES`` order) of one run of the
    engine's restore program, padded as the engine pads the bucket."""
    n, bucket = len(canvas), 16
    pad = lambda a: np.concatenate([a, np.repeat(a[-1:], bucket - n, axis=0)])  # noqa: E731
    args = tuple(torch.from_numpy(pad(a)) for a in (canvas, valid, is_jpeg))
    program = engine._program(FAMILY, "rgb")
    if engine._is_multi_device():
        flags = engine._mesh_executable(FAMILY, program, args, "rgb")(args)[2]
    else:
        fires: dict = {}
        program(engine.model(FAMILY), *args, fires=fires)
        flags = _fire_flags(fires, bucket, engine.device)
    return flags.numpy()[:n].astype(bool)


@pytest.fixture(scope="module")
def stage_runs():
    """tests/test_torch_stages.py's deblock and deblur canvases in one batch
    of 13 (a bucket of 16), the reference's decisions on it, and for each
    layout one engine batch and the program's per-image flags:
    (reference fires, {layout: (restore_batch result, counters moved, flags)})."""
    canvas = np.concatenate([_deblock_batch(), _deblur_batch()])
    n = len(canvas)
    valid = np.tile(np.asarray([[128, 128]], np.int32), (n, 1))
    is_jpeg = np.asarray([1.0] * len(_deblock_batch()) + [0.0] * len(_deblur_batch()), np.float32)
    ref = _reference_fires(canvas, valid, is_jpeg)
    cfg = ServingConfig(size_buckets=(128,), max_batch=16, restore_egress="rgb")
    runs = {}
    for layout, dp in LAYOUTS.items():
        mesh = make_mesh([torch.device("cpu")] * dp, data=dp) if dp > 1 else None
        engine = RestorationEngine(device="cpu", serving_config=cfg, mesh=mesh)
        before = get_counters().snapshot()
        out = engine.restore_batch(canvas, valid, is_jpeg, family_name=FAMILY)
        runs[layout] = (out, _delta(before, get_counters().snapshot()), _fire_flags_of(engine, canvas, valid, is_jpeg))
    return ref, runs


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_stage_fires_come_back_per_image_and_equal_the_reference(stage_runs, layout):
    (ref_k, ref_d), runs = stage_runs
    assert any(ref_k) and any(ref_d) and not all(ref_k) and not all(ref_d)
    out, delta, flags = runs[layout]
    deblock, veto, deblur = flags.T
    assert deblock.tolist() == ref_k and deblur.tolist() == ref_d
    assert not (deblur & ~veto).any()  # the veto's gate holds every deblurred image
    assert delta.get("stage_fires.deblock", 0) == sum(ref_k), delta
    assert delta.get("stage_fires.deblur", 0) == sum(ref_d), delta
    assert delta.get("stage_fires.deblur_veto", 0) == int(veto.sum())
    # one sync a decision on each data slot
    dp = LAYOUTS[layout]
    syncs = {k: v for k, v in delta.items() if k.startswith("host_syncs.")}
    assert syncs == {"host_syncs.deblock": dp, "host_syncs.deblur_veto": dp, "host_syncs.deblur": dp}
    if dp > 1:  # the same scores and fire counts as the unsharded engine
        ref_result, ref_delta, _ = runs["unsharded"]
        np.testing.assert_allclose(out[1], ref_result[1], rtol=0, atol=1e-5)
        assert {k: v for k, v in delta.items() if k.startswith("stage_fires.")} == {
            k: v for k, v in ref_delta.items() if k.startswith("stage_fires.")}


# -------------------------------------------------------- attention shapes


def test_family_the_attention_kernel_cannot_take_is_refused_at_load(monkeypatch):
    """A bottleneck of 192 channels over 4 heads is D = 48, which no
    variant of the kernel takes: loading it on a card raises, naming the
    family and the shape, before anything is built or launched."""
    synthetic = registry.ModelFamily("synthetic-d48", UNetConfig(base_channels=48, input_scale=2))
    monkeypatch.setattr(registry, "_FAMILIES", dict(registry._FAMILIES))  # restored after the test
    registry.register(synthetic)
    assert registry.attention_shapes("synthetic-d48", (256, 512, 1024), 8) == [(8, 4, 1024, 48), (8, 4, 4096, 48)]
    with pytest.raises(ValueError, match=r"synthetic-d48.*\[8, 4, 1024, 48\].*head dim"):
        registry.check_attention_shapes("synthetic-d48", (256,), 8, torch.bfloat16)
    engine = RestorationEngine(device="cpu", serving_config=ServingConfig(size_buckets=(256,), max_batch=8))
    monkeypatch.setattr(engine, "device", torch.device("cuda"))  # as a card would load it
    with pytest.raises(ValueError, match="synthetic-d48"):
        engine.model("synthetic-d48")
    assert not any(name == "synthetic-d48" for name, _ in engine._models)


def test_shipped_families_fit_the_attention_kernel():
    for family in list_families():
        registry.check_attention_shapes(family, (256, 512, 1024), 8, torch.bfloat16)  # serving
        registry.check_attention_shapes(family, (128,), 32, torch.bfloat16)  # training
    assert registry.attention_shapes("restore-unet", (256, 512, 1024), 8) == [(8, 4, 1024, 64), (8, 4, 4096, 64)]
    assert registry.attention_shapes("sr-x2", (256,), 8) == []
