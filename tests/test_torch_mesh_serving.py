"""PyTorch port: the engine's mesh surfaces on in-process CPU slot meshes.

Mirrors tests/test_mesh_serving.py and tests/test_mesh_throughput.py, each
surface held to the unsharded port with the reference's bars:
``restore_batch`` mean |delta| < 1 level with scores within 1e-4;
``sr_tiled`` exactly; ``sr_spatial`` max |delta| <= 1 level with the rows at
shard boundaries no worse than max(0.5, 1.5 x the mean). The reference's
structural checks of its compiled programs (FLOPs per device, shards per
device, executable-cache tags) become checks of what each data slot's
replica ran and which programs the engine built."""

import threading

import numpy as np
import pytest
import torch

from image_restoration_platform_tpu_torch import imageio
from image_restoration_platform_tpu_torch.config import ServingConfig
from image_restoration_platform_tpu_torch.models import get_family
from image_restoration_platform_tpu_torch.obs.metrics import get_counters
from image_restoration_platform_tpu_torch.parallel import make_mesh
from image_restoration_platform_tpu_torch.serve import MicroBatcher, RestorationEngine, RestoratorService
from image_restoration_platform_tpu_torch.serve.programs import sr as sr_programs

torch.set_num_threads(2)
CPU = torch.device("cpu")
FAMILY = "restore-unet-small"


def cpu_mesh(**axes):
    n = 1
    for size in axes.values():
        n *= size
    return make_mesh([CPU] * n, **axes)


@pytest.fixture(scope="module")
def cfg():
    return ServingConfig(size_buckets=(32,), max_batch=8)


@pytest.fixture(scope="module")
def mesh_engine(cfg):
    return RestorationEngine(serving_config=cfg, mesh=cpu_mesh(data=4, tensor=2))


@pytest.fixture(scope="module")
def single(cfg):
    return RestorationEngine(device="cpu", serving_config=cfg)


def _batch_sizes(replicas):
    """The batch sizes the replicas' forwards saw, in call order (slots that
    repeat a device share one replica: one hook a module)."""
    seen = []
    unique = {id(r): r for r in replicas}.values()
    handles = [r.register_forward_hook(lambda m, args, out: seen.append(args[0].shape[0])) for r in unique]
    return seen, handles


def test_mesh_restore_batch(mesh_engine):
    canvas = np.random.default_rng(0).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    out, scores, meta = mesh_engine.restore_batch(canvas, family_name=FAMILY)
    assert out.shape == (8, 32, 32, 3) and out.dtype == np.uint8
    assert scores.shape == (8, 7)
    assert meta["batchBucket"] >= 4  # padded at least to the data-axis size


def test_mesh_pads_small_batches_to_data_axis(mesh_engine):
    canvas = np.random.default_rng(1).integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
    out, scores, meta = mesh_engine.restore_batch(canvas, family_name=FAMILY)
    assert out.shape == (1, 32, 32, 3)
    assert meta["batchBucket"] == 4  # data axis = 4 shards minimum


def test_mesh_matches_single_device(mesh_engine, single):
    """DP x TP execution must match the unsharded result."""
    canvas = np.random.default_rng(2).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    out_m, scores_m, _ = mesh_engine.restore_batch(canvas, family_name=FAMILY)
    out_s, scores_s, _ = single.restore_batch(canvas, family_name=FAMILY)
    np.testing.assert_allclose(scores_m, scores_s, atol=1e-4)
    assert np.mean(np.abs(out_m.astype(int) - out_s.astype(int))) < 1.0


def test_mesh_plane_egress_and_diffusion_match_single_device(cfg, single):
    """The yuv420 planes are gathered plane by plane, and the diffusion
    family's noise is drawn for the whole bucket before the split, so a
    seeded mesh engine samples what a seeded single engine samples."""
    canvas = np.random.default_rng(5).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    mesh_engine = RestorationEngine(serving_config=cfg, mesh=cpu_mesh(data=2, tensor=2), seed=7)
    lone = RestorationEngine(device="cpu", serving_config=cfg, seed=7)
    planes_m, _, _ = mesh_engine.restore_batch(canvas, family_name=FAMILY, egress="yuv420")
    planes_s, _, _ = lone.restore_batch(canvas, family_name=FAMILY, egress="yuv420")
    for a, b in zip(planes_m, planes_s):
        assert a.shape == b.shape and np.mean(np.abs(a.astype(int) - b.astype(int))) < 1.0
    out_m, scores_m, _ = mesh_engine.restore_batch(canvas[:2], family_name="diffusion-restore")
    out_s, scores_s, _ = lone.restore_batch(canvas[:2], family_name="diffusion-restore")
    np.testing.assert_allclose(scores_m, scores_s, atol=1e-4)
    assert np.mean(np.abs(out_m.astype(int) - out_s.astype(int))) < 1.0


def test_mesh_path_reuses_its_replicas_and_program(mesh_engine):
    """The counterpart of the reference's executable-cache check: repeat
    calls reuse the data replicas (column-parallel over 2 tensor slots) and
    the one program the engine built for the family."""
    canvas = np.random.default_rng(3).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    mesh_engine.restore_batch(canvas, family_name=FAMILY)
    replicas = mesh_engine._replicas[("data", FAMILY)]
    programs = dict(mesh_engine._programs)
    assert len(replicas) == 4 and all(r is not mesh_engine.model(FAMILY) for r in replicas)
    mesh_engine.restore_batch(canvas, family_name=FAMILY)
    assert mesh_engine._replicas[("data", FAMILY)] is replicas and mesh_engine._programs == programs


def test_mesh_sr_tiled_matches_single_device(cfg, single):
    """Tile batch split over the data axis must reproduce the single-device
    tiled result exactly."""
    mesh_engine = RestorationEngine(serving_config=cfg, mesh=cpu_mesh(data=8))
    canvas = np.random.default_rng(4).integers(0, 256, (96, 96, 3), dtype=np.uint8)
    out_m, meta_m = mesh_engine.sr_tiled(canvas, tile=64, overlap=16, tile_batch=2)
    out_s, _ = single.sr_tiled(canvas, tile=64, overlap=16, tile_batch=2)
    assert out_m.shape == (192, 192, 3)
    np.testing.assert_array_equal(out_m, out_s)
    assert any(k[0] == "sr_tiled_mesh" for k in mesh_engine._programs)


def _sr_reference(engine, canvas):
    """The unsharded SRNet forward (limiter included) of one canvas, u8."""
    with torch.inference_mode():
        x = torch.from_numpy(canvas)[None].to(engine.dtype) / 255.0
        out = engine.model("sr-x2")(x).float()[0] * 255.0
    return torch.round(torch.clamp(out, 0, 255)).to(torch.uint8).numpy()


def test_sr_spatial_matches_single_device(cfg):
    """One image row-sharded over the spatial axis, a halo row exchanged at
    every convolution, against the unsharded forward: <= 1 level, and the
    rows around each shard boundary as close as everywhere else."""
    engine = RestorationEngine(serving_config=cfg, mesh=cpu_mesh(spatial=8))
    halo = 2 * get_family("sr-x2").config.num_blocks + 3
    h = 8 * max(32, halo + 1)  # shards taller than the halo
    canvas = np.random.default_rng(5).integers(0, 256, (h, 64, 3), dtype=np.uint8)
    out, meta = engine.sr_spatial(canvas, family_name="sr-x2")
    assert meta["spatialShards"] == 8 and meta["halo"] == halo and meta["paddedRows"] == 0
    ref = _sr_reference(engine, canvas)
    diff = np.abs(out.astype(int) - ref.astype(int))
    assert diff.max() <= 1, f"max diff {diff.max()} exceeds quantization jitter"
    sp, rows = 8, ref.shape[0]
    boundary_rows = [r for b in range(1, sp) for r in (rows // sp * b - 1, rows // sp * b)]
    assert diff[boundary_rows].mean() <= max(0.5, diff.mean() * 1.5)


def test_sr_spatial_pads_arbitrary_heights(cfg):
    """Heights not divisible by the spatial axis repeat the last row to the
    next multiple and are cropped: the unsharded forward of the padded
    canvas, cropped."""
    engine = RestorationEngine(serving_config=cfg, mesh=cpu_mesh(spatial=8))
    canvas = np.random.default_rng(6).integers(0, 256, (101, 64, 3), dtype=np.uint8)
    out, meta = engine.sr_spatial(canvas, family_name="sr-x2")
    assert meta["paddedRows"] == 3 and out.shape == (202, 128, 3)
    padded = np.concatenate([canvas, np.repeat(canvas[-1:], 3, axis=0)], axis=0)  # to 104 = 8 x 13
    diff = np.abs(out.astype(int) - _sr_reference(engine, padded)[:202].astype(int))
    assert diff.max() <= 1, f"max diff {diff.max()} vs the padded unsharded forward"
    with pytest.raises(ValueError, match="spatial axis"):
        RestorationEngine(device="cpu", serving_config=cfg).sr_spatial(canvas)


def test_restorator_routes_huge_canvas_to_spatial_mesh(monkeypatch):
    """With a spatial mesh, huge-canvas SR requests take the row-sharded
    path instead of tiling."""
    cfg = ServingConfig(size_buckets=(64, 128), max_batch=4)
    engine = RestorationEngine(serving_config=cfg, mesh=cpu_mesh(spatial=8))
    service = RestoratorService(engine=engine, serving_config=cfg, device="cpu")
    monkeypatch.setattr(sr_programs, "DIRECT_MAX", 64)
    before = get_counters().snapshot()
    img = np.random.default_rng(7).integers(0, 256, (100, 100, 3), dtype=np.uint8)
    result = service.restore(imageio.encode_jpeg(img, quality=90), options={"model": "sr-x2"})
    assert result["success"], result.get("error")
    after = get_counters().snapshot()
    assert after.get("sr_spatial_calls.128", 0) - before.get("sr_spatial_calls.128", 0) == 1
    assert not any(k[0].startswith("sr_tiled") for k in engine._programs), engine._programs.keys()
    assert result["metadata"]["outputSize"] == [200, 200]


# ------------------------------------------------- the data axis at work


def test_data_parallel_gives_each_slot_its_shard(cfg):
    """Each of 8 data slots runs its own replica on 1/8 of the batch."""
    engine = RestorationEngine(serving_config=cfg, mesh=cpu_mesh(data=8))
    canvas = np.random.default_rng(0).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    engine.restore_batch(canvas, family_name=FAMILY)
    seen, handles = _batch_sizes(engine._replicas[("data", FAMILY)])
    try:
        engine.restore_batch(canvas, family_name=FAMILY)
    finally:
        for h in handles:
            h.remove()
    assert seen == [1] * 8


def test_bucket_pads_to_a_multiple_of_the_data_axis(cfg):
    """A data axis of 3: 4 images pad to 6 (two a slot), 1 image to 3."""
    engine = RestorationEngine(serving_config=cfg, mesh=cpu_mesh(data=3))
    canvas = np.random.default_rng(8).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    out, _, meta = engine.restore_batch(canvas, family_name=FAMILY)
    assert meta["batchBucket"] == 6 and out.shape == (4, 32, 32, 3)
    _, _, meta1 = engine.restore_batch(canvas[:1], family_name=FAMILY)
    assert meta1["batchBucket"] == 3


def test_mesh_sr_tiled_gives_each_slot_one_tile_slice(cfg):
    """The tiled SR path splits every chunk of tile_batch x data tiles over
    the data slots: each slot's replica restores tile_batch tiles a call."""
    canvas = np.random.default_rng(1).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    single = RestorationEngine(device="cpu", serving_config=cfg)
    meshed = RestorationEngine(serving_config=cfg, mesh=cpu_mesh(data=4))
    out_s, _ = single.sr_tiled(canvas, "sr-x2", tile=16, overlap=4, tile_batch=2)
    meshed.sr_tiled(canvas, "sr-x2", tile=16, overlap=4, tile_batch=2)
    seen, handles = _batch_sizes(meshed._replicas[("data", "sr-x2")])
    try:
        out_m, _ = meshed.sr_tiled(canvas, "sr-x2", tile=16, overlap=4, tile_batch=2)
    finally:
        for h in handles:
            h.remove()
    assert np.array_equal(out_s, out_m)
    # 25 tiles -> 32 in four chunks of 8: two tiles a slot a chunk
    assert seen == [2] * 16


def test_batcher_feeds_mesh_full_width(cfg):
    """Concurrent traffic through the micro-batcher on the mesh engine forms
    device-wide batches and returns each request's result."""
    engine = RestorationEngine(serving_config=cfg, mesh=cpu_mesh(data=8))
    batch_cfg = ServingConfig(size_buckets=(32,), max_batch=8, max_wait_ms=150.0)
    batcher = MicroBatcher(engine, config=batch_cfg, device="cpu")
    canvases = np.random.default_rng(2).integers(0, 256, (16, 32, 32, 3)).astype(np.uint8)
    results: dict = {}
    errors: list = []

    def worker(i):
        try:
            out, scores, meta = batcher.submit(canvases[i], (32, 32), False, FAMILY)
            results[i] = (out, meta)
        except Exception as err:  # pragma: no cover
            errors.append(err)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    batcher.shutdown()
    assert not errors, errors
    assert len(results) == 16
    buckets = {meta["batchBucket"] for _, meta in results.values()}
    assert max(buckets) == 8, f"batcher never formed a device-wide batch: {buckets}"
    for out, _ in results.values():
        assert out.shape == (32, 32, 3)
