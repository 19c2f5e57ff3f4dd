"""PyTorch port: the mesh executable tier on in-process CPU slot meshes.

Mirrors the reference's cache checks of its mesh programs
(tests/test_mesh_serving.py): a mesh restore builds one executable under a
``"mesh"``-tagged key that carries the mesh's shape and builds nothing on a
repeat; ``sr_tiled`` on a mesh goes through an ``"sr_tiled_mesh"`` key and
``sr_spatial`` through an ``"sr_spatial"`` key. On the CPU nothing is
captured, so these tests hold the keys, the single-flight gate,
``compile_count``, the warm-up's coverage, the layout plan that decides
what a card may capture, and the segment-major order of the data rows
against slot-after-slot execution; the CUDA graphs are held to eager
execution on the card (the ``cuda``-marked test here, and chip_smoke.py's
mesh phase). The port's mesh engine is held to the reference's mesh engine
(mean |delta| < 1 level, scores within 1e-4, ``compile_count`` moving
alike), and the mesh trainer's executable to the unsharded trainer at
tests/test_torch_mesh_train.py's bars. JAX is imported inside the one test
that runs the reference, so the card runs the ``cuda`` test without it."""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from image_restoration_platform_tpu_torch import imageio
from image_restoration_platform_tpu_torch.config import ServingConfig
from image_restoration_platform_tpu_torch.parallel import Mesh, capture_plan, make_mesh
from image_restoration_platform_tpu_torch.serve import RestorationEngine, RestoratorService
from image_restoration_platform_tpu_torch.serve.programs.restore import fire_flags
from image_restoration_platform_tpu_torch.train.ood import ood_clean
from image_restoration_platform_tpu_torch.train.trainer import TrainConfig, Trainer
from torch_reference_codec import build_reference_codec

build_reference_codec()
torch.set_num_threads(2)
CPU = torch.device("cpu")
FAMILY = "restore-unet-small"


def cpu_mesh(**axes):
    n = 1
    for size in axes.values():
        n *= size
    return make_mesh([CPU] * n, **axes)


def _mesh_shape(**axes) -> tuple:
    return tuple(sorted({"data": 1, "tensor": 1, "spatial": 1, "pipe": 1, **axes}.items()))


def _keys(engine, tag: str) -> list:
    return [k for k in engine._exec_cache._built if isinstance(k[0], tuple) and k[0][0] == tag]


@pytest.fixture(scope="module")
def cfg():
    return ServingConfig(size_buckets=(32,), max_batch=8)


def test_mesh_restore_builds_one_mesh_key_and_reuses_it(cfg):
    engine = RestorationEngine(serving_config=cfg, mesh=cpu_mesh(data=4, tensor=2))
    canvas = np.random.default_rng(3).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    first, _, _ = engine.restore_batch(canvas, family_name=FAMILY)
    builds = engine.compile_count
    keys = _keys(engine, "mesh")
    assert builds == 1 and len(keys) == 1
    assert keys[0][0] == ("mesh", FAMILY, _mesh_shape(data=4, tensor=2))
    again, _, _ = engine.restore_batch(canvas, family_name=FAMILY)
    engine.restore_batch(canvas[:1], family_name=FAMILY)  # pads to the data axis: the same bucket
    assert engine.compile_count == builds
    np.testing.assert_array_equal(first, again)
    assert engine.exec_stats() == {"compile_count": 1, "executables": 1, "graphs": 0, "eager_executables": 0}


@pytest.mark.parametrize("surface", ["sr_tiled", "sr_spatial"])
def test_mesh_sr_surfaces_go_through_mesh_keys(cfg, surface):
    """``sr_tiled`` on data=8 under ``"sr_tiled_mesh"`` and ``sr_spatial``
    on spatial=2 under ``"sr_spatial"``, each with the mesh's shape in its
    tag, built once over repeats."""
    rng = np.random.default_rng(4)
    if surface == "sr_tiled":
        axes = dict(data=8)
        engine = RestorationEngine(serving_config=cfg, mesh=cpu_mesh(**axes))
        canvas = rng.integers(0, 256, (96, 96, 3), dtype=np.uint8)
        run = lambda: engine.sr_tiled(canvas, tile=64, overlap=16, tile_batch=2)[0]  # noqa: E731
        tag = ("sr_tiled_mesh", "sr-x2", 64, 16, 2, "rgb", _mesh_shape(**axes))
    else:
        axes = dict(spatial=2)
        engine = RestorationEngine(serving_config=cfg, mesh=cpu_mesh(**axes))
        canvas = rng.integers(0, 256, (63, 40, 3), dtype=np.uint8)  # one row of padding
        run = lambda: engine.sr_spatial(canvas, "sr-x2")[0]  # noqa: E731
        tag = ("sr_spatial", "sr-x2", (64, 40, 3), _mesh_shape(**axes))
    first = run()
    assert engine.compile_count == 1 and [k[0] for k in _keys(engine, tag[0])] == [tag]
    np.testing.assert_array_equal(run(), first)
    assert engine.compile_count == 1


def test_mesh_key_builds_once_under_concurrent_requests(cfg):
    """Four threads ask for one mesh key at once: one build, equal outputs
    (thread switches forced often)."""
    engine = RestorationEngine(serving_config=cfg, mesh=cpu_mesh(data=2, tensor=2))
    canvas = np.random.default_rng(5).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    results, errors = [], []

    def worker():
        try:
            results.append(engine.restore_batch(canvas, family_name=FAMILY)[0])
        except Exception as error:  # pragma: no cover
            errors.append(error)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(results) == 4 and engine.compile_count == 1
    for out in results[1:]:
        np.testing.assert_array_equal(out, results[0])


def test_warmup_serving_builds_the_mesh_executables_requests_need():
    """After ``warmup_serving`` on a data=4 x tensor=2 engine, requests
    through ``RestoratorService`` (and the tiled SR call) build nothing."""
    cfg = ServingConfig(size_buckets=(32,), max_batch=8)
    engine = RestorationEngine(serving_config=cfg, mesh=cpu_mesh(data=4, tensor=2))
    report = engine.warmup_serving(families=(FAMILY, "sr-x2"), sr_tiled_canvas=96)
    assert {f"{FAMILY}/restore/32/b8", f"{FAMILY}/restore/32/b1", "sr-x2/tiled-rgb/96"} <= set(report)
    builds = engine.compile_count
    assert {k[0][0] for k in engine._exec_cache._built if isinstance(k[0], tuple)} >= {"mesh", "sr_tiled_mesh"}
    service = RestoratorService(engine=engine, serving_config=cfg, device="cpu")
    rng = np.random.default_rng(6)
    for i in range(3):
        img = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        result = service.restore(imageio.encode_jpeg(img, quality=60 + 10 * i), options={"model": FAMILY})
        assert result["success"], result.get("error")
    engine.sr_tiled(rng.integers(0, 256, (96, 96, 3), dtype=np.uint8), "sr-x2", tile=96)
    assert engine.compile_count == builds, "a warmed mesh surface was built in a request"


def _slots(devices, **axes) -> Mesh:
    shape = tuple(axes.get(a, 1) for a in ("data", "tensor", "spatial", "pipe"))
    slots = np.empty(len(devices), dtype=object)
    slots[:] = devices
    return Mesh(slots.reshape(shape))


def _cuda(*indices):
    return [torch.device("cuda", i) for i in indices]


@pytest.mark.parametrize(
    "devices,axes,rows,grid,spatial",
    [
        (_cuda(0, 0, 0, 0, 0, 0, 0, 0), dict(data=4, tensor=2), (0, 0, 0, 0), 0, 0),
        (_cuda(0, 1, 2, 3), dict(data=4), (0, 1, 2, 3), None, 0),
        (_cuda(0, 1, 0, 1), dict(data=2, tensor=2), (None, None), None, 0),
        (_cuda(0, 1), dict(spatial=2), (0,), 0, None),
    ],
    ids=["one-device", "distinct-rows", "tensor-row-over-two-cards", "spatial-over-two-cards"],
)
def test_capture_plan_from_the_layout(devices, axes, rows, grid, spatial):
    """Every slot a program touches on one device, or None: decided from
    the layout alone (no card is touched)."""
    dev = lambda i: None if i is None else torch.device("cuda", i)  # noqa: E731
    plan = capture_plan(_slots(devices, **axes))
    assert plan.rows == tuple(dev(i) for i in rows)
    assert plan.grid == dev(grid) and plan.spatial == dev(spatial)


def _u8(img01: np.ndarray) -> np.ndarray:
    return np.clip(np.round(img01 * 255.0), 0, 255).astype(np.uint8)


def _jpeg15(size: int) -> np.ndarray:
    """A quality-15 JPEG of a clean canvas: fires deblock."""
    clean = ood_clean(np.random.default_rng(0), 1, size)[0]
    return imageio.decode_image(imageio.encode_jpeg(_u8(clean), quality=15)).pixels


def test_segment_major_equals_slot_after_slot():
    """Two data rows whose shards take different stage branches (a
    quality-15 JPEG in one, a clean image in the other): the segment-major
    executable gives the bytes, scores and fire flags of running the
    program on each row's shard in turn."""
    size = 128  # the smallest bucket where both stages apply
    cfg = ServingConfig(size_buckets=(size,), max_batch=2, restore_egress="rgb")
    engine = RestorationEngine(serving_config=cfg, mesh=cpu_mesh(data=2))
    canvas = np.stack([_jpeg15(size), _u8(ood_clean(np.random.default_rng(2), 1, size)[0])])
    is_jpeg = np.asarray([1.0, 0.0], np.float32)
    valid = np.tile(np.asarray([[size, size]], np.int32), (2, 1))
    args = (torch.from_numpy(canvas), torch.from_numpy(valid), torch.from_numpy(is_jpeg))
    program = engine._program(FAMILY, "rgb")
    got = engine._mesh_executable(FAMILY, program, args, "rgb")(args)
    want = []
    for i, replica in enumerate(engine._data_replicas(FAMILY)):
        fires: dict = {}
        out, scores = program(replica, *(a[i : i + 1] for a in args), fires=fires)
        want.append((out, scores, fire_flags(fires, 1, CPU)))
    for j in range(3):
        assert torch.equal(got[j], torch.cat([w[j] for w in want]))
    assert got[2][0, 0] == 1 and got[2][1, 0] == 0, f"the rows should take different branches: {got[2]}"


def test_mesh_engine_matches_the_reference_mesh_engine(cpu_devices):
    """The same canvases through the reference's mesh engine (data=4 x
    tensor=2 on the virtual CPU devices) and the port's (CPU slots), on the
    shipped weights in f32: mean |delta| < 1 level, scores within 1e-4,
    and ``compile_count`` moving alike over the same calls."""
    import jax
    import jax.numpy as jnp

    from image_restoration_platform_tpu.config import ServingConfig as JServingConfig
    from image_restoration_platform_tpu.parallel import make_mesh as jmake_mesh
    from image_restoration_platform_tpu.serve import RestorationEngine as JEngine

    jengine = JEngine(mesh=jmake_mesh(data=4, tensor=2, spatial=1), compute_dtype=jnp.float32,
                      serving_config=JServingConfig(size_buckets=(32,), max_batch=8))
    engine = RestorationEngine(dtype=torch.float32, serving_config=ServingConfig(size_buckets=(32,), max_batch=8),
                               mesh=cpu_mesh(data=4, tensor=2))
    canvas = np.random.default_rng(8).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    moves = {"reference": [], "port": []}
    for batch in (canvas, canvas, canvas[:1]):
        with jax.default_matmul_precision("highest"):
            before = jengine.compile_count
            ref_out, ref_scores, _ = jengine.restore_batch(batch, family_name=FAMILY)
            moves["reference"].append(jengine.compile_count - before)
        before = engine.compile_count
        out, scores, _ = engine.restore_batch(batch, family_name=FAMILY)
        moves["port"].append(engine.compile_count - before)
        np.testing.assert_allclose(scores, ref_scores, atol=1e-4)
        assert np.mean(np.abs(out.astype(int) - ref_out.astype(int))) < 1.0
    assert moves["port"] == moves["reference"] == [1, 0, 0], moves


def _train_config() -> TrainConfig:
    return TrainConfig(family=FAMILY, batch_size=4, image_size=32, compute_dtype=torch.float32, total_steps=100,
                       warmup_steps=2, seed=3, anchor_comp=0.5)


@pytest.mark.parametrize("axes", [dict(data=2), dict(data=2, tensor=2)], ids=["data2", "data2-tensor2"])
def test_mesh_trainer_steps_through_its_executable(axes):
    """``Trainer.train_step`` on a mesh builds one step executable keyed
    with the mesh's shape (and one data draw), nothing more on later steps,
    writes every gradient in place (the storage a step leaves is the one
    the next step writes), and equals the unsharded trainer's steps at
    tests/test_torch_mesh_train.py's bars."""
    cfg = _train_config()
    n = 1
    for size in axes.values():
        n *= size
    plain = Trainer(cfg, device="cpu")
    meshed = Trainer(cfg, mesh=make_mesh([CPU] * n, **axes))

    def grads(trainer):
        return [p.grad for p in trainer.state.model.parameters()] + [
            p.grad for r in trainer.state.copies for p in r.parameters()]

    losses, storage = [], None
    for step in range(3):
        lp = float(plain.train_step(plain.next_batch()))
        lm = float(meshed.train_step(meshed.next_batch()))
        losses.append((lm, lp))
        held = [g.data_ptr() for g in grads(meshed)]
        assert storage is None or held == storage, f"step {step} reallocated gradients"
        storage = held
    for lm, lp in losses:
        assert abs(lm - lp) <= 1e-6 * abs(lp), losses
    params_p = dict(plain.state.model.named_parameters())
    assert max(float((p.detach() - params_p[k].detach()).abs().max())
               for k, p in meshed.state.model.named_parameters()) <= 1e-6
    step_keys = [k for k in meshed._exec_cache._built if k[0] == "train"]
    assert len(step_keys) == 1 and tuple(meshed.mesh.shape.items()) in step_keys[0]
    assert meshed.exec_stats() == {"compile_count": 2, "executables": 2, "graphs": 0, "eager_executables": 0}
    assert (len(meshed.state.copies) > 0) == ("tensor" in axes)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_mesh_graphs_equal_eager_on_the_card(card):
    """On the card: a data=2 x tensor=2 mesh over one card replays its rows'
    graphs segment-major and gives the eager twin's bytes on a batch whose
    rows take different branches."""
    size = 128
    cfg = ServingConfig(size_buckets=(size,), max_batch=4, restore_egress="rgb")
    mesh = make_mesh([card] * 4, data=2, tensor=2)
    engine = RestorationEngine(dtype=torch.float32, serving_config=cfg, mesh=mesh)
    twin = RestorationEngine(dtype=torch.float32, serving_config=cfg, mesh=mesh, param_cache=engine.params_cache,
                             eager=True)
    clean = ood_clean(np.random.default_rng(2), 3, size)
    canvas = np.stack([_jpeg15(size), *(_u8(c) for c in clean)])
    is_jpeg = np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)
    got = engine.restore_batch(canvas, is_jpeg=is_jpeg, family_name=FAMILY)
    want = twin.restore_batch(canvas, is_jpeg=is_jpeg, family_name=FAMILY)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    stats = engine.exec_stats()
    assert stats["graphs"] > 0 and stats["eager_executables"] == 0 and twin.exec_stats()["graphs"] == 0


@pytest.mark.cuda
def test_mesh_layouts_over_distinct_cards(card):
    """On two or more cards: data rows on distinct cards replay each its own
    graphs and equal the eager twin; rows whose tensor slots span two cards,
    and a train step whose slots do, run eagerly by the layout plan and are
    reported in ``exec_stats``."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    cards = [torch.device("cuda", i) for i in range(min(4, torch.cuda.device_count()))]
    size = 128
    cfg = ServingConfig(size_buckets=(size,), max_batch=4, restore_egress="rgb")
    canvas = np.stack([_jpeg15(size), *(_u8(c) for c in ood_clean(np.random.default_rng(2), 3, size))])
    is_jpeg = np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)
    for devices, axes, eager_rows in ((cards, dict(data=len(cards)), 0), (cards[:2] * 2, dict(data=2, tensor=2), 2)):
        mesh = make_mesh(devices, **axes)
        engine = RestorationEngine(dtype=torch.float32, serving_config=cfg, mesh=mesh)
        twin = RestorationEngine(dtype=torch.float32, serving_config=cfg, mesh=mesh, param_cache=engine.params_cache,
                                 eager=True)
        got = engine.restore_batch(canvas, is_jpeg=is_jpeg, family_name=FAMILY)
        want = twin.restore_batch(canvas, is_jpeg=is_jpeg, family_name=FAMILY)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert engine.exec_stats()["eager_executables"] == eager_rows, (axes, engine.exec_stats())
    trainer = Trainer(dataclasses.replace(_train_config(), batch_size=4), mesh=make_mesh(cards[:2], data=2))
    loss = trainer.train_step(trainer.next_batch())
    assert torch.isfinite(loss) and trainer.exec_stats()["eager_executables"] == 1
