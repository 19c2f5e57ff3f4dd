"""PyTorch port: the engine's executable tier (serve/exec_cache.py) on the CPU.

Counterpart of tests/test_engine_compile.py. On the CPU nothing is captured:
an executable is the program's segments run eagerly under the same key, so
these tests hold the key, the single-flight gate, ``compile_count``, the
warm-up's coverage and the segments' branch selection; the CUDA graphs are
held to eager execution on the card (chip_smoke.py). Also here: the
segmented restore and HDR programs give the bytes of the unsegmented stage
functions, on batches that fire every stage and on batches that fire none,
and the launch counts of a captured graph are replayed (the plain attention
stands in for the kernel on the CPU)."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from image_restoration_platform_tpu_torch import imageio
from image_restoration_platform_tpu_torch.classify.fused import batch_classify_and_condition
from image_restoration_platform_tpu_torch.config import ServingConfig
from image_restoration_platform_tpu_torch.obs.metrics import get_counters
from image_restoration_platform_tpu_torch.ops import deblock, deblur
from image_restoration_platform_tpu_torch.ops.cuda import attention
from image_restoration_platform_tpu_torch.ops.cuda.attention import flash_kernel
from image_restoration_platform_tpu_torch.serve import RestorationEngine
from image_restoration_platform_tpu_torch.serve.exec_cache import ExecCache, LaunchDelta
from image_restoration_platform_tpu_torch.serve.programs import build_hdr_deblur_program, build_restore_program
from image_restoration_platform_tpu_torch.train.ood import ood_clean

FAMILY = "restore-unet-small"
SIZE = 128  # the smallest bucket where both stages apply (deblur needs 128)


def _u8(img01: np.ndarray) -> np.ndarray:
    return np.clip(np.round(img01 * 255.0), 0, 255).astype(np.uint8)


def _fft_convolve(x: np.ndarray, psf: np.ndarray) -> np.ndarray:
    h, w = x.shape[:2]
    pad = np.zeros((h, w), np.float32)
    pad[: psf.shape[0], : psf.shape[1]] = psf
    otf = np.fft.rfft2(np.roll(pad, (-(psf.shape[0] // 2), -(psf.shape[1] // 2)), axis=(0, 1)))
    return np.stack([np.fft.irfft2(np.fft.rfft2(x[..., c]) * otf, s=(h, w)) for c in range(3)], -1)


def _clean(seed: int) -> np.ndarray:
    return ood_clean(np.random.default_rng(seed), 1, SIZE)[0]


def _blocky(seed: int) -> np.ndarray:
    """A quality-10 JPEG: fires deblock."""
    return imageio.decode_image(imageio.encode_jpeg(_u8(_clean(seed)), quality=10)).pixels


def _motion(seed: int) -> np.ndarray:
    """A 9-pixel motion blur, as chip_smoke.py makes one: fires the veto's
    gate and deblur."""
    return _u8(np.clip(_fft_convolve(_clean(seed), deblur.motion_psf(9.0, 1.1)), 0, 1))


BATCHES = {  # (canvas, is_jpeg) at SIZE
    "clean": lambda: (np.stack([_u8(_clean(1)), _u8(_clean(2))]), np.zeros(2, np.float32)),
    "blocky": lambda: (np.stack([_blocky(0), _u8(_clean(4))]), np.asarray([1.0, 0.0], np.float32)),
    "motion": lambda: (np.stack([_motion(1), _u8(_clean(5))]), np.zeros(2, np.float32)),
    "both": lambda: (np.stack([_blocky(3), _motion(6)]), np.asarray([1.0, 0.0], np.float32)),
}


def _engine(**config) -> RestorationEngine:
    return RestorationEngine(device="cpu", serving_config=ServingConfig(size_buckets=(32, SIZE), max_batch=2,
                                                                         **config))


def test_concurrent_requests_build_once():
    """Six concurrent identical requests build one executable, with equal
    outputs (thread switches forced often)."""
    engine = _engine()
    imgs = np.random.default_rng(0).integers(0, 255, (1, 32, 32, 3)).astype(np.uint8)
    results, errors = [], []

    def worker():
        try:
            out, _, _ = engine.restore_batch(imgs, family_name=FAMILY)
            results.append(out)
        except Exception as error:  # pragma: no cover
            errors.append(error)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(results) == 6
    assert engine.compile_count == 1
    for out in results[1:]:
        np.testing.assert_array_equal(out, results[0])


def test_single_flight_builds_each_key_once_and_survives_a_failed_build():
    """More threads than cores ask for two keys: each key's build runs once;
    a build that raises hands the key to a waiting thread."""
    cache = ExecCache()
    calls = {"a": 0, "b": 0}
    lock = threading.Lock()

    def build(key):
        def run():
            with lock:
                calls[key] += 1
                first = calls[key] == 1
            time.sleep(0.02)
            if key == "b" and first:
                raise RuntimeError("the first build of b fails")
            return f"exe-{key}"
        return run

    got, errors = [], []

    def worker(key):
        try:
            got.append((key, cache.get(key, build(key))))
        except RuntimeError as error:
            errors.append(error)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=("ab"[i % 2],)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert calls == {"a": 1, "b": 2}
    assert len(errors) == 1 and len(got) == 31
    assert all(exe == f"exe-{key}" for key, exe in got)
    assert cache.compile_count == 2 and cache.stats() == {"executables": 2, "graphs": 0}


def test_warmup_serving_covers_every_surface():
    """After warmup_serving no surface builds in a request, including
    batches that fire deblock and deblur (the warm-up's zero images fire
    nothing, so the branches must have been built whatever they fire)."""
    engine = _engine()
    report = engine.warmup_serving(
        families=(FAMILY, "diffusion-restore", "sr-x2", "fusion"), sr_tiled_canvas=96, fusion_k=(3,)
    )
    tags = set(report)
    for size in (32, SIZE):
        assert {f"{FAMILY}/restore/{size}/b1", f"{FAMILY}/restore/{size}/b2"} <= tags
        assert {f"diffusion-restore/restore/{size}/b1", f"diffusion-restore/restore/{size}/b2"} <= tags
        assert {f"sr-x2/direct/{size}", f"fusion/k3/{size}"} <= tags
    assert {"sr-x2/tiled-rgb/96", "sr-x2/tiled-yuv420/96"} <= tags
    builds = engine.compile_count
    assert builds == engine.exec_stats()["executables"]

    before = get_counters().snapshot()
    rng = np.random.default_rng(1)
    img32 = rng.integers(0, 255, (1, 32, 32, 3)).astype(np.uint8)
    vhw = np.asarray([[32, 32]], np.int32)
    engine.restore_batch(img32, vhw, np.zeros((1,), np.float32), FAMILY)
    engine.restore_batch(np.repeat(img32, 2, axis=0), family_name=FAMILY)
    engine.restore_batch(img32, vhw, np.zeros((1,), np.float32), "diffusion-restore")
    for name in ("clean", "blocky", "motion", "both"):
        canvas, is_jpeg = BATCHES[name]()
        engine.restore_batch(canvas, is_jpeg=is_jpeg, family_name=FAMILY)
        engine.restore_batch(canvas[:1], is_jpeg=is_jpeg[:1], family_name=FAMILY)
    canvas, is_jpeg = BATCHES["both"]()
    engine.restore_batch(canvas, is_jpeg=is_jpeg, family_name="diffusion-restore")
    if imageio.native_available():  # the restorator's plane egress
        engine.restore_batch(canvas, is_jpeg=is_jpeg, family_name=FAMILY, egress="yuv420")
    engine.sr_batch(img32, "sr-x2")
    engine.sr_batch(canvas[:1], "sr-x2")
    canvas96 = rng.integers(0, 255, (96, 96, 3)).astype(np.uint8)
    engine.sr_tiled(canvas96, "sr-x2", tile=96)
    engine.sr_tiled(canvas96, "sr-x2", tile=96, output="yuv420")
    engine.fuse_batch(np.repeat(img32, 3, axis=0), np.tile(vhw, (3, 1)), np.zeros((3,), np.float32))
    engine.fuse_batch(np.repeat(canvas[:1], 3, axis=0), np.tile([[SIZE, SIZE]], (3, 1)), np.ones(3, np.float32))
    assert engine.compile_count == builds, "a warmed surface was built in a request"
    after = get_counters().snapshot()
    for stage in ("deblock", "deblur_veto", "deblur"):
        assert after.get(f"stage_fires.{stage}", 0) > before.get(f"stage_fires.{stage}", 0), stage


def test_exec_key_differs_across_stages_and_egress():
    """The key changes with each gated stage (they add or remove segments)
    and with the egress, for the same tag and arguments."""
    args = (torch.zeros((2, 32, 32, 3), dtype=torch.uint8), torch.zeros((2, 2), dtype=torch.int32),
            torch.zeros((2,)))
    keys = set()
    for deblur_on in (False, True):
        for deblock_on in (False, True):
            engine = _engine(deblur=deblur_on, deblock=deblock_on)
            for egress in ("rgb", "yuv420", "f32"):
                keys.add(engine._exec_key(FAMILY, args, egress))
    assert len(keys) == 12
    key = _engine()._exec_key(FAMILY, args, "rgb")
    assert key[0] == FAMILY and ("stages", True, True) in key and ("egress", "rgb") in key
    assert ((2, 32, 32, 3), "torch.uint8") in key


def _unsegmented(model, canvas, valid, is_jpeg):
    """The restore program of the stage functions as one call each, the
    host branches inside them (RGB IO and egress)."""
    with torch.inference_mode():
        fires: dict = {}
        scores, cond = batch_classify_and_condition(canvas.float(), valid, is_jpeg)
        c, stage_scores, cond = deblock.deblock_and_recondition(canvas, valid, is_jpeg, scores, cond, fires)
        c, cond = deblur.deblur_and_recondition(c, valid, is_jpeg, stage_scores, cond, fires)
        out = torch.clamp(model(c.to(torch.float32) / 255.0, cond).float(), 0.0, 1.0)
    return torch.round(out * 255.0).to(torch.uint8), scores, fires


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_segmented_restore_program_equals_the_unsegmented_stages(batch):
    """Four segments split at the three decisions, the branch of each taken
    by its host flag: the same bytes, scores and fire masks as the stage
    functions called whole, on batches that fire each stage or none."""
    engine = _engine()
    model = engine.model(FAMILY, folded=False)
    program = build_restore_program(FAMILY, dtype=torch.float32, use_s2d_io=False, use_deblur=True,
                                    use_deblock=True)
    canvas, is_jpeg = BATCHES[batch]()
    args = (torch.from_numpy(canvas), torch.from_numpy(np.full((2, 2), SIZE, np.int32)), torch.from_numpy(is_jpeg))
    segments = program.segments(model, args)
    assert [s.decision for s in segments] == [None, "deblock", "deblur_veto", "deblur"]
    assert program.outputs == ("out", "scores", "flags")

    before = get_counters().snapshot()
    fires: dict = {}
    out, scores = program(model, *args, fires=fires)
    syncs = {k: v - before.get(k, 0) for k, v in get_counters().snapshot().items() if k.startswith("host_syncs.")}
    ref_out, ref_scores, ref_fires = _unsegmented(model, *args)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    torch.testing.assert_close(scores, ref_scores, rtol=0, atol=0)
    assert set(fires) == set(ref_fires) == {"deblock", "deblur_veto", "deblur"}
    for name in fires:
        torch.testing.assert_close(fires[name], ref_fires[name], rtol=0, atol=0)
    assert syncs == {"host_syncs.deblock": 1, "host_syncs.deblur_veto": 1, "host_syncs.deblur": 1}
    expected = {"clean": (0, 0), "blocky": (1, 0), "motion": (0, 1), "both": (1, 1)}[batch]
    assert (int(fires["deblock"].sum()), int(fires["deblur"].sum())) == expected

    # every firing branch forced gives the same outputs: a skip branch only skips work
    _, picked = program.run(model, args)
    state = dict(zip(program.inputs, args))
    with torch.inference_mode():
        for segment in segments:
            state = {**state, **segment.run(state, True)}
    for name, value in zip(program.outputs, picked):
        torch.testing.assert_close(state[name], value, rtol=0, atol=0)


@pytest.mark.parametrize("blur", ["none", "disk"])
def test_segmented_hdr_program_equals_deblur_canvas_f32(blur):
    """The HDR pre-pass as two segments (the veto between) gives
    ``deblur_canvas_f32``'s floats, firing (a defocus disk) or not."""
    x = _clean(11)
    if blur == "disk":
        x = np.clip(_fft_convolve(x, deblur.disk_psf(2.5)), 0, 1).astype(np.float32)
    x = torch.from_numpy(np.ascontiguousarray(x[None], np.float32))
    valid = torch.tensor([[SIZE, SIZE]], dtype=torch.int32)
    comp = torch.zeros(1)
    program = build_hdr_deblur_program()
    assert [s.decision for s in program.segments(None, (x, valid, comp))] == [None, "deblur_veto"]
    got = program(None, x, valid, comp)
    ref = deblur.deblur_canvas_f32(x, valid, comp)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert bool((got != x).any()) == (blur == "disk")


def test_launch_delta_replays_what_a_capture_counted():
    """A capture's launches are taken back and replayed on every replay,
    by variant too."""
    before = flash_kernel.launches, dict(flash_kernel.launches_by_variant)
    delta = LaunchDelta()
    flash_kernel.launches += 2  # what a capture of two forwards counts
    flash_kernel.launches_by_variant["wgmma_q64"] += 2
    delta.close()
    assert (flash_kernel.launches, flash_kernel.launches_by_variant) == before
    delta.replay()
    delta.replay()
    assert flash_kernel.launches == before[0] + 4
    assert flash_kernel.launches_by_variant["wgmma_q64"] == before[1]["wgmma_q64"] + 4


def test_one_attention_call_per_unet_forward_through_the_cache(monkeypatch):
    """Through the executables, each restore batch calls attention once and
    each diffusion batch once a sampler step (the plain version, which the
    wrapper takes on the CPU, stands in for the kernel's launch)."""
    calls = []
    plain = attention.attention_reference
    monkeypatch.setattr(attention, "attention_reference", lambda *a: calls.append(1) or plain(*a))
    engine = _engine()
    engine.warmup(FAMILY, sizes=(32,))
    canvas, is_jpeg = BATCHES["both"]()
    builds = engine.compile_count
    calls.clear()
    engine.restore_batch(np.zeros((2, 32, 32, 3), np.uint8), family_name=FAMILY)
    engine.restore_batch(np.zeros((1, 32, 32, 3), np.uint8), family_name=FAMILY)
    assert len(calls) == 2 and engine.compile_count == builds
    calls.clear()
    engine.restore_batch(canvas, is_jpeg=is_jpeg, family_name="diffusion-restore")
    assert len(calls) == 2  # sample_steps


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_replay_equals_eager_and_writes_only_its_own_memory(card):
    """On the card: the captured segments give the eager program's bytes on
    firing and non-firing batches, and replaying them leaves alone memory
    allocated after the build (every static buffer stays owned by its
    executable, including those a later segment replaces in the state)."""
    cfg = ServingConfig(size_buckets=(SIZE,), max_batch=2)
    engine = RestorationEngine(device=card, dtype=torch.float32, serving_config=cfg)
    twin = RestorationEngine(device=card, dtype=torch.float32, serving_config=cfg, param_cache=engine.params_cache,
                             eager=True)
    engine.warmup(FAMILY)
    canaries = [torch.full((n,), 7.0, device=card) for n in (1, 7, 28, 64, 1000, 4096, 65536) for _ in range(8)]
    for name in ("clean", "blocky", "motion", "both"):
        canvas, is_jpeg = BATCHES[name]()
        got = engine.restore_batch(canvas, is_jpeg=is_jpeg, family_name=FAMILY)
        want = twin.restore_batch(canvas, is_jpeg=is_jpeg, family_name=FAMILY)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    torch.cuda.synchronize()
    assert all(bool((c == 7.0).all()) for c in canaries)
    assert engine.exec_stats()["graphs"] > 0 and twin.exec_stats()["graphs"] == 0


@pytest.mark.cuda
def test_folded_graphs_equal_eager(card):
    """On the card: the W-folded modules (``fold_w``, ``fold_w_sr``) capture
    into the CUDA graphs as the unfolded ones do. Every folded surface the
    warm-up built gives its eager twin's bytes and kernel launches, and
    serving them builds nothing."""
    from image_restoration_platform_tpu_torch.models.folded import FoldedSRNet, FoldedUNet
    from image_restoration_platform_tpu_torch.ops.cuda.blend import blend_kernel

    cfg = ServingConfig(size_buckets=(SIZE,), max_batch=2, fold_w=True, fold_w_sr=True)
    engine = RestorationEngine(device=card, dtype=torch.float32, serving_config=cfg)
    twin = RestorationEngine(device=card, dtype=torch.float32, serving_config=cfg, param_cache=engine.params_cache,
                             eager=True)
    engine.warmup_serving(families=(FAMILY, "sr-x2", "fusion"), sr_tiled_canvas=256)
    builds = engine.compile_count
    assert isinstance(engine.model(FAMILY), FoldedUNet) and isinstance(engine.model("sr-x2"), FoldedSRNet)
    canvas, is_jpeg = BATCHES["both"]()
    surfaces = {
        "restore": lambda e: e.restore_batch(canvas, is_jpeg=is_jpeg, family_name=FAMILY)[:2],
        "sr": lambda e: e.sr_batch(canvas[:1], "sr-x2")[:1],
        "sr_tiled": lambda e: e.sr_tiled(np.tile(canvas[0], (2, 2, 1)), "sr-x2", tile=256)[:1],
        "fusion": lambda e: e.fuse_batch(np.repeat(canvas[:1], 3, axis=0), np.tile([[SIZE, SIZE]], (3, 1)),
                                         np.zeros(3, np.float32), "restore-unet")[:2],
    }
    for name, run in surfaces.items():
        counts = []
        outs = []
        for e in (engine, twin):
            flash_kernel.launches = blend_kernel.launches = 0
            outs.append(run(e))
            counts.append((flash_kernel.launches, blend_kernel.launches))
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert counts[0] == counts[1], (name, counts)
    assert engine.compile_count == builds and engine.exec_stats()["graphs"] > 0
