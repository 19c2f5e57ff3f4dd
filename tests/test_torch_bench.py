"""PyTorch port: the benchmark entry (``python -m
image_restoration_platform_tpu_torch.bench``) on the CPU, at small sizes.

The headline line parses and has every key the card's run reports; without
a card the entry raises unless given ``--device cpu``; a failing section
fails the run. The model-FLOP count behind ``mfu`` (FlopCounterMode over the
canonical program, deblock and deblur off) is held to XLA's
``cost_analysis`` of the reference's canonical program at 256 b1 (unfolded,
stages off) within 5 %: the port counts 2.7 % more (XLA counts a SAME
convolution's taps over the padding as no work, and the 16 x 16 bottleneck
loses ~8 % of its taps that way; it also counts the GroupNorm and
elementwise work FlopCounterMode does not). The 4 N H T^2 D the entry adds
per launch of the attention kernel is what the counter counts for the plain
attention."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from image_restoration_platform_tpu_torch import bench
from image_restoration_platform_tpu_torch.config import ServingConfig
from image_restoration_platform_tpu_torch.ops.cuda.attention import attention_reference
from image_restoration_platform_tpu_torch.serve import RestorationEngine, RestoratorService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--size", "64", "--batch", "2", "--warm", "1", "--single", "2", "--batched", "1",
         "--chain", "3"]
FLOPS_REL_BAR = 0.05


def _run(args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "image_restoration_platform_tpu_torch.bench", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=600)


def test_bench_headline_on_the_cpu():
    out = _run(SMALL)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout  # the headline is stdout's only line
    head = json.loads(lines[0])
    assert head["metric"] == "images_per_sec_per_chip_64px_single_restore_e2e"
    assert head["unit"] == "images/sec/chip" and head["value"] > 0
    assert head["vs_baseline"] == pytest.approx(head["value"] / bench.CPU_BASELINE_IMAGES_PER_SEC, abs=0.01)
    detail = head["detail"]
    assert detail["platform"] == "cpu" and detail["dtype"] == "float32"
    assert detail["baseline"]["images_per_sec"] == 0.0454 and "1-core CPU" in detail["baseline"]["what"]
    for key in ("p50_ms", "p95_ms", "batched_images_per_sec_per_chip", "device_step_ms", "device_ms_per_image_b2",
                "model_flops_per_step"):
        assert detail[key] > 0, key
    assert 1.0 <= detail["batched_mean_batch"] <= 2.0
    assert detail["mfu"] is None and detail["peak_flops"] is None  # no peak is known for a CPU
    assert detail["validity"]["status"] == "CPU"
    assert detail["launches"] == {"flash_attention": 0, "blend_tiles": 0}  # the CPU runs the plain versions
    assert set(detail["families"]) == {"restore-unet-small", "diffusion-restore", "sr-x2-direct", "sr-x2-tiled-256",
                                       "fusion-k3"}
    assert all(v["cold_ms"] > 0 and v["warm_ms"] > 0 for v in detail["families"].values())
    assert "device-only 64px b2" in out.stderr and "family fusion-k3" in out.stderr


def test_bench_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    out = _run([])
    assert out.returncode != 0 and out.stdout == ""
    assert "device='cpu'" in out.stderr


def test_a_failing_section_fails_the_run(monkeypatch):
    monkeypatch.setattr(RestoratorService, "restore", lambda self, *a, **k: {"success": False, "error": "boom"})
    with pytest.raises(RuntimeError, match="boom"):
        bench.main(SMALL)


def test_model_flops_against_xla_canonical_count():
    import jax

    from image_restoration_platform_tpu.config import ServingConfig as JServingConfig
    from image_restoration_platform_tpu.serve import RestorationEngine as JRestorationEngine

    canvas = np.random.default_rng(0).integers(0, 256, (1, 256, 256, 3), dtype=np.uint8)
    valid = np.asarray([[256, 256]], np.int32)
    jpeg = np.ones((1,), np.float32)
    jengine = JRestorationEngine(serving_config=JServingConfig(
        size_buckets=(256,), max_batch=1, fold_w=False, deblur=False, deblock=False))
    jengine.restore_batch(canvas, valid, jpeg, "restore-unet")
    key = next(k for k in jengine._compiled if isinstance(k, tuple) and k[0] == "restore-unet")
    analysis = jengine._compiled[key].cost_analysis()
    xla = (analysis[0] if isinstance(analysis, list) else analysis)["flops"]
    assert jax.devices()[0].platform == "cpu"

    engine = RestorationEngine(device="cpu", serving_config=ServingConfig(size_buckets=(256,), max_batch=1))
    flops, attention = bench.model_flops(engine, torch.from_numpy(canvas), torch.from_numpy(valid),
                                         torch.from_numpy(jpeg))
    assert attention == 0.0  # on the CPU the counter sees the plain attention itself
    assert abs(flops / xla - 1.0) <= FLOPS_REL_BAR, (flops, xla)


def test_attention_flops_formula_is_what_the_counter_counts():
    from torch.utils.flop_counter import FlopCounterMode

    n, h, t, d = 1, 4, 1024, 64
    q, k, v = (torch.randn(n, h, t, d) for _ in range(3))
    with FlopCounterMode(display=False) as counter:
        attention_reference(q, k, v)
    assert counter.get_total_flops() == 4 * n * h * t * t * d
