"""PyTorch port: SwinIR (models/swinir.py) and its window attention
(ops/cuda/window_attention.py) against the benchmark's plain float32
reference (benchmark/reference/swinir.py, loaded by its path as the
benchmark loads it), on the CPU at small sizes; the SR path taking the
family by its kind; and, under the ``cuda`` marker, the kernel against its
plain version and its launches on the tiled path.

Bars: f32 port against f32 reference 1e-4 (the same operations in the same
order, but the mask built two ways); a served job within 1 level of the
reference's tiled upscale, both JPEGs decoded alike; on the card bf16
``bf16_parity_bar`` (the flash attention kernel's bar)."""

from __future__ import annotations

import base64
import copy
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from image_restoration_platform_tpu_torch.config import ServingConfig
from image_restoration_platform_tpu_torch.models import (
    ModelFamily,
    SwinIR,
    SwinIRConfig,
    get_family,
    is_sr_family,
    register,
    registry,
)
from image_restoration_platform_tpu_torch.models import weights as W
from image_restoration_platform_tpu_torch.models.folded import folded_model
from image_restoration_platform_tpu_torch.ops.cuda import attention as A
from image_restoration_platform_tpu_torch.ops.cuda import window_attention as WA
from image_restoration_platform_tpu_torch.serve import RestorationEngine
from image_restoration_platform_tpu_torch.serve.engine import uses_folded

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(embed_dim=24, depths=(2, 2), num_heads=(2, 2), num_feat=16)
# the served job's network: one RSTB of a plain and a shifted layer, one head
JOB = dict(embed_dim=12, depths=(2,), num_heads=(1,), num_feat=8)


def _arch(widths: dict) -> dict:
    """The reference's architecture keys of a SwinIRConfig of ``widths``
    on the tiled surface."""
    return {"scale": 2, "in_channels": 3, "window_size": 8, "mlp_ratio": 2.0, "img_range": 1.0,
            "rgb_mean": [0.4488, 0.4371, 0.4040], "patch_norm": True, "tile": 256, "overlap": 32,
            "tile_batch": 8, "tiled_canvas": 2048, "direct_max": 512,
            **{k: list(v) if isinstance(v, tuple) else v for k, v in widths.items()}}


TINY_ARCH = _arch(TINY)


def _reference():
    from benchmark import spec

    return spec.load_reference("swinir")


def _published_arch() -> dict:
    with open(os.path.join(REPO, "benchmark", "configs", "swinir-m-x2.json")) as f:
        return json.load(f)["arch"]


def _params(arch: dict, seed: int):
    """(the port's state dict, the reference's OIHW tensors) of ``init``."""
    flat = _reference().init(arch, seed)
    ref = {k: torch.from_numpy(np.ascontiguousarray(v.transpose(3, 2, 0, 1) if v.ndim == 4 else v))
           for k, v in flat.items()}
    return W.params_from_jax(flat), ref


@pytest.fixture
def scratch_registry(monkeypatch):
    monkeypatch.setattr(registry, "_FAMILIES", dict(registry._FAMILIES))


@pytest.mark.parametrize("size", [(32, 32), (40, 40), (36, 44)], ids=["32", "40", "36x44-padded"])
def test_port_matches_reference(size):
    state, ref_params = _params(TINY_ARCH, 3)
    model = SwinIR(SwinIRConfig(scale=2, **TINY)).eval()
    model.load_state_dict(state, strict=True)
    assert {b.shift for layer in model.layers for b in layer.blocks} == {0, 4}
    x = torch.rand((2, *size, 3), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        got, want = model(x), _reference().network(ref_params, TINY_ARCH, x)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 2 * size[0], 2 * size[1], 3)
    assert float((got - want).abs().max()) <= 1e-4
    assert float(want.std()) > 0.01  # the network, not a flat plate


@pytest.mark.parametrize("shift", [0, 4])
def test_plain_window_attention_matches_a_per_window_softmax(shift):
    """The plain version against each window's softmax written out, with
    the table's bias and the published slice-built mask, at windows of the
    first and the last row and column of the shifted grid."""
    ref = _reference()
    gen = torch.Generator().manual_seed(2)
    b, (gh, gw), heads, d = 2, (3, 4), 3, 10
    c = heads * d
    qkv = torch.randn((b * gh * gw, 64, 3 * c), generator=gen)
    table = torch.randn((225, heads), generator=gen)
    got = WA.window_attention_reference(qkv, table, heads, shift, (gh, gw))
    index = ref.relative_position_index(8)
    mask = ref.attention_mask(gh * 8, gw * 8, 8, shift) if shift else torch.zeros(gh * gw, 64, 64)
    assert bool((mask != 0).any()) == bool(shift)
    for w in (0, gw - 1, (gh - 1) * gw, gh * gw - 1, gh * gw + gw + 1, 2 * gh * gw - 1):
        q, k, v = qkv[w].reshape(64, 3, heads, d).unbind(1)
        for h in range(heads):
            logits = q[:, h] @ k[:, h].T / d**0.5 + table[index.reshape(-1), h].reshape(64, 64) + mask[w % (gh * gw)]
            want = torch.softmax(logits, dim=-1) @ v[:, h]
            assert float((got[w, :, h * d:(h + 1) * d] - want).abs().max()) <= 1e-5


def test_published_widths_and_the_npz_layout():
    model = SwinIR()
    assert sum(p.numel() for p in model.parameters()) == 11_752_487
    assert get_family("swinir-m-x2").config == SwinIRConfig()
    state, _ = _params(_published_arch(), 0)
    model.load_state_dict(state, strict=True)
    assert tuple(model.layers[0].blocks[1].attn.relative_position_bias_table.shape) == (225, 6)


def _photo(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 60 * np.sin(xx / (13.0 + 4 * c)) * np.cos(yy / 19.0) for c in range(3)], -1)
    img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90)
    return buf.getvalue()


def test_a_job_through_submit_job_matches_the_reference(scratch_registry, monkeypatch):
    """A tiny SwinIR family served as a deployment serves it: submit_job ->
    the restorator -> engine.sr_tiled (a 640 canvas, 3 x 3 tiles of 256),
    against the reference's tiled upscale of the same upload bytes."""
    from benchmark import drive
    from benchmark.reference import pipeline
    from image_restoration_platform_tpu_torch import imageio
    from image_restoration_platform_tpu_torch.api.submit import submit_job

    monkeypatch.setattr(imageio, "_lib", None)  # the Pillow codec, as on a machine without libjpeg
    monkeypatch.setattr(imageio, "_native_failed", True)
    with open(os.path.join(REPO, "benchmark", "configs", "sr-x2.json")) as f:
        cfg = json.load(f)
    cfg = dict(cfg, family="swinir-tiny-x2", arch=_arch(JOB),
               serving=dict(copy.deepcopy(cfg["serving"]), size_buckets=[256, 512, 640]))
    register(ModelFamily("swinir-tiny-x2", SwinIRConfig(scale=2, **JOB)))
    state, ref_params = _params(cfg["arch"], 5)
    ctx = drive.build_service(cfg, "cpu")
    try:
        ctx.engine.params_cache.put("swinir-tiny-x2", state)
        ctx.user_store.grant("u", 10)
        upload = _photo(450, 600, 4)
        status, body, _ = submit_job(ctx, {"id": "u"}, [("a.jpg", upload)], options={"model": "swinir-tiny-x2"},
                                     sync=True)
        assert status == 200, body
        served = pipeline.decode(base64.b64decode(body["result"]["restoredImage"]))
    finally:
        ctx.shutdown()
    with torch.inference_mode():
        want = pipeline.upscale(upload, cfg, _reference().network, ref_params, "cpu")
    assert served.shape == want.shape == (900, 1200, 3)
    assert np.abs(served.astype(int) - want.astype(int)).max() <= 1


def test_the_sr_path_takes_swinir_by_its_kind(scratch_registry):
    assert is_sr_family("swinir-m-x2") and is_sr_family("sr-x2") and not is_sr_family("restore-unet")
    register(ModelFamily("upscaler", SwinIRConfig(scale=2, **TINY)))  # no "sr-" prefix
    assert is_sr_family("upscaler")
    assert not uses_folded("swinir-m-x2", ServingConfig(fold_w_sr=True))
    assert uses_folded("sr-x2", ServingConfig(fold_w_sr=True))
    engine = RestorationEngine(device="cpu", serving_config=ServingConfig(size_buckets=(32,), max_batch=2))
    up, meta = engine.sr_batch(np.zeros((1, 32, 32, 3), np.uint8), "upscaler")  # random weights
    assert up.shape == (1, 64, 64, 3) and meta["family"] == "upscaler"
    with pytest.raises(ValueError, match="upscaler"):
        engine.sr_spatial(np.zeros((64, 64, 3), np.uint8), "upscaler")
    with pytest.raises(ValueError, match="SwinIR"):
        folded_model(SwinIRConfig(**TINY), {})


def test_the_load_check_refuses_what_the_kernel_does_not_take(scratch_registry):
    registry.check_attention_shapes("swinir-m-x2", (256,), 8, torch.bfloat16)
    register(ModelFamily("swinir-wide-heads", SwinIRConfig(embed_dim=68, depths=(2,), num_heads=(2,))))
    with pytest.raises(ValueError, match="swinir-wide-heads.*head dim of at most 32"):
        registry.check_attention_shapes("swinir-wide-heads", (256,), 8, torch.bfloat16)
    register(ModelFamily("swinir-w12", SwinIRConfig(window_size=12)))
    with pytest.raises(ValueError, match="swinir-w12.*windows of 8 or 16"):
        registry.check_attention_shapes("swinir-w12", (256,), 8, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        WA.window_attention_kernel(torch.zeros(1, 64, 540, dtype=torch.bfloat16), torch.zeros(225, 6), 6, 0, (1, 1))


# ------------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the window attention kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 4])
def test_cuda_kernel_matches_plain_version(cuda_device, shift):
    """SwinIR-M's shape: 8 tiles of 256 = 8 x 32 x 32 windows, 6 heads of
    30 (8,192 x 6 problems of 64 x 64), eager and inside a CUDA graph."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn((8 * 32 * 32, 64, 540), generator=gen, device=cuda_device).to(torch.bfloat16)
    table = torch.randn((225, 6), generator=gen, device=cuda_device) * 0.5
    ref = WA.window_attention_reference(qkv, table, 6, shift, (32, 32))
    eager = WA.window_attention(qkv, table, 6, shift, (32, 32))
    torch.cuda.synchronize()
    assert eager.dtype == torch.bfloat16 and eager.shape == (8192, 64, 180)
    assert float((eager.float() - ref.float()).abs().max()) <= A.bf16_parity_bar(ref)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = WA.window_attention(qkv, table, 6, shift, (32, 32))
    qkv.copy_(torch.randn(qkv.shape, generator=gen, device=cuda_device).to(torch.bfloat16))
    graph.replay()
    torch.cuda.synchronize()
    ref = WA.window_attention_reference(qkv, table, 6, shift, (32, 32))
    assert float((captured.float() - ref.float()).abs().max()) <= A.bf16_parity_bar(ref)


@pytest.mark.cuda
def test_cuda_tiled_call_counts_its_window_attention_launches(cuda_device):
    """One replay of swinir-m-x2's tiled 2048 call: 36 layers x 11 chunks
    of 8 tiles launch the kernel 396 times, counted as the program counter
    ``kernels.launches.window_attention``."""
    from image_restoration_platform_tpu_torch.obs.metrics import get_counters

    engine = RestorationEngine(device="cuda")
    canvas = np.zeros((2048, 2048, 3), np.uint8)
    engine.sr_tiled(canvas, "swinir-m-x2")  # builds the graph
    before = get_counters().snapshot().get("kernels.launches.window_attention", 0.0)
    launches = WA.window_attention_kernel.launches
    out, _ = engine.sr_tiled(canvas, "swinir-m-x2")
    assert out.shape == (4096, 4096, 3)
    assert WA.window_attention_kernel.launches - launches == 396
    assert get_counters().snapshot()["kernels.launches.window_attention"] - before == 396
