"""PyTorch port: HAT (models/hat.py), its overlap attention
(ops/cuda/overlap_attention.py) and the window kernels' plain versions at
windows of 16, against the benchmark's plain float32 reference
(benchmark/reference/hat.py, loaded by its path as the benchmark loads it),
on the CPU at small sizes with HAT's window of 16; the SR path and the
registry taking the family by its kind; and, under the ``cuda`` marker, the
kernels against their plain versions at HAT's shapes and their launches on
the tiled path.

Bars: f32 port against f32 reference 1e-4 (the same operations, in another
order in places: the window layouts, the masks and the key windows built
two ways; 2.5e-7 measured); the plain attentions against a softmax written
out per window 1e-5 (f32 round-off of the same sums); a served job within 1
level of the reference's tiled upscale, both JPEGs decoded alike; on the
card the attentions within ``bf16_parity_bar`` (the flash attention kernel's
bar) of their plain versions, and the add-norm's sums bit for bit and its
norm within one bf16 ulp (the add-norm tests' bar)."""

from __future__ import annotations

import base64
import copy
import io
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from image_restoration_platform_tpu_torch.config import ServingConfig
from image_restoration_platform_tpu_torch.models import HAT, HATConfig, ModelFamily, get_family, register, registry
from image_restoration_platform_tpu_torch.models import weights as W
from image_restoration_platform_tpu_torch.models.folded import folded_model
from image_restoration_platform_tpu_torch.models.hat import CAB
from image_restoration_platform_tpu_torch.ops.cuda import attention as A
from image_restoration_platform_tpu_torch.ops.cuda import overlap_attention as OA
from image_restoration_platform_tpu_torch.ops.cuda import swin_add_norm as SAN
from image_restoration_platform_tpu_torch.ops.cuda import window_attention as WA
from image_restoration_platform_tpu_torch.serve import RestorationEngine
from image_restoration_platform_tpu_torch.serve.engine import uses_folded

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = 1e-5
TINY = dict(embed_dim=24, depths=(2, 2), num_heads=(2, 2), num_feat=16, squeeze_factor=6)
# the served job's network: one RHAG of a plain and a shifted HAB and an OCAB, one head
JOB = dict(embed_dim=12, depths=(2,), num_heads=(1,), num_feat=8, squeeze_factor=6)


def _arch(widths: dict) -> dict:
    """The reference's architecture keys of a HATConfig of ``widths`` on the
    tiled surface."""
    return {"scale": 2, "in_channels": 3, "window_size": 16, "compress_ratio": 3, "squeeze_factor": 30,
            "conv_scale": 0.01, "overlap_ratio": 0.5, "mlp_ratio": 2.0, "img_range": 1.0,
            "rgb_mean": [0.4488, 0.4371, 0.4040], "patch_norm": True, "tile": 256, "overlap": 32, "tile_batch": 8,
            "tiled_canvas": 2048, "direct_max": 512,
            **{k: list(v) if isinstance(v, tuple) else v for k, v in widths.items()}}


TINY_ARCH = _arch(TINY)


def _reference():
    from benchmark import spec

    return spec.load_reference("hat")


def _config() -> dict:
    with open(os.path.join(REPO, "benchmark", "configs", "hat-x2.json")) as f:
        return json.load(f)


def _params(arch: dict, seed: int):
    """(the port's state dict, the reference's OIHW tensors) of ``init``."""
    flat = _reference().init(arch, seed)
    ref = {k: torch.from_numpy(np.ascontiguousarray(v.transpose(3, 2, 0, 1) if v.ndim == 4 else v))
           for k, v in flat.items()}
    return W.params_from_jax(flat), ref


@pytest.fixture
def scratch_registry(monkeypatch):
    monkeypatch.setattr(registry, "_FAMILIES", dict(registry._FAMILIES))


@pytest.mark.parametrize("size", [(32, 32), (48, 48), (48, 32), (40, 36)], ids=["32", "48", "48x32", "40x36-padded"])
def test_port_matches_reference(size):
    state, ref_params = _params(TINY_ARCH, 3)
    model = HAT(HATConfig(scale=2, **TINY)).eval()
    model.load_state_dict(state, strict=True)
    assert {b.shift for layer in model.layers for b in layer.blocks} == {0, 8}
    x = torch.rand((2, *size, 3), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        got, want = model(x), _reference().network(ref_params, TINY_ARCH, x)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 2 * size[0], 2 * size[1], 3)
    assert float((got - want).abs().max()) <= 1e-4
    assert float(want.std()) > 0.01  # the network, not a flat plate


@pytest.mark.parametrize("shift", [0, 8])
def test_plain_window_attention_at_16_matches_a_per_window_softmax(shift):
    """The window kernel's plain version at HAT's window of 16 against each
    window's softmax written out, with the table's bias and the published
    slice-built mask, at windows of the first and last row and column."""
    ref = _reference()
    gen = torch.Generator().manual_seed(2)
    b, (gh, gw), heads, d = 2, (2, 3), 2, 6
    c = heads * d
    qkv = torch.randn((b * gh * gw, 256, 3 * c), generator=gen)
    table = torch.randn((961, heads), generator=gen)
    got = WA.window_attention_reference(qkv, table, heads, shift, (gh, gw))
    index = ref.relative_position_index(16)
    mask = ref.attention_mask(gh * 16, gw * 16, 16, shift) if shift else torch.zeros(gh * gw, 256, 256)
    assert bool((mask != 0).any()) == bool(shift)
    for w in (0, gw - 1, gh * gw - 1, gh * gw + 1, 2 * gh * gw - 1):
        q, k, v = qkv[w].reshape(256, 3, heads, d).unbind(1)
        for h in range(heads):
            logits = q[:, h] @ k[:, h].T / d**0.5 + table[index.reshape(-1), h].reshape(256, 256) + mask[w % (gh * gw)]
            want = torch.softmax(logits, dim=-1) @ v[:, h]
            assert float((got[w, :, h * d:(h + 1) * d] - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("grid", [(2, 3), (3, 3)], ids=["2x3", "3x3-interior"])
def test_plain_overlap_attention_matches_an_unfold_softmax(grid):
    """The plain version against each window's softmax written out as the
    published OCAB computes it: k and v cut from the grid by ``F.unfold``
    (kernel 24, stride 16, zero padding 4), the table read at the published
    index, at border windows (zero rows in their key windows) and an
    interior one. A table of std 1 makes a misread row show."""
    ref = _reference()
    gen = torch.Generator().manual_seed(4)
    (gh, gw), heads, d, b = grid, 2, 6, 2
    c = heads * d
    qkv = torch.randn((b * gh * gw, 256, 3 * c), generator=gen)
    table = torch.randn((1521, heads), generator=gen)
    got = OA.overlap_attention(qkv, table, heads, grid, 16, 24)
    image = ref.window_reverse(qkv, 16, b, gh * 16, gw * 16)  # [b, H, W, 3C]
    kv = F.unfold(image[..., c:].permute(0, 3, 1, 2), kernel_size=24, stride=16, padding=4)
    kv = kv.view(b, 2, c, 576, gh * gw)
    index = ref.overlap_position_index(16, 24).reshape(-1)
    for w in sorted({0, gw - 1, gh * gw - 1, (gh // 2) * gw + gw // 2, gh * gw + 1}):
        n, at = divmod(w, gh * gw)
        q = qkv[w, :, :c].reshape(256, heads, d)
        k, v = (kv[n, part, :, :, at].T.reshape(576, heads, d) for part in (0, 1))
        if w == 0:
            assert bool((k.abs().sum(-1) == 0).any())  # the border's zero rows
        for h in range(heads):
            logits = q[:, h] @ k[:, h].T / d**0.5 + table[index, h].reshape(256, 576)
            want = torch.softmax(logits, dim=-1) @ v[:, h]
            assert float((got[w, :, h * d:(h + 1) * d] - want).abs().max()) <= 1e-5


def test_the_ocab_index_is_the_published_one_and_wraps():
    """The port's index equals the reference's published construction; it
    has negative entries, which index the table from its end; and, so
    wrapped, each offset between a query and a key has its own row."""
    got = OA.overlap_position_index(16, 24)
    want = _reference().overlap_position_index(16, 24)
    assert got.shape == (256, 576) and torch.equal(got, want)
    assert int(got.min()) == -880 and int(got.max()) == 640
    table = torch.arange(1521.0)[:, None]
    assert torch.equal(table[got.reshape(-1)][:, 0], (got.reshape(-1) % 1521).float())
    qy, qx = torch.meshgrid(torch.arange(16), torch.arange(16), indexing="ij")
    ky, kx = torch.meshgrid(torch.arange(24), torch.arange(24), indexing="ij")
    offset = (ky.reshape(1, -1) - qy.reshape(-1, 1) + 15) * 39 + (kx.reshape(1, -1) - qx.reshape(-1, 1) + 15)
    rows = {}
    for o, r in zip(offset.reshape(-1).tolist(), (got.reshape(-1) % 1521).tolist()):
        assert rows.setdefault(o, r) == r
    assert len(set(rows.values())) == len(rows) == 39 * 39


def test_the_channel_attention_gate_is_over_the_whole_tile():
    """CAB's gate is one vector an image, from the mean over all of it: the
    port's block equals the reference's, and a change confined to one
    corner of an image moves the gated output at the opposite corner of that
    image only."""
    state, ref_params = _params(TINY_ARCH, 6)
    cab = CAB(24, 3, 6)
    cab.load_state_dict({k.split("conv_block.", 1)[1]: v for k, v in state.items()
                         if k.startswith("layers.0.blocks.0.conv_block.")}, strict=True)
    y = torch.randn((2, 32, 32, 24), generator=torch.Generator().manual_seed(7))
    with torch.inference_mode():
        u, gate = cab(y)
        want = _reference()._cab(y, ref_params, "layers/0/blocks/0/conv_block", _prec())
        assert gate.shape == (2, 24) and float((u * gate[:, None, None] - want).abs().max()) <= 1e-5
        moved = y.clone()
        moved[0, 24:, 24:] += 3.0
        u2, gate2 = cab(moved)
    far = (u2 * gate2[:, None, None])[:, :8, :8] - (u * gate[:, None, None])[:, :8, :8]
    assert torch.equal(u2[:, :8, :8], u[:, :8, :8])  # the convs do not reach the far corner
    assert float(far[0].abs().max()) > 1e-4 and float(far[1].abs().max()) == 0.0


def _prec():
    from benchmark.reference.models import Precision

    return Precision()


def test_published_widths_and_the_npz_layout():
    model = HAT()
    assert sum(p.numel() for p in model.parameters()) == 20_624_795 == _config()["parameters"]
    assert get_family("hat-x2").config == HATConfig()
    state, _ = _params(_config()["arch"], 0)
    model.load_state_dict(state, strict=True)
    assert tuple(model.layers[0].blocks[1].attn.relative_position_bias_table.shape) == (961, 6)
    assert tuple(model.layers[5].overlap_attn.relative_position_bias_table.shape) == (1521, 6)
    assert tuple(model.layers[0].blocks[0].conv_block.conv1.w.shape) == (60, 180, 3, 3)
    assert tuple(model.layers[0].blocks[0].conv_block.ca_down.w.shape) == (6, 180, 1, 1)
    assert [b.shift for b in model.layers[2].blocks] == [0, 8, 0, 8, 0, 8]
    assert _reference().tile_flops(_config()["arch"], 256) == 3_244_140_683_136


@pytest.mark.parametrize("shift", [0, 8])
@pytest.mark.parametrize("operand", [True, False], ids=["add", "no-add"])
def test_plain_add_norm_writes_both_layouts(operand, shift):
    """The HAB's add-norm: the window layout as ``add_norm_to_windows``
    gives it, bit for bit, and the same norm in token order."""
    gen = torch.Generator().manual_seed(8)
    x, a = (torch.randn((2, 32, 48, 12), generator=gen) for _ in range(2))
    a = a if operand else None
    weight, bias = 1.0 + 0.1 * torch.randn(12, generator=gen), 0.1 * torch.randn(12, generator=gen)
    s, y, y_image = SAN.add_norm_to_windows_and_tokens(x, a, weight, bias, EPS, shift, 16)
    want_s, want_y = SAN.add_norm_to_windows(x, a, weight, bias, EPS, shift, 16)
    assert torch.equal(s, want_s) and torch.equal(y, want_y)
    assert torch.equal(y_image, F.layer_norm(want_s, (12,), weight, bias, EPS))


def _photo(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 60 * np.sin(xx / (13.0 + 4 * c)) * np.cos(yy / 19.0) for c in range(3)], -1)
    img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90)
    return buf.getvalue()


def test_a_job_through_submit_job_matches_the_reference(scratch_registry, monkeypatch):
    """A tiny HAT family served as a deployment serves it: submit_job ->
    the restorator -> engine.sr_tiled (the tiled route taken from above 128
    px here, so that one tile of 256 keeps the CPU's f32 attention small),
    against the reference's tiled upscale of the same upload bytes."""
    from benchmark import drive
    from benchmark.reference import pipeline
    from image_restoration_platform_tpu_torch import imageio
    from image_restoration_platform_tpu_torch.api.submit import submit_job
    from image_restoration_platform_tpu_torch.serve.programs import sr as sr_programs

    monkeypatch.setattr(imageio, "_lib", None)  # the Pillow codec, as on a machine without libjpeg
    monkeypatch.setattr(imageio, "_native_failed", True)
    monkeypatch.setattr(sr_programs, "DIRECT_MAX", 128)
    cfg = _config()
    cfg = dict(cfg, family="hat-tiny-x2", arch=dict(_arch(JOB), direct_max=128),
               serving=dict(copy.deepcopy(cfg["serving"]), size_buckets=[128, 256]))
    register(ModelFamily("hat-tiny-x2", HATConfig(scale=2, **JOB)))
    state, ref_params = _params(cfg["arch"], 5)
    ctx = drive.build_service(cfg, "cpu")
    calls = []
    tiled = ctx.engine.sr_tiled
    monkeypatch.setattr(ctx.engine, "sr_tiled", lambda *a, **k: calls.append(a[1]) or tiled(*a, **k))
    try:
        ctx.engine.params_cache.put("hat-tiny-x2", state)
        ctx.user_store.grant("u", 10)
        upload = _photo(180, 240, 4)
        status, body, _ = submit_job(ctx, {"id": "u"}, [("a.jpg", upload)], options={"model": "hat-tiny-x2"},
                                     sync=True)
        assert status == 200, body
        served = pipeline.decode(base64.b64decode(body["result"]["restoredImage"]))
    finally:
        ctx.shutdown()
    assert calls == ["hat-tiny-x2"]
    with torch.inference_mode():
        want = pipeline.upscale(upload, cfg, _reference().network, ref_params, "cpu")
    assert served.shape == want.shape == (360, 480, 3)
    assert np.abs(served.astype(int) - want.astype(int)).max() <= 1


def test_the_registry_answers_for_hat(scratch_registry):
    family = get_family("hat-x2")
    assert family.kind == "sr" and not family.has_folded_layout and not family.row_shards
    assert not family.trainable and isinstance(family.build(), HAT)
    assert not uses_folded("hat-x2", ServingConfig(fold_w_sr=True))
    registry.check_attention_shapes("hat-x2", (256,), 8, torch.bfloat16)
    register(ModelFamily("hat-quarter-overlap", HATConfig(overlap_ratio=0.25, depths=(2,), num_heads=(6,))))
    with pytest.raises(ValueError, match="hat-quarter-overlap.*overlap attention kernel.*key windows of 24"):
        registry.check_attention_shapes("hat-quarter-overlap", (256,), 8, torch.bfloat16)
    register(ModelFamily("hat-w12", HATConfig(window_size=12, depths=(2,), num_heads=(6,))))
    with pytest.raises(ValueError, match="hat-w12.*windows of 8 or 16"):
        registry.check_attention_shapes("hat-w12", (256,), 8, torch.bfloat16)
    with pytest.raises(ValueError, match="HATConfig"):
        folded_model(HATConfig(**TINY), {})
    engine = RestorationEngine(device="cpu", serving_config=ServingConfig(size_buckets=(32,), max_batch=2))
    register(ModelFamily("hat-tiny", HATConfig(scale=2, **JOB)))
    up, meta = engine.sr_batch(np.zeros((1, 32, 32, 3), np.uint8), "hat-tiny")  # random weights
    assert up.shape == (1, 64, 64, 3) and meta["family"] == "hat-tiny"
    with pytest.raises(ValueError, match="hat-tiny"):
        engine.sr_spatial(np.zeros((64, 64, 3), np.uint8), "hat-tiny")


def test_the_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="CUDA tensors only"):
        OA.overlap_attention_kernel(torch.zeros(1, 256, 540, dtype=torch.bfloat16), torch.zeros(1521, 6), 6, (1, 1))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        WA.window_attention_kernel(torch.zeros(1, 256, 540, dtype=torch.bfloat16), torch.zeros(961, 6), 6, 8, (1, 1))
    OA.check_shapes(16, 24, 6, 180)
    with pytest.raises(ValueError, match="even head dim of at most 32"):
        OA.check_shapes(16, 24, 2, 180)
    with pytest.raises(ValueError, match="1 to 8 heads"):
        OA.check_shapes(16, 24, 9, 180)
    with pytest.raises(ValueError, match="windows of 16 against key windows of 24"):
        OA.check_shapes(8, 12, 6, 180)
    WA.check_shapes(16, 6, 180)
    SAN.check_shapes(16, 180)


def test_graph_replays_publish_the_overlap_launches():
    """The kernel is one of the hand-written kernels a capture's launch
    delta carries: a replay adds its launches and publishes
    ``kernels.launches.overlap_attention``."""
    from image_restoration_platform_tpu_torch.obs.metrics import get_counters
    from image_restoration_platform_tpu_torch.serve.exec_cache import LaunchDelta

    kernel = OA.overlap_attention_kernel
    before = kernel.launches, dict(kernel.launches_by_variant)
    delta = LaunchDelta()
    kernel.launches += 6  # what a capture of one chunk's six OCABs counts
    kernel.launches_by_variant["overlap"] += 6
    delta.close()
    assert (kernel.launches, kernel.launches_by_variant) == before
    published = get_counters().snapshot().get("kernels.launches.overlap_attention", 0.0)
    delta.replay()
    assert get_counters().snapshot()["kernels.launches.overlap_attention"] - published == 6
    kernel.launches, kernel.launches_by_variant = before[0], dict(before[1])


# ------------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the attention and add-norm kernels have no CPU mode")
    return torch.device("cuda")


def _graph_check(fn, inputs, plain, bar):
    """``fn`` eagerly and inside a CUDA graph (new values copied into
    ``inputs`` before the replay), each against ``plain`` within ``bar``."""
    eager = fn()
    torch.cuda.synchronize()
    ref = plain()
    assert eager.dtype == torch.bfloat16 and eager.shape == ref.shape
    assert float((eager.float() - ref.float()).abs().max()) <= bar(ref)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    gen = torch.Generator(device=inputs.device).manual_seed(99)
    inputs.copy_(torch.randn(inputs.shape, generator=gen, device=inputs.device).to(inputs.dtype))
    graph.replay()
    torch.cuda.synchronize()
    ref = plain()
    assert float((captured.float() - ref.float()).abs().max()) <= bar(ref)


@pytest.mark.cuda
def test_cuda_overlap_kernel_matches_plain_version(cuda_device):
    """HAT's widths on 2 tiles of 256 = 2 x 16 x 16 windows, 6 heads of 30
    (3,072 problems of 256 x 576), border and interior windows alike."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn((2 * 256, 256, 540), generator=gen, device=cuda_device).to(torch.bfloat16)
    table = torch.randn((1521, 6), generator=gen, device=cuda_device) * 0.5
    launches = OA.overlap_attention_kernel.launches
    _graph_check(lambda: OA.overlap_attention(qkv, table, 6, (16, 16), 16, 24), qkv,
                 lambda: OA.overlap_attention_reference(qkv, table, 6, (16, 16), 16, 24), A.bf16_parity_bar)
    assert OA.overlap_attention_kernel.launches == launches + 2  # the eager call and the capture


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 8])
def test_cuda_window_attention_at_16_matches_plain_version(cuda_device, shift):
    """HAT's HAB at 4 tiles of 256 = 4 x 16 x 16 windows of 256 tokens, 6
    heads of 30, plain and shifted windows."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn((4 * 256, 256, 540), generator=gen, device=cuda_device).to(torch.bfloat16)
    table = torch.randn((961, 6), generator=gen, device=cuda_device) * 0.5
    variant = "shifted_16" if shift else "window_16"
    before = WA.window_attention_kernel.launches_by_variant[variant]
    _graph_check(lambda: WA.window_attention(qkv, table, 6, shift, (16, 16)), qkv,
                 lambda: WA.window_attention_reference(qkv, table, 6, shift, (16, 16)), A.bf16_parity_bar)
    assert WA.window_attention_kernel.launches_by_variant[variant] == before + 2  # the eager call and the capture


def _ulp(v: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(v.float().abs().clamp_min(2.0**-8))) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 8])
@pytest.mark.parametrize("form", ["both", "both_no_add", "from_windows"])
def test_cuda_add_norm_at_16_matches_plain_version(cuda_device, form, shift):
    """The add-norm at HAT's chunk [8, 256, 256, 180] bf16 on windows of 16:
    the HAB's form that writes both layouts (with and without its operand)
    and from_windows; sums bit for bit, norms within one bf16 ulp."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    shape = (8, 256, 256, 180)
    x = (torch.randn(shape, generator=gen, device=cuda_device) + 0.3).to(torch.bfloat16)
    a = (0.5 * torch.randn(shape, generator=gen, device=cuda_device)).to(torch.bfloat16)
    weight = (1.0 + 0.1 * torch.randn(180, generator=gen, device=cuda_device)).to(torch.bfloat16)
    bias = (0.1 * torch.randn(180, generator=gen, device=cuda_device)).to(torch.bfloat16)
    if form == "from_windows":
        p = a.view(-1, 256, 180)
        got = SAN.add_norm_from_windows(x, p, weight, bias, EPS, shift, 16)
        want = SAN.add_norm_from_windows_reference(x, p, weight, bias, EPS, shift, 16)
    else:
        operand = a if form == "both" else None
        got = SAN.add_norm_to_windows_and_tokens(x, operand, weight, bias, EPS, shift, 16)
        want = SAN.add_norm_to_windows_and_tokens_reference(x, operand, weight, bias, EPS, shift, 16)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape and bool(((g.float() - w.float()).abs() <= _ulp(w)).all())


@pytest.mark.cuda
def test_cuda_tiled_call_counts_hats_launches(cuda_device):
    """One replay of hat-x2's tiled 2048 call (81 tiles in 11 chunks of 8):
    6 OCABs a chunk launch the overlap kernel 66 times and 36 HABs the
    window kernel 396 times at 16, half of them shifted, counted as the
    program counters ``kernels.launches.overlap_attention`` and
    ``kernels.launches.window_attention``; the add-norm twice and the MLP
    once a block (42 a chunk)."""
    from image_restoration_platform_tpu_torch.obs.metrics import get_counters
    from image_restoration_platform_tpu_torch.ops.cuda.swin_mlp import swin_mlp_kernel

    engine = RestorationEngine(device="cuda")
    canvas = np.zeros((2048, 2048, 3), np.uint8)
    engine.sr_tiled(canvas, "hat-x2")  # builds the graph
    kernels = {"overlap_attention": OA.overlap_attention_kernel, "window_attention": WA.window_attention_kernel,
               "swin_add_norm": SAN.swin_add_norm_kernel, "swin_mlp": swin_mlp_kernel}
    counters = get_counters().snapshot()
    before = {name: (k.launches, counters.get(f"kernels.launches.{name}", 0.0)) for name, k in kernels.items()}
    by_variant = dict(WA.window_attention_kernel.launches_by_variant)
    out, _ = engine.sr_tiled(canvas, "hat-x2")
    assert out.shape == (4096, 4096, 3)
    counters = get_counters().snapshot()
    got = {name: (k.launches - before[name][0], counters[f"kernels.launches.{name}"] - before[name][1])
           for name, k in kernels.items()}
    assert got == {"overlap_attention": (66, 66), "window_attention": (396, 396),
                   "swin_add_norm": (924, 924), "swin_mlp": (462, 462)}
    assert {v: n - by_variant[v] for v, n in WA.window_attention_kernel.launches_by_variant.items()} == \
        {"window": 0, "shifted": 0, "window_16": 198, "shifted_16": 198}
