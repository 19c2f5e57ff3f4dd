"""The hat-x2 configuration: its reference's operation count against
PyTorch's FlopCounterMode over the network at the published widths, its
window attention's bytes, the overlap attention's roofline reader (its
counts, and a reading only where the program launched the kernel once a
residual group and chunk of tiles), and the cell's configuration and mix as
``spec.load_cell`` loads them."""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, spec

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "hat-x2.upscale-2k"
METRIC = "kernels.overlap_attention_roofline"
TOKENS = 81 * 256 * 256  # a 2048 canvas: 81 tiles of 256 x 256 tokens
PEAKS = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def config() -> dict:
    with open(os.path.join(HERE, "configs", "hat-x2.json")) as f:
        return json.load(f)


def _module():
    return spec._load_module("metric", METRIC, os.path.join(HERE, "metrics", f"{METRIC}.py"))


@pytest.mark.parametrize("tile", [32, 64])
def test_tile_flops_is_what_the_network_multiplies(tile):
    """The network on meta tensors at the published widths (no arithmetic
    is done): every product and convolution FlopCounterMode sees, CAB's
    and its gate's included, equals ``tile_flops`` a tile."""
    ref = spec.load_reference("hat")
    arch = config()["arch"]
    params = {k: torch.empty(v.transpose(3, 2, 0, 1).shape if v.ndim == 4 else v.shape, device="meta")
              for k, v in ref.init(arch, 0).items()}
    with FlopCounterMode(display=False) as counter:
        out = ref.network(params, arch, torch.empty((2, tile, tile, 3), device="meta"))
    assert out.shape == (2, 2 * tile, 2 * tile, 3)
    assert counter.get_total_flops() == 2 * ref.tile_flops(arch, tile)


def test_operations_and_parameters_of_the_published_model():
    cfg = config()
    ref = spec.load_reference("hat")
    assert ref.tile_flops(cfg["arch"], 256) == 3_244_140_683_136
    assert flops.image_flops(cfg, 2048) == 81 * 3_244_140_683_136
    assert sum(v.size for v in ref.init(cfg["arch"], 0).values()) == cfg["parameters"] == 20_624_795


def test_window_attention_bytes_are_swinirs_formula_at_16():
    """The HABs' window attention: q, k, v read and o written in bf16 for
    every token of the 81 tiles in 36 HABs, and each HAB's [961, 6] f32
    table; the window roofline reader reads it as it reads SwinIR's."""
    arch = config()["arch"]
    table = 36 * 961 * 6 * 4
    assert spec.load_reference("hat").attention_bytes(arch, 2048) == 36 * 4 * TOKENS * 180 * 2 + table


def test_overlap_operations_and_bytes_of_a_2048_canvas():
    """Six OCABs over the 81 tiles' tokens: QK^T and PV against 24 x 24
    keys, and q, k, v in, o out in bf16 with each OCAB's [1521, 6] table.
    The operations are the OCABs' attention share of the reference's count."""
    ref = spec.load_reference("hat")
    arch = config()["arch"]
    assert _module().overlap_flops(arch, 2048) == 6 * 4 * TOKENS * 576 * 180
    # tile_flops less what it counts with key windows of 16 is the 24 x 24 windows' extra keys
    share = ref.tile_flops(arch, 256) - ref.tile_flops(dict(arch, overlap_ratio=0.0), 256) + 6 * 4 * 256 * 256 * 256 * 180
    assert 81 * share == _module().overlap_flops(arch, 2048)
    assert _module().overlap_bytes(arch, 2048) == 6 * (4 * TOKENS * 180 * 2 + 4 * 1521 * 6)


class _Step:
    canvas = 2048

    def device_ns(self, match=None):
        return 50_000_000 if match == "overlap_attention_kernel" else 1_000_000_000


def _run(launches: float, calls: float = 3.0):
    counters = {"sr_tiled_calls.2048": calls}
    if launches:
        counters["kernels.launches.overlap_attention"] = launches
    return SimpleNamespace(config=config(), cell=SimpleNamespace(reference=None), counters=counters,
                           trace=SimpleNamespace(steps=[_Step(), _Step()]), peaks=PEAKS)


def test_the_reader_reads_a_whole_program_at_its_larger_bound():
    arch = config()["arch"]
    m = _module()
    least = max(m.overlap_flops(arch, 2048) / PEAKS["bf16_flops"], m.overlap_bytes(arch, 2048) / PEAKS["hbm_bytes_per_s"])
    assert m.overlap_bytes(arch, 2048) / PEAKS["hbm_bytes_per_s"] > m.overlap_flops(arch, 2048) / PEAKS["bf16_flops"]
    got = spec.load_reader(METRIC)(_run(3 * 66))
    assert abs(got - 100.0 * 2 * least / 0.1) < 1e-9


def test_the_reader_reads_nothing_where_launches_are_short_or_missing():
    read = spec.load_reader(METRIC)
    assert read(_run(3 * 66 - 6)) is None  # a chunk's OCABs left out
    assert read(_run(3 * 66 + 11)) is None
    assert read(_run(0)) is None  # a program without the counter (the parent's)


def test_the_cell_loads_with_its_mix_and_metrics():
    """The mix is upscale-2k's generator parameters, every one, with the
    model swapped, so a seed draws the same uploads in the three cells; the
    configuration keeps the published widths and reduces nothing."""
    cell = spec.load_cell(CELL)

    def mix(name):
        with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
            return json.load(f)

    ours, theirs = cell.mix, mix("upscale-2k")
    assert ours["options"] == {"model": "hat-x2"} == {"model": cell.config["family"]}
    assert {k: v for k, v in ours.items() if k not in ("name", "options")} == \
        {k: v for k, v in theirs.items() if k not in ("name", "options")}
    arch = cell.config["arch"]
    assert cell.config["reduced"] == [] and cell.config["reference"] == "hat" and cell.reference.__name__.endswith("hat")
    assert (arch["embed_dim"], arch["depths"], arch["num_heads"], arch["window_size"]) == (180, [6] * 6, [6] * 6, 16)
    assert (arch["compress_ratio"], arch["squeeze_factor"], arch["conv_scale"], arch["overlap_ratio"]) == (3, 30, 0.01, 0.5)
    assert (arch["mlp_ratio"], arch["upsampler"], arch["resi_connection"]) == (2.0, "pixelshuffle", "1conv")
    assert any("OCAB index" in line for line in cell.config["assumed"])
    assert [m.name for m in cell.end_to_end] == ["images_per_s", "setup_s"]
    names = [m.name for m in cell.per_layer]
    assert METRIC in names and "model.step_mfu" in names and "kernels.swin_add_norm_roofline" not in names
    assert "kernels.swin_mlp_roofline" not in names and "engine.queue_ms" not in names


@pytest.mark.parametrize("shift", [0, 8])
def test_the_attention_is_the_published_expression_bit_for_bit(shift):
    """``_attend`` scales, adds the bias and the shifted windows' mask in
    place: the same operations in the same order as the published
    ``attn * scale + bias`` and ``attn + mask``, so the same numbers."""
    ref = spec.load_reference("hat")
    gen = torch.Generator().manual_seed(shift)
    windows, heads, t, d = 4, 2, 256, 30
    q, k, v = (torch.randn(2 * windows, heads, t, d, generator=gen) for _ in range(3))
    bias = torch.randn(heads, t, t, generator=gen)
    mask = ref.attention_mask(32, 32, 16, shift) if shift else None
    want = q @ k.transpose(-2, -1) * d ** -0.5 + bias[None]
    if shift:
        want = (want.view(2, windows, heads, t, t) + mask[None, :, None]).view(2 * windows, heads, t, t)
    want = torch.softmax(want, dim=-1) @ v
    assert torch.equal(ref._attend(q, k, v, bias, ref.Precision(), mask), want)


def test_masks_and_indexes_are_built_once_a_device():
    """The shifted windows' mask and the bias indexes are built on the host
    once and kept on the device: not once a block and chunk."""
    ref = spec.load_reference("hat")
    first = ref._on_device(ref.attention_mask, (32, 32, 16, 8), "cpu")
    assert ref._on_device(ref.attention_mask, (32, 32, 16, 8), "cpu") is first
    assert torch.equal(first, ref.attention_mask(32, 32, 16, 8))
    index = ref._on_device(ref.overlap_position_index, (16, 24), "cpu")
    assert torch.equal(index, ref.overlap_position_index(16, 24))
