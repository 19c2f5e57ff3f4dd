"""A configuration brings its own reference network, operation count and
seeded weights as new files: a scratch copy of the benchmark takes a second,
toy tiled architecture through a configuration file, a reference module, a
traffic mix and a workload entry, with no file of the benchmark edited.
Every module a real configuration names counts its tile's operations as
PyTorch's FlopCounterMode does, and sr-x2's counts stay where they were."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import check, flops, spec, weights
from benchmark.reference import models
from benchmark.traffic import generator

ROOT = spec.ROOT

TOY = '''"""A toy tiled SR network: a 3x3 conv, ReLU, a 3x3 conv to 3*s*s
channels, a pixel shuffle and the nearest-upsampled input added."""

import numpy as np
import torch

from benchmark.flops import conv_flops
from benchmark.reference.models import Precision, conv, pixel_shuffle


def network(p, arch, x, prec=Precision()):
    x, s = prec.q(x), arch["scale"]
    h = torch.relu(conv(x, p["head/w"], p["head/b"], prec))
    up = x.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)
    return pixel_shuffle(conv(h, p["tail/w"], p["tail/b"], prec), s) + up


def tile_flops(arch, tile):
    c, s = arch["channels"], arch["scale"]
    return conv_flops(tile, tile, 3, c) + conv_flops(tile, tile, c, 3 * s * s)


def init(arch, seed):
    rng = np.random.default_rng(seed)
    c, s = arch["channels"], arch["scale"]
    return {"head/w": rng.normal(0.0, 0.2, (3, 3, 3, c)), "head/b": np.zeros(c),
            "tail/w": rng.normal(0.0, 0.02, (3, 3, c, 3 * s * s)), "tail/b": np.zeros(3 * s * s)}
'''

TOY_ARCH = {"scale": 2, "channels": 8, "in_channels": 3, "tile": 128, "overlap": 16, "tile_batch": 4,
            "tiled_canvas": 512, "direct_max": 256}


def _json(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture
def toy_cell(scratch_root):
    """The toy architecture added to a scratch copy: its module, its
    configuration (seeded weights), a mix of 300-420 px uploads that land on
    the 512 tiled canvas, and a workload reporting the SR cell's metrics."""
    root = scratch_root.root
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "reference", "toynet.py"), "w") as f:
        f.write(TOY)
    sr = _json(os.path.join(bench, "configs", "sr-x2.json"))
    cfg = {"name": "toy-x2", "source": "test", "reduced": [], "family": "toy-x2", "surface": "sr_tiled",
           "reference": "toynet", "weights": {"seed": 7}, "dtype": "float32", "arch": TOY_ARCH,
           "serving": dict(sr["serving"], size_buckets=[256]), "limits": sr["limits"]}
    with open(os.path.join(bench, "configs", "toy-x2.json"), "w") as f:
        json.dump(cfg, f)
    mix = dict(_json(os.path.join(bench, "traffic", "upscale-2k.json")), name="upscale-toy", pool=2,
               longest=[300, 420], loop={"kind": "closed", "clients": 1})
    name = scratch_root("toy-x2.upscale-toy", "toy-x2", mix, like="sr-x2.upscale-2k")
    return spec.load_cell(name, root), root


def test_a_second_architecture_loads(toy_cell):
    cell, root = toy_cell
    assert cell.config["reference"] == "toynet" and cell.reference.__file__.startswith(root)
    assert all(callable(getattr(cell.reference, f)) for f in ("network", "tile_flops", "init"))
    assert {"model.step_mfu", "kernels.blend_roofline"} <= {m.name for m in cell.per_layer}
    # the real cell in the same copy keeps its own network
    assert spec.load_cell("sr-x2.upscale-2k", root).reference.__file__.endswith(os.path.join("reference", "srnet.py"))


def test_its_operation_count_comes_from_its_module(toy_cell):
    cell, _ = toy_cell
    # 5 x 5 tiles of 128 on the 512 canvas, 2 * 128^2 * 9 * (3*8 + 8*12) operations each
    assert flops.sr_tiles(TOY_ARCH, 512) == 25
    assert cell.reference.tile_flops(TOY_ARCH, 128) == 2 * 128 * 128 * 9 * (3 * 8 + 8 * 12)
    assert flops.image_flops(cell.config, 512, cell.reference) == 25 * 2 * 128 * 128 * 9 * (3 * 8 + 8 * 12)


def test_its_reference_upscale_runs_and_its_control_differs(toy_cell):
    cell, root = toy_cell
    cfg = dict(cell.config, weights_path=weights.resolve(cell.config, cell.reference, root)[0])
    pool = generator.make_pool(cell.mix, 11, workers=2)
    uploads = {u.index: u.data for u in pool}
    ref = check.reference_answers(cfg, cell.reference.network, uploads, "cpu")
    low = check.reference_answers(cfg, cell.reference.network, uploads, "cpu", models.Precision("fp8", torch.bfloat16))
    for u in pool:
        assert max(u.height, u.width) > 256  # on the 512 tiled canvas
        assert ref[u.index].shape == low[u.index].shape == (2 * u.height, 2 * u.width, 3)
    control = check.compare([low[i] for i in uploads], [ref[i] for i in uploads])
    assert control["pixel_mean_gap"] > 0.1, control
    # the drawn weights keep the output inside the byte range: the answer is not clamped flat
    assert 5.0 < float(np.mean(ref[pool[0].index])) < 250.0


def test_seeded_weights_are_written_once(toy_cell):
    cell, root = toy_cell
    path, directory = weights.resolve(cell.config, cell.reference, root)
    assert os.path.dirname(directory) == os.path.join(root, "build", "bench-weights")
    assert path == os.path.join(directory, "toy-x2.npz") and not os.path.islink(path)
    shipped = sorted(n for n in os.listdir(os.path.join(root, "weights")) if n.endswith(".npz"))
    assert shipped and sorted(os.listdir(directory)) == sorted(shipped + ["toy-x2.npz"])
    for name in shipped:
        link = os.path.join(directory, name)
        assert os.path.islink(link) and os.path.samefile(link, os.path.join(root, "weights", name))
    before = os.stat(path)
    with np.load(path) as first:
        arrays = {k: first[k] for k in first.files}
    # a second resolve finds the directory and writes nothing
    assert weights.resolve(cell.config, cell.reference, root) == (path, directory)
    after = os.stat(path)
    assert (after.st_ino, after.st_mtime_ns) == (before.st_ino, before.st_mtime_ns)
    assert os.listdir(os.path.dirname(directory)) == [os.path.basename(directory)]
    drawn = cell.reference.init(TOY_ARCH, 7)
    with np.load(path) as second:
        assert sorted(second.files) == sorted(drawn) == sorted(arrays)
        for k in drawn:
            assert second[k].dtype == np.float32
            np.testing.assert_array_equal(second[k], arrays[k])
            np.testing.assert_array_equal(second[k], np.asarray(drawn[k], np.float32))


def test_a_shipped_file_leaves_the_weights_directory_alone():
    cell = spec.load_cell("sr-x2.upscale-2k")
    assert weights.resolve(cell.config, cell.reference, ROOT) == (os.path.join(ROOT, "weights", "sr-x2.npz"), None)


def test_a_configuration_without_a_reference_fails_at_load(scratch_root):
    root = scratch_root.root
    path = os.path.join(root, "benchmark", "configs", "sr-x2.json")
    cfg = _json(path)
    del cfg["reference"]
    with open(path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError, match='"reference"'):
        spec.load_cell("sr-x2.upscale-2k", root)


def _named_modules():
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    for c in bench["configs"]:
        cfg = _json(os.path.join(ROOT, c["file"]))
        for tile in (32, 64):
            yield pytest.param(cfg, tile, id=f"{cfg['reference']}-{c['name']}-{tile}")


@pytest.mark.parametrize("cfg, tile", list(_named_modules()))
def test_tile_flops_match_the_counter(cfg, tile):
    """A batch of three tiles through the module's network: FlopCounterMode
    counts three times its ``tile_flops``."""
    module = spec.load_reference(cfg["reference"])
    params = models.load_npz(weights.resolve(cfg, module, ROOT)[0], "cpu")
    with FlopCounterMode(display=False) as counter, torch.inference_mode():
        module.network(params, cfg["arch"], torch.rand(3, tile, tile, 3))
    assert 3 * module.tile_flops(cfg["arch"], tile) == counter.get_total_flops()


def test_sr_x2_counts_are_unchanged():
    cfg = _json(os.path.join(ROOT, "benchmark", "configs", "sr-x2.json"))
    assert flops.image_flops(cfg, 2048) == 6_745_170_640_896
    assert flops.blend_bytes(cfg["arch"], 2048) == 456_130_560

