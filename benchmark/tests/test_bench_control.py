"""The control (the plain reference one precision below the
configuration's: float8 networks, bf16 around them) in the program's place
fails the comparison that decides ``correct``, at a size a test run can
hold; the float32 reference against itself passes it."""

from __future__ import annotations

import json
import os

import torch

from benchmark import check, spec
from benchmark.reference.models import Precision
from benchmark.traffic import generator

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _cfg(name: str, **serving) -> dict:
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg["serving"].update(serving)
    return dict(cfg, weights_path=os.path.join(ROOT, cfg["weights"]))


def _uploads(mix_name: str, longest, n: int, seed: int) -> dict:
    with open(os.path.join(HERE, "traffic", f"{mix_name}.json")) as f:
        mix = dict(json.load(f), pool=n, longest=longest)
    return {u.index: u.data for u in generator.make_pool(mix, seed, workers=2)}


def test_sr_control_fails_the_limits():
    cfg = _cfg("sr-x2", size_buckets=[256])
    cfg["arch"] = dict(cfg["arch"], direct_max=256, tiled_canvas=512)
    uploads = _uploads("upscale-2k", [300, 420], 2, 5)
    network = spec.load_reference(cfg["reference"]).network
    ref = check.reference_answers(cfg, network, uploads, "cpu")
    same = check.compare([ref[i] for i in uploads], [ref[i] for i in uploads])
    low = check.reference_answers(cfg, network, uploads, "cpu", Precision("fp8", torch.bfloat16))
    control = check.compare([low[i] for i in uploads], [ref[i] for i in uploads])
    assert check.verdict(dict(same, failed_jobs=0.0, credit_gap=0.0), cfg["limits"])[0]
    assert not check.verdict(dict(control, failed_jobs=0.0, credit_gap=0.0), cfg["limits"])[0], control
