"""Fixtures of the benchmark's CPU tests: a scratch root holding a copy of
the benchmark (with the shipped weights linked in), the port's codec held
to Pillow as on the card's machine, and the card check for ``cuda`` tests."""

from __future__ import annotations

import json
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def pillow_codec(monkeypatch):
    """The port's imageio without its native library: the codec, and the
    egress the restorator picks, of a machine without libjpeg."""
    from image_restoration_platform_tpu_torch import imageio

    monkeypatch.setattr(imageio, "_lib", None)
    monkeypatch.setattr(imageio, "_native_failed", True)


@pytest.fixture
def scratch_root(tmp_path):
    """A copy of BENCHMARK.json and benchmark/ under ``tmp_path``, with
    ``add_cell(name, config, mix)`` to add a traffic mix and a workload to it
    that every metric of the matching real cell also lists."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "weights"), tmp_path / "weights")

    def add_cell(name: str, config: str, mix: dict, like: str | None = None) -> str:
        bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
        (tmp_path / "benchmark" / "traffic" / f"{mix['name']}.json").write_text(json.dumps(mix))
        if not any(c["name"] == config for c in bench["configs"]):
            bench["configs"].append({"name": config, "source": "https://example.org/model",
                                     "file": f"benchmark/configs/{config}.json", "reduced": [], "why": "test"})
        bench["workloads"].append({"name": name, "config": config, "traffic": mix["name"], "chips": 1, "why": "test"})
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in metric and (like is None or like in metric["workloads"]):
                metric["workloads"].append(name)
        (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
        return name

    add_cell.root = str(tmp_path)
    return add_cell


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell runs only there")
