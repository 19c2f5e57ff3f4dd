"""BENCHMARK.json and a run's last line against the benchmark contract:
keys, names and units of allowed characters, bounds, the metrics each cell
reports, and the files every entry names."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert os.path.exists(os.path.join(spec.ROOT, c["file"])) and c["name"] in used
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        # the configuration names its reference network, and where its weights come from
        assert NAME.match(cfg["reference"])
        assert os.path.exists(os.path.join(spec.BENCH_DIR, "reference", f"{cfg['reference']}.py"))
        module = spec.load_reference(cfg["reference"])
        assert callable(module.network) and callable(module.tile_flops)
        if isinstance(cfg["weights"], dict):
            assert set(cfg["weights"]) == {"seed"} and isinstance(cfg["weights"]["seed"], int)
            assert callable(module.init)
        else:
            assert os.path.exists(os.path.join(spec.ROOT, cfg["weights"]))


def test_workloads(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert os.path.exists(os.path.join(spec.ROOT, "benchmark", "traffic", f"{w['traffic']}.json"))


def test_metrics(bench):
    all_metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in all_metrics]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
    for m in all_metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(spec.ROOT, "benchmark", "metrics", f"{m['name']}.py"))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert "setup_s" in {m.name for m in cell.end_to_end} and len(cell.end_to_end) >= 2
        assert cell.per_layer


def test_last_line_shape():
    """A run's last line as run.py builds it: the keys a reader of the
    result needs, ``checks`` last."""
    from benchmark import run

    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "image_restoration_platform_tpu")
    result = {"correct": True, "attempted": 3, "failed": 0, "metrics": {"setup_s": {"value": 1.0, "unit": "s"}},
              "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1, "memory_peak_bytes": 1},
              "checks": {"credit_gap": {"value": 0.0, "limit": 0.0}}}
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
