"""What a cell is made of, found by name: ``BENCHMARK.json`` at the root,
``benchmark/configs/<config>.json``, the reference network its
``"reference"`` names in ``benchmark/reference/<name>.py``,
``benchmark/traffic/<mix>.json`` and ``benchmark/metrics/<metric>.py``. A
cell, mix, configuration, network or metric is added by adding its files
and its entry; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Metric:
    name: str
    unit: str
    read: object  # read(run) -> float | None; None leaves the metric out


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    reference: object  # the configuration's reference module (load_reference)
    mix: dict
    end_to_end: list[Metric]
    per_layer: list[Metric]


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(kind: str, name: str, path: str):
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(name: str, bench_dir: str = BENCH_DIR):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _load_module("metric", name, os.path.join(bench_dir, "metrics", f"{name}.py")).read


def load_reference(name: str, bench_dir: str = BENCH_DIR):
    """The reference network ``reference/<name>.py`` that a configuration
    names. It imports nothing of the program, and provides:

    - ``network(params, arch, x, prec)``: the plain float32 forward of a
      batch of tiles, [N,t,t,3] in [0,1] -> [N,t*s,t*s,3], with whatever
      the served program does after the network; it passes every input and
      weight of a convolution or matrix product through ``prec.q``, so that
      the control's lower precision reaches every product;
    - ``tile_flops(arch, tile)``: the canonical operations of one tile
      (2 per multiply-add), from the architecture's keys alone;
    - ``init(arch, seed)``, for a configuration whose ``"weights"`` is
      ``{"seed": n}``: float32 arrays drawn on the CPU from the seed, keyed
      and laid out as the shipped npz files are ('/'-joined names, HWIO conv
      kernels). The served output of the weights it draws has to fall
      mostly inside the byte range: clamping at 0 and 255 would hide what
      the comparison that decides ``correct`` should see.
    """
    return _load_module("reference", name, os.path.join(bench_dir, "reference", f"{name}.py"))


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its configuration,
    its traffic mix and the readers of the metrics it reports."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    bench_dir = os.path.join(root, "benchmark")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = _load_json(os.path.join(root, cfg_entry["file"]))
    if "reference" not in config:
        raise ValueError(f"{cfg_entry['file']} has no \"reference\" key: the name of its network's module "
                         "benchmark/reference/<name>.py")
    mix = _load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))

    def metrics(kind):
        return [Metric(m["name"], m["unit"], load_reader(m["name"], bench_dir)) for m in bench[kind] if _applies(m, name)]

    return Cell(name, int(w["chips"]), config, load_reference(config["reference"], bench_dir), mix,
                metrics("end_to_end"), metrics("per_layer"))


def peaks(kind: str, root: str = ROOT) -> dict:
    """The data-sheet peaks of a card, by its name (``peaks.json``)."""
    table = _load_json(os.path.join(root, "benchmark", "peaks.json"))
    for entry in table["cards"]:
        if entry["match"] in kind:
            return entry
    raise KeyError(f"no peaks for {kind!r}")
