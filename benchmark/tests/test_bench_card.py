"""Each cell as its command runs it, on the card: a short window of every
workload in BENCHMARK.json through the command, correct on a fresh seed.
Skips without a card.

    python3 -m pytest benchmark/tests -m cuda -q
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _workloads():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", _workloads())
def test_cell_runs_correct_on_the_card(cuda_card, workload):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed", str(2**31 + 4242),
                           "--seconds", "5", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["attempted"] > 0


def test_run_refuses_without_a_card(monkeypatch):
    """No card: exit code 2 and no result line."""
    import torch

    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run, "prepare_environment", lambda root: None)
    assert run.main(["--workload", _workloads()[0], "--seed", "1", "--seconds", "1", "--trace", "0"]) == 2
