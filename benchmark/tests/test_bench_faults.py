"""A whole run of the SR cell's harness on the CPU, at a size a test run can
hold (uploads of 560-600 px on the 1024 canvas, one client, a short window):
with the port sound it comes out correct; with the timed path broken
underneath it comes out not correct, once for each fault the cell can have.
The cell runs on one card, so there is no exchange between cards to leave
out."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from benchmark import run


def _nearest(canvas):
    return np.repeat(np.repeat(canvas, 2, axis=0), 2, axis=1)


def step_unchanged(ctx):
    """The network's step returns its input as it was (nearest-upsampled to
    the output's size)."""
    ctx.engine.sr_tiled = lambda canvas, family, **kw: (_nearest(canvas), {"deviceSeconds": 0.0})


def half_left_out(ctx):
    """Half of the canvas's tiles are left out: their rows keep the input."""
    served = ctx.engine.sr_tiled

    def half(canvas, family, **kw):
        out, meta = served(canvas, family, **kw)
        out = out.copy()
        out[out.shape[0] // 2 :] = _nearest(canvas)[out.shape[0] // 2 :]
        return out, meta

    ctx.engine.sr_tiled = half


def answer_altered(ctx):
    """The served canvas is altered where it is produced: moved one pixel."""
    served = ctx.engine.sr_tiled

    def shifted(canvas, family, **kw):
        out, meta = served(canvas, family, **kw)
        return np.roll(out, 1, axis=1), meta

    ctx.engine.sr_tiled = shifted


@pytest.fixture
def tiny_sr_cell(scratch_root, pillow_codec):
    with open(os.path.join(scratch_root.root, "benchmark", "traffic", "upscale-2k.json")) as f:
        mix = json.load(f)
    mix.update(name="upscale-tiny", pool=2, longest=[560, 600], loop={"kind": "closed", "clients": 1})
    return scratch_root("sr-x2.upscale-tiny", "sr-x2", mix, like="sr-x2.upscale-2k"), scratch_root.root


@pytest.mark.parametrize("fault", [None, step_unchanged, half_left_out, answer_altered],
                         ids=["sound", "step_unchanged", "half_left_out", "answer_altered"])
def test_correct_only_when_sound(tiny_sr_cell, fault):
    name, root = tiny_sr_cell
    result, lines = run.execute(name, 2**31 + 17, 0.5, False, device="cpu", root=root, hooks=fault)
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks" and lines[-1].startswith("check ")
    assert {"images_per_s", "setup_s"} <= set(result["metrics"])
    assert result["correct"] is (fault is None), result["checks"]
