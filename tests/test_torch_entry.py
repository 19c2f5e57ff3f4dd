"""PyTorch port: the entry points of image_restoration_platform_tpu_torch/entry.py.

``entry()`` on the CPU gives the flagship's fused step: on the same canvas
it equals the reference's ``__graft_entry__.entry()`` step (both models are
untrained, so the zero-initialised head makes each the identity and the
step is classification, conditioning and the byte round trip): scores
within 1e-4, bytes within 1 level. ``dryrun_multichip(4)`` passes the
reference's bars on slot meshes of 4 CPU slots in a fresh interpreter.
Without a card ``entry()`` raises unless asked for the CPU."""

import jax
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu_torch.entry import dryrun_multichip, entry

REFERENCE_ENTRY = "__graft_entry__"


def test_entry_is_the_reference_fused_step():
    import importlib

    fn, (model, canvas, valid, is_jpeg) = entry("cpu")
    assert canvas.shape == (1, 256, 256, 3) and canvas.dtype == torch.uint8
    assert next(model.parameters()).device.type == "cpu"
    rng = np.random.default_rng(5)
    img = np.clip(rng.normal(0, 30, (1, 256, 256, 3)) + 120, 0, 255).astype(np.uint8)
    out, scores = fn(model, torch.from_numpy(img), valid, is_jpeg)
    assert out.shape == (1, 256, 256, 3) and out.dtype == torch.uint8 and scores.shape == (1, 7)

    ref_fn, (params, _canvas, ref_valid, ref_jpeg) = importlib.import_module(REFERENCE_ENTRY).entry()
    ref_out, ref_scores = jax.jit(ref_fn)(params, img, ref_valid, ref_jpeg)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), atol=1e-4)
    assert np.abs(out.numpy().astype(int) - np.asarray(ref_out).astype(int)).max() <= 1


def test_entry_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_dryrun_multichip_on_four_cpu_slots(capsys):
    dryrun_multichip(4)
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh(data=2, tensor=2)" in out
    assert "UNet 4-stage x data=1 pipeline exact" in out and "tiled SR on data=2 x spatial=2" in out
