"""PyTorch port: the random generators of ``train/data.py`` against the JAX
package's distribution.

The two draw different numbers (a ``torch.Generator`` against split JAX
keys), so each clean generator and ``synthetic_batch`` (the r5-anchor data
recipe: photo, deconv, grain, smooth, compression- and lowLight-solo) are
drawn at n = 64, 64 px in both and held to the same distribution: for each
per-image statistic (mean, standard deviation, mean |gradient|; for the
batch also the serving classifier's seven scores and the comp-only rate) the
two means differ by at most 4 standard errors of their difference,
sqrt(var_jax / n + var_port / n), plus 1e-3."""

import jax
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu.train import data as J
from image_restoration_platform_tpu_torch.train import data as D

torch.set_num_threads(2)
N, S = 64, 64
RECIPE = dict(size=S, photo=True, deconv=True, grain=True, smooth=True, compression_solo=0.3, lowlight_solo=0.18)
GENERATORS = ["random_clean", "rich", "flat", "cells", "periodic", "grain", "smooth"]
_FUNCS = {
    "random_clean": "_random_clean", "rich": "_random_clean_rich", "flat": "_flat_scene", "cells": "_soft_cells",
    "periodic": "_periodic_texture", "grain": "_grain_texture", "smooth": "_smooth_scene",
}


@pytest.fixture(scope="module")
def jax_draws():
    @jax.jit
    def gens(key):
        ks = jax.random.split(key, len(GENERATORS))
        return {g: getattr(J, _FUNCS[g])(k, N, S, 3) for g, k in zip(GENERATORS, ks)}

    out = {g: np.asarray(v) for g, v in gens(jax.random.PRNGKey(0)).items()}
    batch = J.synthetic_batch(jax.random.PRNGKey(1), N, J.DataConfig(**RECIPE), with_masks=True)
    out["batch"] = tuple(np.asarray(a) for a in batch)
    return out


def _image_stats(x: np.ndarray) -> dict:
    grad = np.abs(np.diff(x, axis=1)).mean(axis=(1, 2, 3)) + np.abs(np.diff(x, axis=2)).mean(axis=(1, 2, 3))
    return {"mean": x.mean(axis=(1, 2, 3)), "std": x.std(axis=(1, 2, 3)), "mean_abs_grad": grad}


def _same_distribution(ours: dict, ref: dict, what: str) -> None:
    for name in ref:
        a, b = np.asarray(ours[name], np.float64), np.asarray(ref[name], np.float64)
        band = 4.0 * np.sqrt(a.var() / a.size + b.var() / b.size) + 1e-3
        assert abs(a.mean() - b.mean()) <= band, f"{what} {name}: port {a.mean():.4f}, jax {b.mean():.4f}, ±{band:.4f}"


@pytest.mark.parametrize("generator", GENERATORS)
def test_clean_generator_matches_jax_distribution(generator, jax_draws):
    ours = getattr(D, _FUNCS[generator])(torch.Generator().manual_seed(0), N, S, 3).numpy()
    ref = jax_draws[generator]
    assert ours.shape == ref.shape == (N, S, S, 3) and np.isfinite(ours).all()
    assert 0.0 <= ours.min() and ours.max() <= 1.0
    _same_distribution(_image_stats(ours), _image_stats(ref), generator)


def test_synthetic_batch_matches_jax_distribution(jax_draws):
    ours = [a.numpy() for a in D.synthetic_batch(torch.Generator().manual_seed(1), N, D.DataConfig(**RECIPE),
                                                  with_masks=True)]
    ref = jax_draws["batch"]
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
    stats, ref_stats = {}, {}
    for i, part in enumerate(("degraded", "clean")):
        for k, v in _image_stats(ours[i]).items():
            stats[f"{part}_{k}"] = v
        for k, v in _image_stats(ref[i]).items():
            ref_stats[f"{part}_{k}"] = v
    for j, score in enumerate(("blur", "noise", "lowLight", "compression", "scratch", "fade", "colorShift")):
        stats[f"score_{score}"], ref_stats[f"score_{score}"] = ours[2][:, j], ref[2][:, j]
    stats["comp_only"], ref_stats["comp_only"] = ours[3], ref[3]
    _same_distribution(stats, ref_stats, "synthetic_batch")
