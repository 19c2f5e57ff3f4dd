"""PyTorch port: the port's own training draws against the reference's, in
distribution.

tests/test_torch_train_data.py holds ``_apply_degradations`` with the JAX
draws injected; the port's own sampler (``_degrade_draws`` and the clean
generators, from a torch.Generator) is a different stream of the same
distributions. Over 512 images a distribution (8 batches of 64, seeds
3000-3007 in both packages), at 32 px and at the quality gates' 128 px,
``synthetic_batch`` of each package gives input PSNRs whose two-sample
Kolmogorov-Smirnov distance is under 0.122 (the critical value at a 0.001
level for 512 against 512), the same share of clean rows (input PSNR over
48 dB) within 0.08 (3.3 standard errors of the difference), and clean
images of the same mean and spread within 0.02 and the same Laplacian
energy within 15 %."""

import jax
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from image_restoration_platform_tpu.train.data import DataConfig as JDataConfig
from image_restoration_platform_tpu.train.data import synthetic_batch as jsynthetic_batch
from image_restoration_platform_tpu_torch.eval.common import DAMAGE_PSNR_MAX, per_image_psnr
from image_restoration_platform_tpu_torch.eval.gates import hf_energy
from image_restoration_platform_tpu_torch.train.data import DataConfig, synthetic_batch

torch.set_num_threads(2)
SEEDS, BATCH = range(3000, 3008), 64
KS_DISTANCE, CLEAN_SHARE, MOMENT, LAPLACIAN_REL = 0.122, 0.08, 0.02, 0.15


def _stats(batches) -> dict:
    degraded = np.concatenate([np.asarray(d, np.float32) for d, _ in batches])
    clean = np.concatenate([np.asarray(c, np.float32) for _, c in batches])
    pin = np.minimum(per_image_psnr(degraded, clean), 60.0)
    return {"input_psnr": pin, "clean_share": float(np.mean(pin > DAMAGE_PSNR_MAX)),
            "mean": float(clean.mean()), "spread": float(clean.std(axis=(1, 2, 3)).mean()),
            "laplacian": hf_energy(clean)}


@pytest.mark.parametrize(("photo", "size"), [(False, 32), (True, 32), (False, 128), (True, 128)],
                         ids=["rich", "photo", "rich-128px", "photo-128px"])
def test_port_draws_match_the_reference_in_distribution(photo, size):
    ref = _stats([jsynthetic_batch(jax.random.PRNGKey(s), BATCH, JDataConfig(size=size, photo=photo))[:2]
                  for s in SEEDS])
    port = _stats([synthetic_batch(torch.Generator().manual_seed(s), BATCH, DataConfig(size=size, photo=photo))[:2]
                   for s in SEEDS])
    assert ks_2samp(port["input_psnr"], ref["input_psnr"]).statistic <= KS_DISTANCE
    assert abs(port["clean_share"] - ref["clean_share"]) <= CLEAN_SHARE, (port, ref)
    assert abs(port["mean"] - ref["mean"]) <= MOMENT and abs(port["spread"] - ref["spread"]) <= MOMENT, (port, ref)
    assert abs(port["laplacian"] / ref["laplacian"] - 1.0) <= LAPLACIAN_REL, (port, ref)
