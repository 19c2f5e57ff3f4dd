"""The shipped models' gains on each package's own training draws, over many
batches: whether the port's sampler gives the reference's in-distribution
gate numbers in distribution, and how far one gate batch of eight moves.

For ``--seeds`` seeds from ``--seed``, ``synthetic_batch`` of each package
(JAX on the CPU; the port from a torch.Generator) makes ``--batch`` images
at 128 px on the rich and the photo distribution. The port's flagship
(restore-unet, on the data's conditioning) and sr-x2 (over the nearest
upscale of the 2x2-box downscale of the degraded input) run on both
packages' images in ``--dtype`` on the CPU, as eval/gates.py runs the gates.
Per package it reports the mean per-image gain over the damage rows (input
PSNR under 48 dB) with its standard error, the aggregate gain over every
row (the gates' statistic), and the mean and standard deviation of the
aggregate gain of consecutive groups of eight images (one gate batch each).
One JSON object on stdout:

    python tests/torch_draws_gain.py [--seeds 16] [--batch 32] [--seed 7000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import torch

from image_restoration_platform_tpu.train.data import DataConfig as JDataConfig
from image_restoration_platform_tpu.train.data import synthetic_batch as jsynthetic_batch
from image_restoration_platform_tpu_torch.eval import gates as G
from image_restoration_platform_tpu_torch.eval.common import DAMAGE_PSNR_MAX, DTYPES, load_model, per_image_psnr
from image_restoration_platform_tpu_torch.train.data import DataConfig, synthetic_batch

SIZE, GATE_N = 128, 8


def _batches(package: str, photo: bool, seeds, n: int):
    for s in seeds:
        if package == "ref":
            out = jsynthetic_batch(jax.random.PRNGKey(s), n, JDataConfig(size=SIZE, photo=photo))
            yield tuple(torch.from_numpy(np.asarray(a)) for a in out)
        else:
            yield synthetic_batch(torch.Generator().manual_seed(s), n, DataConfig(size=SIZE, photo=photo))


def _aggregate(pin: np.ndarray, pout: np.ndarray) -> float:
    return float(10.0 * np.log10(np.mean(10.0 ** (-pin / 10.0)) / np.mean(10.0 ** (-pout / 10.0))))


def _summary(pin: np.ndarray, pout: np.ndarray) -> dict:
    sel = pin < DAMAGE_PSNR_MAX
    gain = pout[sel] - pin[sel]
    groups = [_aggregate(pin[i:i + GATE_N], pout[i:i + GATE_N]) for i in range(0, len(pin) - GATE_N + 1, GATE_N)]
    return {"images": int(len(pin)), "damage_rows": int(sel.sum()), "input_psnr": float(pin[sel].mean()),
            "gain_db": float(gain.mean()), "gain_se_db": float(gain.std(ddof=1) / np.sqrt(len(gain))),
            "agg_gain_db": _aggregate(pin, pout), "gate_batches": len(groups),
            "gate_batch_mean_db": float(np.mean(groups)), "gate_batch_std_db": float(np.std(groups, ddof=1))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=7000)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    dtype = DTYPES[args.dtype]
    flagship, sr = load_model("restore-unet", "cpu", dtype), load_model("sr-x2", "cpu", dtype)
    seeds = range(args.seed, args.seed + args.seeds)
    report: dict = {"size": SIZE, "seeds": [seeds.start, seeds.stop - 1], "batch": args.batch, "dtype": args.dtype}
    for dist, photo in (("rich", False), ("photo", True)):
        for package in ("ref", "port"):
            rows = {"restore-unet": ([], []), "sr-x2": ([], [])}
            for degraded, clean, cond in _batches(package, photo, seeds, args.batch):
                rows["restore-unet"][0].append(per_image_psnr(degraded, clean))
                rows["restore-unet"][1].append(per_image_psnr(G.restore(flagship, degraded, cond, dtype), clean))
                lr = G.box_down(degraded, 2)
                rows["sr-x2"][0].append(per_image_psnr(G.nearest_up(lr, 2), clean))
                rows["sr-x2"][1].append(per_image_psnr(G.sr_forward(sr, lr, dtype), clean))
            for family, (pin, pout) in rows.items():
                report.setdefault(family, {}).setdefault(dist, {})[package] = _summary(
                    np.concatenate(pin), np.concatenate(pout))
            print(f"{dist} {package} done", file=sys.stderr, flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
