"""Quick flagship-only in-distribution eval: the rich and photo held-out
gains, one JSON line on stdout: {"rich": gain_db, "photo": gain_db}.

Port of scripts/eval_flagship_quick.py (the metric of eval.quality: the mean
per-image gain over the damage rows of ``IRP_EVAL_SEEDS`` batches, default
4), on the port's own draws, with ``--device`` and ``--dtype``:

    IRP_WEIGHTS_DIR=<dir> python -m image_restoration_platform_tpu_torch.eval.flagship_quick [--n 8] [--device cpu]
    python -m image_restoration_platform_tpu_torch.eval.flagship_quick --weights-dir <dir>

``evaluate`` returns the same JSON as a dict, for a weights directory
given in the call (the retrain chain's ranker calls it in process).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..serve.engine import resolve_device
from ..train.data import DataConfig, synthetic_batch
from . import gates
from .common import DAMAGE_PSNR_MAX, DTYPES, device_args, load_model, per_image_psnr


def evaluate(n: int = 8, size: int = 128, seed: int = 999_001, device="cuda", dtype: torch.dtype = torch.bfloat16,
             weights_dir: str | None = None) -> dict:
    """The script's JSON as a dict, for the flagship's weights in
    ``weights_dir`` (default: IRP_WEIGHTS_DIR, else weights/)."""
    device = resolve_device(device)
    model = load_model("restore-unet", device, dtype, weights_dir)
    seeds = int(os.environ.get("IRP_EVAL_SEEDS", "4"))
    out = {}
    for name, cfg in (("rich", DataConfig(size=size)), ("photo", DataConfig(size=size, photo=True))):
        gains = []
        for k in range(seeds):
            gen = torch.Generator().manual_seed(seed + k)
            degraded, clean, cond = (t.to(device) for t in synthetic_batch(gen, n, cfg))
            pred = gates.restore(model, degraded, cond, dtype)
            pin, pout = per_image_psnr(degraded, clean), per_image_psnr(pred, clean)
            gains += list((pout - pin)[pin < DAMAGE_PSNR_MAX])
        out[name] = round(float(np.mean(gains)) if gains else 0.0, 3)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=999_001)
    device_args(ap)
    args = ap.parse_args(argv)
    device, dtype = resolve_device(args.device), DTYPES[args.dtype]
    print(json.dumps(evaluate(args.n, args.size, args.seed, device, dtype, args.weights_dir)), flush=True)


if __name__ == "__main__":
    main()
