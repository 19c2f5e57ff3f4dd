"""The quality gain from classify-before-restore: the flagship on the same
degraded batches with (a) the serving conditioning (classifier scores ->
28-dim vector) and (b) an all-zero conditioning vector. Per distribution:
the two gains over the degraded input, their difference, and the
percentage improvement of the gain. One JSON line on stdout.

Port of scripts/eval_conditioning_ablation.py on the port's own draws, with
``--device`` and ``--dtype``:

    python -m image_restoration_platform_tpu_torch.eval.conditioning_ablation [--n 16] [--size 128] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from ..serve.engine import resolve_device
from ..train.data import DataConfig, synthetic_batch
from . import gates
from .common import DTYPES, device_args, load_model, psnr


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=777_001)
    device_args(ap)
    args = ap.parse_args(argv)
    device, dtype = resolve_device(args.device), DTYPES[args.dtype]
    model = load_model("restore-unet", device, dtype)
    out = {}
    for name, cfg in (("rich", DataConfig(size=args.size)), ("photo", DataConfig(size=args.size, photo=True))):
        gen = torch.Generator().manual_seed(args.seed)
        degraded, clean, cond = (t.to(device) for t in synthetic_batch(gen, args.n, cfg))
        base = psnr(degraded, clean)
        conditioned = psnr(gates.restore(model, degraded, cond, dtype), clean) - base
        neutral = psnr(gates.restore(model, degraded, torch.zeros_like(cond), dtype), clean) - base
        out[name] = {
            "gain_db_conditioned": round(conditioned, 3),
            "gain_db_neutral": round(neutral, 3),
            "delta_db": round(conditioned - neutral, 3),
            "pct": round(100.0 * (conditioned - neutral) / max(neutral, 1e-6), 1) if neutral > 0 else None,
        }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
