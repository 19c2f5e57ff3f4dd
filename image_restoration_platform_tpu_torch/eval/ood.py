"""Out-of-distribution quality: the serving inference path (classify ->
deblock -> deblur -> re-condition -> the family's backbone) over the
degradation classes and clean generators of train/ood.py, disjoint from the
training distribution; per-class PSNR gain and the bounded-harm margin on
clean OOD inputs. One JSON on stdout, a table on stderr.

Port of scripts/eval_ood.py with the same flags, the same JSON schema, and
``--device`` (default cuda) and ``--dtype`` (default bfloat16):

    python -m image_restoration_platform_tpu_torch.eval.ood [--n 48] [--size 128]
        [--family restore-unet] [--seed 2026] [--corpus ood|real] [--device cpu]
        [--weights-dir DIR]

``evaluate`` returns the same JSON as a dict, for a weights directory
given in the call (the retrain chain's ranker and gate call it in process).

train/ood.py and train/realphoto.py draw from numpy, so the same seeds give
the reference script's inputs on any machine.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..models import get_family
from ..models import weights as W
from ..serve.engine import resolve_device
from ..train.ood import OOD_DEGRADATIONS, ood_clean, ood_eval_batch
from .common import DTYPES, device_args, host, load_model, log, psnr, serving_forward


def evaluate(family_name: str = "restore-unet", n: int = 48, size: int = 128, seed: int = 2026, corpus: str = "ood",
             device="cuda", dtype: torch.dtype = torch.bfloat16, weights_dir: str | None = None) -> dict:
    """The script's JSON as a dict, for ``family_name``'s weights in
    ``weights_dir`` (default: IRP_WEIGHTS_DIR, else weights/) on ``device``."""
    device = resolve_device(device)
    if corpus == "real":
        from ..train.realphoto import available_sources
        from ..train.realphoto import real_clean_patches as clean_fn
        from ..train.realphoto import real_eval_batch as batch_fn

        log(f"real-photo sources: {len(available_sources())}")
    else:
        clean_fn, batch_fn = ood_clean, ood_eval_batch

    family = get_family(family_name)
    model = load_model(family_name, device, dtype, weights_dir)

    def serve(x):
        return host(serving_forward(family, model, x, dtype))

    report = {}
    log(f"family={family_name} n={n} size={size} corpus={corpus} device={device} dtype={str(dtype)[6:]}")
    for name in OOD_DEGRADATIONS:
        degraded, clean = batch_fn(seed, n, size, name)
        pred = serve(degraded)
        p_in, p_out = psnr(degraded, clean), psnr(pred, clean)
        report[name] = {"psnr_in": round(p_in, 2), "psnr_out": round(p_out, 2), "gain_db": round(p_out - p_in, 2)}
        log(f"  {name:20s} in {p_in:6.2f} dB -> out {p_out:6.2f} dB  (gain {p_out - p_in:+.2f} dB)")

    # bounded harm on clean OOD inputs, in aggregate and per image
    rng = np.random.default_rng(seed + 1)
    clean = clean_fn(rng, n, size)
    pred = serve(clean)
    harm_psnr = psnr(pred, clean)
    mad = float(np.mean(np.abs(pred - clean))) * 255.0
    per_mad = np.mean(np.abs(pred - clean), axis=(1, 2, 3)) * 255.0
    worst = int(np.argmax(per_mad))
    report["clean_no_harm"] = {
        "psnr_out": round(harm_psnr, 2),
        "mad_255": round(mad, 2),
        "p95_mad_255": round(float(np.percentile(per_mad, 95)), 2),
        "worst_mad_255": round(float(per_mad[worst]), 2),
        "worst_image_mean": round(float(clean[worst].mean()), 3),
    }
    log(
        f"  {'clean_no_harm':20s} out {harm_psnr:6.2f} dB  mad {mad:.2f}/255  "
        f"p95 {report['clean_no_harm']['p95_mad_255']:.2f}/255  "
        f"worst {per_mad[worst]:.2f}/255 (img mean {clean[worst].mean():.2f})"
    )
    return {"family": family_name, "n": n, "size": size, "corpus": corpus, "ood": report}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--family", default="restore-unet")
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--corpus", choices=("ood", "real"), default="ood",
                    help="ood = procedural disjoint generators (train/ood.py); real = "
                    "real photographs found on the machine (train/realphoto.py)")
    device_args(ap)
    args = ap.parse_args(argv)
    device, dtype = resolve_device(args.device), DTYPES[args.dtype]
    path = W.weights_path(args.family, args.weights_dir)
    if not os.path.exists(path):
        log(f"no shipped weights at {path}")
        raise SystemExit(1)
    print(json.dumps(evaluate(args.family, args.n, args.size, args.seed, args.corpus, device, dtype,
                              args.weights_dir)))


if __name__ == "__main__":
    main()
