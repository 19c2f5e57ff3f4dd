"""Full quality table over the shipped weights: every family on both
held-out distributions, plus the SR smooth axis. One JSON on stdout, a human
table on stderr.

Port of scripts/eval_quality.py, with the same flags and the same JSON
schema, and ``--device`` (default cuda) and ``--dtype`` (default bfloat16,
the serving type) beside them:

    python -m image_restoration_platform_tpu_torch.eval.quality [--n 8] [--seeds 4]
        [--size 128] [--seed 999001] [--family NAME ...] [--device cpu] [--dtype float32]
        [--weights-dir DIR]

``evaluate`` returns the same JSON as a dict, for a weights directory
given in the call (the retrain chain's gate calls it in process).

``gain_db`` is the mean per-image PSNR gain over the damage rows (input
PSNR under 48 dB) of ``--seeds`` independent batches; ``agg_gain_db`` is the
aggregate over every row. The batches are the port's own ``synthetic_batch``
draws (a torch.Generator seeded with ``--seed + k`` on the CPU), so they are
not the reference script's numbers: the same distributions, other samples.
SR families report gain over nearest-neighbour upsampling of the 2x2-box
downscale of the clean image and of the degraded input.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..models import get_family
from ..models import weights as W
from ..serve.engine import resolve_device
from ..train.data import DataConfig, synthetic_batch
from . import gates
from .common import DTYPES, device_args, gain_stats, load_model, log, per_image_psnr, smooth_batch, tensor


def _batch(seed: int, n: int, cfg: DataConfig, device):
    gen = torch.Generator().manual_seed(seed)
    return tuple(t.to(device) for t in synthetic_batch(gen, n, cfg))


def evaluate(n: int = 8, seeds: int = 4, size: int = 128, seed: int = 999_001, families=None, device="cuda",
             dtype: torch.dtype = torch.bfloat16, weights_dir: str | None = None) -> dict:
    """The script's JSON as a dict, over the families in ``families`` (all
    when None) whose npz is in ``weights_dir`` (default: IRP_WEIGHTS_DIR,
    else weights/), on ``device``."""
    device = resolve_device(device)

    def family_wanted(name):
        return (families is None or name in families) and os.path.exists(W.weights_path(name, weights_dir))

    dists = {"rich": DataConfig(size=size), "photo": DataConfig(size=size, photo=True)}
    report: dict = {}

    for fam_name in ("restore-unet", "restore-unet-small", "diffusion-restore"):
        if not family_wanted(fam_name):
            continue
        model = load_model(fam_name, device, dtype, weights_dir)
        entry = {}
        for dname, dcfg in dists.items():
            pins, pouts = [], []
            for k in range(seeds):
                deg, clean, cond = _batch(seed + k, n, dcfg, device)
                if get_family(fam_name).kind == "diffusion":
                    noise = gates.diffusion_noise(deg.shape, device, dtype)
                    pred = gates.diffusion_restore(model, deg, cond, noise, dtype)
                else:
                    pred = gates.restore(model, deg, cond, dtype)
                pins.append(per_image_psnr(deg, clean))
                pouts.append(per_image_psnr(pred, clean))
            gain, agg, used = gain_stats(pins, pouts)
            entry[dname] = {"gain_db": round(gain, 2), "agg_gain_db": round(agg, 2), "damage_rows": used}
            log(f"{fam_name:22s} {dname:6s}: per-image {gain:+.2f} dB over {used} damage rows (agg {agg:+.2f})")
        report[fam_name] = entry

    for fam_name in ("sr-x2", "sr-x4"):
        if not family_wanted(fam_name):
            continue
        model = load_model(fam_name, device, dtype, weights_dir)
        s = model.config.scale
        entry = {}
        pins, pouts = [], []
        for k in range(seeds):
            smooth_hr = tensor(smooth_batch(seed + 9000 + k, n, size), device)
            lo = gates.box_down(smooth_hr, s)
            pins.append(per_image_psnr(gates.nearest_up(lo, s), smooth_hr))
            pouts.append(per_image_psnr(gates.sr_forward(model, lo, dtype), smooth_hr))
        gain, agg, used = gain_stats(pins, pouts, damage_only=False)
        entry["smooth"] = {"clean": {"gain_db": round(gain, 2), "agg_gain_db": round(agg, 2)}}
        log(f"{fam_name:22s} smooth clean   : per-image {gain:+.2f} dB (agg {agg:+.2f})")

        for dname, dcfg in dists.items():
            sub = {m: ([], []) for m in ("clean", "degraded")}
            for k in range(seeds):
                deg, clean, _ = _batch(seed + k, n, dcfg, device)
                for mode, src in (("clean", clean), ("degraded", deg)):
                    lo = gates.box_down(src, s)
                    sub[mode][0].append(per_image_psnr(gates.nearest_up(lo, s), clean))
                    sub[mode][1].append(per_image_psnr(gates.sr_forward(model, lo, dtype), clean))
            entry[dname] = {}
            for mode, (pi, po) in sub.items():
                # every row is a meaningful SR task
                gain, agg, _ = gain_stats(pi, po, damage_only=False)
                entry[dname][mode] = {"gain_db": round(gain, 2), "agg_gain_db": round(agg, 2)}
                log(f"{fam_name:22s} {dname:6s} {mode:8s}: per-image {gain:+.2f} dB (agg {agg:+.2f})")
        report[fam_name] = entry

    return {"n": n, "seeds": seeds, "size": size, "families": report}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--seeds", type=int, default=4, help="independent batches per axis")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=999_001)
    ap.add_argument("--family", action="append", default=None,
                    help="repeatable; restrict to these families (default: all)")
    device_args(ap)
    args = ap.parse_args(argv)
    device, dtype = resolve_device(args.device), DTYPES[args.dtype]
    print(json.dumps(evaluate(args.n, args.seeds, args.size, args.seed, args.family, device, dtype,
                              args.weights_dir)))


if __name__ == "__main__":
    main()
