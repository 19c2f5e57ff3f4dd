"""Cheaply rank flagship snapshot candidates before full promotion validation.

Port of scripts/rank_candidates.py. A chunked retrain (retrain/chip_queue.py
over a manifest of retrain/queues/) leaves one npz snapshot a chunk; the
full promotion gate (retrain/validate_staging.py) on each would be slow.
This ranks them with a reduced-n pass over BOTH OOD corpora (procedural
physics + real photographs) and, for the flagship, the in-distribution
held-out gains, and prints a composite score per candidate, so only the
winner goes through the full gate.

Composite = sum of per-class dB gains (both corpora; plus the flagship's
            rich and photo held-out gains)
          - 0.5 * clean mean-harm (/255, both corpora)
          - 0.25 * clean worst-image harm (/255, both corpora)

Harm weighting is deliberately strong: gains on degradation classes are
cheap to buy by regressing clean-input fidelity.

The evaluations run in this process on one device (``--device``, default
cuda) in bf16, the serving type, through ``eval.ood.evaluate`` and
``eval.flagship_quick.evaluate`` with each candidate's directory given in
the call, where the reference runs one subprocess per evaluation with
IRP_WEIGHTS_DIR set. On a machine without real-photo sources
(train/realphoto.py) the real corpus is left out of every candidate's score
alike, and that is logged.

Usage:
    python -m image_restoration_platform_tpu_torch.retrain.rank_candidates --dir .staging_deconv \\
        [--n 8] [--family restore-unet] [--include-shipped] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import traceback

import torch

from ..eval import flagship_quick, ood
from ..serve.engine import resolve_device
from ..train.realphoto import available_sources

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DTYPE = torch.bfloat16


def _eval_indist(weights_dir: str, n: int, device) -> dict:
    return flagship_quick.evaluate(n=n, device=device, dtype=DTYPE, weights_dir=weights_dir)


def _eval(weights_dir: str, corpus: str, n: int, family: str, device) -> dict:
    return ood.evaluate(family, n=n, corpus=corpus, device=device, dtype=DTYPE, weights_dir=weights_dir)["ood"]


def _score(ood: dict, real: dict, indist: dict | None = None) -> tuple[float, dict]:
    gains, harm = 0.0, 0.0
    detail = {}
    if indist:
        # in-distribution held-out gains count toward the composite with the
        # same weight as one OOD class each — the validator HOLDs on any
        # regression here, so the ranker must see it
        for k, v in indist.items():
            gains += v
            detail[f"indist/{k}"] = round(v, 2)
    for label, rows in (("ood", ood), ("real", real)):
        for cls, row in rows.items():
            if cls == "clean_no_harm":
                harm += 0.5 * row["mad_255"] + 0.25 * row["worst_mad_255"]
                detail[f"{label}/clean_mad"] = round(row["mad_255"], 2)
                detail[f"{label}/clean_worst"] = round(row["worst_mad_255"], 2)
            else:
                gains += row["gain_db"]
                detail[f"{label}/{cls}"] = round(row["gain_db"], 2)
    return gains - harm, detail


def rank(cand_dir: str, family: str = "restore-unet", n: int = 8, include_shipped: bool = False,
         device="cuda") -> tuple[list, list]:
    """(results sorted by score, best first; the candidates whose evaluation
    failed). ``cand_dir`` is taken from the repo root when relative."""
    device = resolve_device(device)  # no card raises here, not as a failed candidate
    cand_dir = os.path.abspath(os.path.join(REPO, cand_dir))
    fam_npz = f"{family}.npz"
    candidates = sorted(f for f in os.listdir(cand_dir) if f.endswith(".npz") and f.startswith(family))
    if include_shipped:
        candidates.insert(0, "__shipped__")
    with_real = bool(available_sources())
    if not with_real:
        print("no real-photo sources on this machine: the real corpus is left out of every score",
              file=sys.stderr, flush=True)

    results, failed = [], []
    for cand in candidates:
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(REPO, "weights", fam_npz) if cand == "__shipped__" else os.path.join(cand_dir, cand)
            shutil.copy(src, os.path.join(tmp, fam_npz))
            try:
                ood_rows = _eval(tmp, "ood", n, family, device)
                real_rows = _eval(tmp, "real", n, family, device) if with_real else {}
                indist = _eval_indist(tmp, n, device) if family == "restore-unet" else None
            except Exception:  # a candidate that cannot be evaluated is dropped, as in the reference
                print(f"{cand}: EVAL FAILED {traceback.format_exc()[-1500:]}", file=sys.stderr, flush=True)
                failed.append(cand)
                continue
            score, detail = _score(ood_rows, real_rows, indist)
            results.append({"candidate": cand, "score": round(score, 3), "detail": detail})
            print(f"{cand}: score={score:.3f} {detail}", file=sys.stderr, flush=True)

    results.sort(key=lambda r: r["score"], reverse=True)
    return results, failed


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True, help="directory of candidate npz files")
    ap.add_argument("--family", default="restore-unet")
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--include-shipped", action="store_true",
                    help="also score the currently shipped weights as a floor")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    results, _failed = rank(args.dir, args.family, args.n, args.include_shipped, args.device)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
