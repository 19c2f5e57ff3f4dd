"""Promotion gate for staged retrains: run the quality gates and the quality
matrix against a candidate weights dir and print a per-family PROMOTE /
HOLD verdict.

Port of scripts/validate_staging.py. Pass/fail alone is not a promotion
criterion (a retrain once passed every loosely calibrated gate while
regressing the real-photo corpus), so a candidate must (a) pass its
family's quality gates AND (b) not regress the currently shipped weights
(weights/) beyond a tolerance on any measured axis (procedural OOD,
real-photo corpus, held-out gains, SR smooth no-hallucination).

Step 1 runs the gates of tests/test_quality*.py as eval/gates.py computes
them (``gates.family_gates``), one family at a time on the staged weights,
where the reference runs those test files through pytest; each failed gate
is named by the reference test's node id and goes to its family through
``GATE_FAMILY``, the explicit map that gives every gate the family the
reference's ``attribute_gate_failures`` gives its node id. A family whose
gates raised never ran them, and HOLDs. The real-photo gates and axes are
left out, as the reference's gates skip, on a machine without real-photo
sources. Steps 2-3 evaluate in this process on one device with the weights
directory given in each call (``eval.quality.evaluate``,
``eval.ood.evaluate``), where the reference runs a subprocess per
evaluation with IRP_WEIGHTS_DIR set.

Usage:
    python -m image_restoration_platform_tpu_torch.retrain.validate_staging --stage .staging_weights \\
        [--family restore-unet] [--tolerance 0.5] [--device cpu]

Runs on the card by default (``--device cuda``), in bf16, the serving type.
Prints one JSON verdict line per family on stdout; human
detail on stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

import torch

from ..eval import gates as G
from ..eval import ood, quality
from ..eval.common import load_model
from ..serve.engine import resolve_device
from ..train.realphoto import available_sources

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SHIPPED = os.path.join(REPO, "weights")
DTYPE = torch.bfloat16

SR_FAMILIES = ("sr-x2", "sr-x4")
# every gate of tests/test_quality*.py, by the reference test's node id ->
# the family whose model it reads
GATE_FAMILY = {
    G.QUALITY_TESTS + "test_flagship_restoration_gain": "restore-unet",
    **{f"{G.QUALITY_TESTS}test_flagship_bounded_harm_on_near_clean[{seed}]": "restore-unet"
       for seed in G.NEAR_CLEAN_SEEDS},
    **{f"{G.QUALITY_TESTS}test_{fam.replace('-', '_')}_beats_nearest_baseline": fam for fam in SR_FAMILIES},
    **{f"{G.QUALITY_TESTS}test_sr_photo_distribution_gain[{fam}]": fam for fam in SR_FAMILIES},
    **{f"{G.QUALITY_TESTS}test_sr_no_texture_hallucination_on_smooth[{fam}]": fam for fam in SR_FAMILIES},
    **{f"{G.QUALITY_TESTS}test_diffusion_restoration_gain[{fixture}-{G.DIFFUSION_GAIN_MIN[dist]}]": "diffusion-restore"
       for dist, fixture in (("rich", "heldout"), ("photo", "heldout_photo"))},
    **{f"{G.OOD_TESTS}test_flagship_ood_gain[{name}]": "restore-unet" for name in G.OOD_GATES},
    G.OOD_TESTS + "test_flagship_motion_deblur_gain": "restore-unet",
    G.OOD_TESTS + "test_flagship_ood_clean_no_harm": "restore-unet",
    **{f"{G.REAL_TESTS}test_real_photo_gain[{name}-{bar}]": "restore-unet" for name, bar in G.REAL_GATES.items()},
    G.REAL_TESTS + "test_real_photo_clean_harm_bounded": "restore-unet",
}


def attribute_gate_failures(failed_nodes, fam):
    """Failed gate node ids attributed to ``fam`` by ``GATE_FAMILY``."""
    return [node for node in failed_nodes if GATE_FAMILY[node] == fam]


def compare_metrics(shipped: dict, staged: dict, tolerance: float):
    """(regressions, improvements) between two metric dicts.

    Clean-harm promotion rides the p95 quantile, not the per-image max: the
    max statistic over a small corpus flips by ~0.5/255 on one image's
    rounding between statistically identical candidates. worst_mad axes are
    tracked for forensics but excluded from the verdict; p95/mean axes use
    the strict tolerance (a mean harm regression still blocks). Axes the
    staged dict lacks are ignored.
    """
    regressions, improvements = {}, {}
    for k, old in shipped.items():
        new = staged.get(k)
        if new is None or k.endswith("worst_mad"):
            continue
        delta = new - old
        if delta < -tolerance:
            regressions[k] = {"shipped": round(old, 2), "staged": round(new, 2)}
        elif delta > tolerance:
            improvements[k] = {"shipped": round(old, 2), "staged": round(new, 2)}
    return regressions, improvements


def _flatten_flagship(weights_dir, device):
    """Metric dict for the flagship: procedural OOD + real corpus (where the
    machine has real-photo sources)."""
    metrics = {}
    corpora = ("ood", "real") if available_sources() else ("ood",)
    for corpus in corpora:
        rows = ood.evaluate("restore-unet", corpus=corpus, device=device, dtype=DTYPE, weights_dir=weights_dir)["ood"]
        for cls, row in rows.items():
            if cls == "clean_no_harm":
                metrics[f"{corpus}/clean_mad"] = -row["mad_255"]  # higher(-mad) = better
                metrics[f"{corpus}/clean_p95_mad"] = -row.get("p95_mad_255", row["worst_mad_255"])
                metrics[f"{corpus}/clean_worst_mad"] = -row["worst_mad_255"]  # forensics only
            else:
                metrics[f"{corpus}/{cls}"] = row["gain_db"]
    return metrics


def _flatten_family(report, fam):
    metrics = {}
    entry = report["families"].get(fam, {})
    for dist, row in entry.items():
        if fam.startswith("sr-"):
            for mode, sub in row.items():
                metrics[f"{dist}/{mode}"] = sub["gain_db"]
        else:
            metrics[f"{dist}"] = row["gain_db"]
    return metrics


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def run_gates(stage: str, fams, device) -> tuple[list, dict]:
    """(failed gate node ids, {family: whether its gates ran}) of every
    family's gates on the staged weights."""
    failed_nodes, ran = [], {}
    if not available_sources():
        _log("    no real-photo sources on this machine: the real-photo gates are skipped")
    for fam in fams:
        if fam not in GATE_FAMILY.values():
            ran[fam] = True  # no gate reads this family
            continue
        try:
            model = load_model(fam, device, DTYPE, stage)
            checks = G.family_gates(fam, model, DTYPE, device)
        except Exception:
            _log(f"    {fam}: the gates raised, so they never ran\n{traceback.format_exc()[-2000:]}")
            ran[fam] = False
            continue
        ran[fam] = True
        for node, message in checks.items():
            if message:
                failed_nodes.append(node)
                _log(f"    FAILED {node}: {message}")
        _log(f"    {fam}: {len(checks)} gates, {sum(1 for m in checks.values() if m)} failed")
        del model
    return failed_nodes, ran


def validate(stage: str, fams=None, tolerance: float = 0.5, device="cuda", axes: dict | None = None) -> list:
    """One verdict row per family (every family with a staged npz that
    weights/ also holds, when ``fams`` is None), evaluated in bf16, the
    serving type; ``stage`` is taken from the repo root when relative.
    ``axes``, when given, is filled with {family: {"shipped": metrics,
    "staged": metrics}}, the dicts compared."""
    device = resolve_device(device)
    stage = os.path.abspath(os.path.join(REPO, stage))
    if not fams:
        fams = sorted(
            f[: -len(".npz")]
            for f in os.listdir(stage)
            if f.endswith(".npz") and os.path.exists(os.path.join(SHIPPED, f))
        )

    # 1. the quality gates on the staged dir (hard requirement), attributed
    #    per family so one family's red gate cannot HOLD every other family
    _log(f"[1/3] quality gates against {stage} ...")
    failed_nodes, gates_ran = run_gates(stage, fams, device)

    # 2. numeric comparison vs shipped, family by family, restricted to the
    #    families under test
    _log("[2/3] held-out table (eval.quality) for shipped and staged ...")
    shipped_q = quality.evaluate(families=fams, device=device, dtype=DTYPE, weights_dir=SHIPPED)
    staged_q = quality.evaluate(families=fams, device=device, dtype=DTYPE, weights_dir=stage)

    need_flagship = "restore-unet" in fams
    shipped_f = staged_f = {}
    if need_flagship:
        _log("[3/3] flagship OOD + real corpus for shipped and staged ...")
        shipped_f = _flatten_flagship(SHIPPED, device)
        staged_f = _flatten_flagship(stage, device)

    rows = []
    for fam in fams:
        shipped = _flatten_family(shipped_q, fam)
        staged = _flatten_family(staged_q, fam)
        if fam == "restore-unet":
            shipped.update(shipped_f)
            staged.update(staged_f)
        if axes is not None:
            axes[fam] = {"shipped": shipped, "staged": staged}
        regressions, improvements = compare_metrics(shipped, staged, tolerance)
        fam_failures = attribute_gate_failures(failed_nodes, fam)
        gates_green = gates_ran[fam] and not fam_failures
        verdict = "PROMOTE" if gates_green and not regressions else "HOLD"
        row = {
            "family": fam,
            "verdict": verdict,
            "gates_green": gates_green,
            "gate_failures": fam_failures,
            "regressions": regressions,
            "improvements": improvements,
        }
        _log(f"{fam}: {verdict}  (+{len(improvements)} improved, "
             f"-{len(regressions)} regressed beyond {tolerance})")
        for k, v in regressions.items():
            _log(f"    REGRESSED {k}: {v['shipped']} -> {v['staged']}")
        for k, v in improvements.items():
            _log(f"    improved  {k}: {v['shipped']} -> {v['staged']}")
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", default=".staging_weights")
    ap.add_argument("--family", action="append", default=None,
                    help="repeatable; default: every family with a staged npz")
    ap.add_argument("--tolerance", type=float, default=0.5,
                    help="max allowed regression vs shipped (dB, or /255 for mad axes)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return validate(args.stage, args.family, args.tolerance, args.device)


if __name__ == "__main__":
    main()
