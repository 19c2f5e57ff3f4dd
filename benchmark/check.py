"""How ``correct`` is decided: the served answers of a sample of the
window's jobs, drawn from the seed, against the plain reference worked out
again from the same upload bytes; every job answered; one credit charged
for each job that succeeded.

Each compared number has its limit in the configuration's file
(``limits``); the run is correct when every number is at or under its limit.
"""

from __future__ import annotations

import base64

import numpy as np

from .reference.pipeline import decode

SAMPLE = 8  # served jobs compared in a run


def sample(jobs: list, pool: list, seed: int) -> list:
    """Up to ``SAMPLE`` of the jobs that succeeded, drawn from the
    seed, always with a job of the largest upload among them."""
    ok = [j for j in jobs if j.ok]
    if not ok:
        return []
    rng = np.random.default_rng([seed, 3])
    largest = max(ok, key=lambda j: (pool[j.upload].height * pool[j.upload].width, j.upload))
    rest = [j for j in ok if j is not largest]
    picks = [rest[i] for i in rng.choice(len(rest), size=min(len(rest), SAMPLE - 1), replace=False)]
    return [largest, *picks]


def pixel_gaps(served: np.ndarray, ref: np.ndarray) -> tuple[float, float]:
    """(mean, 99.9th percentile) of |served - reference| in levels; an
    answer of the wrong size is as far off as an answer can be."""
    if served.shape != ref.shape:
        return 255.0, 255.0
    d = np.abs(served.astype(np.int16) - ref.astype(np.int16))
    return float(d.mean()), float(np.percentile(d, 99.9))


def compare(answers: list[np.ndarray], refs: list[np.ndarray]) -> dict:
    """The worst gaps over a sample: ``answers`` and ``refs`` are the pixels
    per sampled job, in the same order."""
    out = {"pixel_mean_gap": 0.0, "pixel_p999_gap": 0.0}
    for pixels, ref_pixels in zip(answers, refs):
        mean, tail = pixel_gaps(pixels, ref_pixels)
        out["pixel_mean_gap"] = max(out["pixel_mean_gap"], mean)
        out["pixel_p999_gap"] = max(out["pixel_p999_gap"], tail)
    return out


def served_answer(job) -> np.ndarray:
    """The pixels of the JPEG a served job returned."""
    return decode(base64.b64decode(job.body["result"]["restoredImage"]))


def credit_gap(ledger_entries: list[dict], users: set[str], succeeded: int) -> int:
    """|credits the ledger charged the clients, net of refunds - jobs that
    succeeded|."""
    charged = -sum(int(e["amount"]) for e in ledger_entries
                   if e.get("userId") in users and e["type"] in ("free", "paid", "refund"))
    return abs(charged - succeeded)


def reference_answers(cfg: dict, network, uploads: dict[int, bytes], device, prec=None) -> dict:
    """Per pool index, the reference's pixels of the upload, through the
    configuration's reference ``network`` on the weights at
    ``cfg["weights_path"]``; ``prec`` computes them in a lower precision
    (the control)."""
    import torch

    from .reference import models, pipeline

    prec = prec or models.Precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = models.load_npz(cfg["weights_path"], device)
    with torch.inference_mode():
        return {idx: pipeline.upscale(data, cfg, network, params, device, prec) for idx, data in uploads.items()}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}); a number without a limit fails."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
