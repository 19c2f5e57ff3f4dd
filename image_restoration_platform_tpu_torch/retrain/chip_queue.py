"""Manifest-driven, health-gated card work queue: training top-ups, device
measurements and bench headlines walked from one JSON manifest.

Port of scripts/chip_queue.py. The ``Runner`` state machine is the
reference's, unchanged in behaviour: it walks a JSON manifest of payloads,
keeps ``.done`` / ``.failed`` / ``.attempts`` state files so a queue survives
a restart, and stops at a cutoff. What changes is the probe: it asks the
CUDA card, not a TPU tunnel.

Probe tiers (``PROBE_TIERS``, the reference's numbers): "alive" moves 1 MB
of fresh device memory to the host within 60 s (130 s subprocess cap);
"healthy" moves 12 MB within 5 s (200 s cap); "none" runs unconditionally.
The probe asserts that a CUDA device is present, so without a card every
tier but "none" fails: nothing falls back to the CPU. Probes run in a
killable subprocess so a wedged card cannot hang the runner itself, and
the runner never probes while a payload runs.

Manifest: JSON list of payload objects, run in order, looping until all are
done/failed or the cutoff is reached:
  {
    "name": "flagship_chunk3",          # unique; state key
    "cmd": "python -m ...",              # sh -c string, run from the repo root
    "env": {"TRAIN_SEED": "523"},       # extra env
    "probe": "alive" | "healthy" | "none",
    "min_remaining": 600,                # skip if fewer seconds to cutoff
    "skip_if": "path",                   # already-done marker (optional)
    "success_grep": "training done",     # in log; default rc==0
    "post": "cp a b",                    # sh -c on success (optional)
    "max_attempts": 2                    # default 2
  }
State lives in <logdir>/<name>.{done,failed,attempts}; restart-safe.

The port's manifests (retrain/queues/r5_anchor.json, r5_main.json) are the
reference's (scripts/queues/) payload for payload; only a ``cmd`` that runs
the reference package or a TPU measurement script is translated:
  - the reference package's ``python -m <package>.train``
    -> ``python -m image_restoration_platform_tpu_torch.train``;
  - ``scripts/measure_attention.py`` (attn_autotune)
    -> ``python chip_smoke.py --plan-sweep`` (every attention plan timed);
  - ``scripts/measure_step_profiled.py`` (step_profiled)
    -> ``python chip_smoke.py --graphs-only`` (the profiled graph phase);
  - ``python bench.py`` (bench_headline)
    -> ``python -m image_restoration_platform_tpu_torch.bench``.

Usage:
  python -m image_restoration_platform_tpu_torch.retrain.chip_queue \\
      --manifest image_restoration_platform_tpu_torch/retrain/queues/r5_main.json \\
      --cutoff-epoch 1789000000 [--logdir /tmp/chipq]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
QUEUES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "queues")

_PROBE_SRC = """
import time, numpy as np, torch
assert torch.cuda.is_available() and torch.cuda.device_count() > 0
mb = {mb}
a = np.random.default_rng(int(time.time()) % 2**31).integers(
    0, 255, (1024, 1024, mb), dtype=np.uint8)
d = torch.from_numpy(a).to("cuda"); torch.cuda.synchronize()
t0 = time.perf_counter()
d.cpu().numpy()
dt = time.perf_counter() - t0
print(f"d2h {{mb}}MB {{dt:.2f}}s")
assert dt < {limit}
"""

PROBE_TIERS = {
    # tier: (payload MB, in-probe latency limit s, subprocess cap s); the
    # caps leave time for the interpreter's start and the CUDA context on
    # top of the D2H limit
    "alive": (1, 60.0, 130),
    "healthy": (12, 5.0, 200),
}


def probe(tier: str) -> bool:
    """Run a fresh-buffer D2H probe of the card in a killable subprocess."""
    if tier == "none":
        return True
    mb, limit, cap = PROBE_TIERS[tier]
    try:
        r = subprocess.run(
            [sys.executable, "-c", _PROBE_SRC.format(mb=mb, limit=limit)],
            timeout=cap, capture_output=True, text=True,
        )
        return r.returncode == 0
    except subprocess.TimeoutExpired:
        return False


class Runner:
    def __init__(self, manifest, cutoff_epoch, logdir):
        self.manifest = manifest
        self.cutoff = cutoff_epoch
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)

    def remain(self) -> float:
        return self.cutoff - time.time()

    def _state(self, name, kind):
        return os.path.join(self.logdir, f"{name}.{kind}")

    def _log(self, msg):
        line = f"{time.strftime('%H:%M:%S', time.gmtime())} {msg}"
        print(line, flush=True)
        with open(os.path.join(self.logdir, "runner.log"), "a") as f:
            f.write(line + "\n")

    def _attempts(self, name):
        p = self._state(name, "attempts")
        return int(open(p).read()) if os.path.exists(p) else 0

    def _bump_attempts(self, name):
        n = self._attempts(name) + 1
        with open(self._state(name, "attempts"), "w") as f:
            f.write(str(n))
        return n

    def payload_status(self, p):
        name = p["name"]
        if os.path.exists(self._state(name, "done")):
            return "done"
        if os.path.exists(self._state(name, "failed")):
            return "failed"
        skip = p.get("skip_if")
        if skip and os.path.exists(os.path.join(REPO, skip)):
            return "done"
        return "pending"

    def run_payload(self, p) -> str:
        name = p["name"]
        if self.remain() < p.get("min_remaining", 300):
            return "deferred"  # terminal this pass; cutoff check ends loop
        tier = p.get("probe", "alive")
        if not probe(tier):
            self._log(f"{name}: card not {tier}")
            return "blocked"
        attempt = self._bump_attempts(name)
        log = os.path.join(self.logdir, f"{name}.log")
        env = dict(os.environ, **{k: str(v) for k, v in p.get("env", {}).items()})
        budget = max(60, int(self.remain()) - 120)
        self._log(f"{name}: start attempt {attempt} (budget {budget}s)")
        with open(log, "a") as lf:
            lf.write(f"\n==== attempt {attempt} {time.ctime()} ====\n")
            lf.flush()
            try:
                r = subprocess.run(
                    ["/bin/sh", "-c", p["cmd"]], cwd=REPO, env=env,
                    stdout=lf, stderr=subprocess.STDOUT, timeout=budget,
                )
                rc = r.returncode
            except subprocess.TimeoutExpired:
                rc = -9
        grep = p.get("success_grep")
        ok = (rc == 0) and (not grep or grep in open(log, errors="replace").read())
        self._log(f"{name}: rc={rc} ok={ok}")
        if ok:
            post = p.get("post")
            if post:
                pr = subprocess.run(["/bin/sh", "-c", post], cwd=REPO)
                if pr.returncode != 0:
                    self._log(f"{name}: post hook rc={pr.returncode}")
            open(self._state(name, "done"), "w").close()
            return "done"
        if attempt >= p.get("max_attempts", 2):
            open(self._state(name, "failed"), "w").close()
            self._log(f"{name}: giving up after {attempt} attempts")
            return "failed"
        return "retry"

    def run(self):
        while self.remain() > 120:
            pending = [p for p in self.manifest if self.payload_status(p) == "pending"]
            if not pending:
                break
            progressed = False
            for p in pending:
                if self.remain() < 120:
                    break
                st = self.run_payload(p)
                if st in ("done", "failed"):
                    progressed = True
                # "blocked"/"retry"/"deferred": move on, revisit next pass
            if not progressed:
                # everything blocked on the card; wait before re-probing
                self._log(f"all blocked; sleeping 90s ({int(self.remain())}s left)")
                time.sleep(90)
        summary = {p["name"]: self.payload_status(p) for p in self.manifest}
        self._log("summary " + json.dumps(summary))
        with open(os.path.join(self.logdir, "SUMMARY.json"), "w") as f:
            json.dump(summary, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--cutoff-epoch", type=float, required=True)
    ap.add_argument("--logdir", default="/tmp/chipq")
    args = ap.parse_args(argv)
    with open(args.manifest) as f:
        manifest = json.load(f)
    names = [p["name"] for p in manifest]
    assert len(names) == len(set(names)), "duplicate payload names"
    Runner(manifest, args.cutoff_epoch, args.logdir).run()


if __name__ == "__main__":
    main()
