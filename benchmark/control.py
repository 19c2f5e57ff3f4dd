"""The control of a cell's ``correct``: the plain reference put in the
program's place and computed one precision below the configuration's
(float8 e4m3 for the bf16 networks, bf16 for the float32 work around them),
judged by the same comparison against the float32 reference on the uploads
a run would sample. Its readings are the upper ends the limits are set
under; the benchmark's own runs never run it.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def sampled_uploads(pool: list, seed: int) -> list[int]:
    """Pool indices as a run samples its jobs: the largest upload, then
    others drawn from the seed."""
    import numpy as np

    from benchmark import check

    largest = max(range(len(pool)), key=lambda i: (pool[i].height * pool[i].width, i))
    rest = [i for i in range(len(pool)) if i != largest]
    rng = np.random.default_rng([seed, 3])
    n = min(len(rest), check.SAMPLE - 1)
    return [largest, *[rest[i] for i in rng.choice(len(rest), size=n, replace=False)]]


def readings(workload: str, seed: int, device: str, root: str = ROOT) -> dict:
    """The compared numbers of the control against the reference, one seed."""
    import torch

    from benchmark import check, spec, weights
    from benchmark.reference.models import Precision
    from benchmark.traffic import generator

    cell = spec.load_cell(workload, root)
    cfg = dict(cell.config, weights_path=weights.resolve(cell.config, cell.reference, root)[0])
    pool = generator.make_pool(cell.mix, seed)
    picks = sampled_uploads(pool, seed)
    uploads = {i: pool[i].data for i in picks}
    network = cell.reference.network
    ref = check.reference_answers(cfg, network, uploads, device)
    low = check.reference_answers(cfg, network, uploads, device, Precision("fp8", torch.bfloat16))
    return check.compare([low[i] for i in picks], [ref[i] for i in picks])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed, **readings(args.workload, seed, args.device)}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
