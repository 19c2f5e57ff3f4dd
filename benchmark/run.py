"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the port's service (``AppContext(device="cuda")``, ``Config()``
defaults and the configuration's serving settings, the shipped weights or
the configuration's seeded ones, ``benchmark/weights.py``),
makes the cell's uploads from the seed, warms the cell's own shapes, then
drives ``api/submit.py:submit_job(sync=True)`` for ``--seconds`` and prints,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each compared number with its limit).
The same numbers end standard error. Without a CUDA card, or with fewer
cards than the cell asks for, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "image_restoration_platform_tpu")
# settings a deployment's environment could carry that would change the
# served configuration or reach outside the machine: each run starts from
# Config() defaults and the configuration file's serving settings
DROPPED_ENV_PREFIXES = ("SERVE_", "JOBS_", "CREDITS_", "RATE_LIMIT_", "MESH_", "RESTORATION_", "GCS_")
DROPPED_ENV = ("VISION_API_KEY", "VISION_ACCESS_TOKEN", "REDIS_URL", "DURABLE_DB_PATH", "BLOB_STORE_PATH",
               "IRP_WEIGHTS_DIR", "IMAGEIO_MAX_INPUT_PIXELS", "DEVICE_COST_PER_HOUR_USD")


def process_start() -> float:
    """The process's start as ``time.time()``, from /proc (0.01 s steps);
    the interpreter's own start-up counts as set-up."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_PROCESS = process_start()


def prepare_environment(root: str) -> None:
    for key in list(os.environ):
        if key.startswith(DROPPED_ENV_PREFIXES) or key in DROPPED_ENV:
            del os.environ[key]
    os.environ["LOG_LEVEL"] = "warning"
    os.environ["USE_FLAX"] = "0"
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")


@dataclass
class Run:
    """What one run measured, as the metric readers read it."""

    cell: object
    seconds: float
    window: tuple[float, float]
    jobs: list
    setup_s: float
    counters: dict = field(default_factory=dict)
    trace: object = None
    spans: object = None
    peaks: dict = field(default_factory=dict)

    @property
    def config(self) -> dict:
        return self.cell.config

    def counter(self, prefix: str) -> float:
        return sum(v for k, v in self.counters.items() if k.startswith(prefix))


def card(device: str) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "power_limit": "none"}
    limit = "unknown"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        limit = out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else limit
    except (OSError, subprocess.SubprocessError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1, "power_limit": limit}


def forbidden_modules() -> list[str]:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def _window(ctx, cell, pool, seed, seconds, trace):
    """Drive the window on a thread of its own while this thread, the one
    that made the CUDA context, profiles the middle of it (``trace``);
    returns (jobs, t_start, t_end, trace result)."""
    from benchmark import drive
    from benchmark import trace as trace_mod

    if cell.mix["loop"]["kind"] != "closed":
        raise ValueError(f"unknown loop {cell.mix['loop']['kind']!r}")
    t_start = time.perf_counter() + 0.05
    out: dict = {}

    def drive_window():
        try:
            out["jobs"] = drive.closed_loop(ctx, pool, cell.mix, seed, t_start, seconds)
        except BaseException as error:  # re-raised on the calling thread
            out["error"] = error

    window = threading.Thread(target=drive_window, name="bench-window")
    window.start()
    traced: dict = {}
    if trace:
        length = min(5.0, seconds / 3.0)
        traced = trace_mod.record(t_start + (seconds - length) / 2.0, length)
    window.join()
    if "error" in out:
        raise out["error"]
    return out["jobs"], t_start, t_start + seconds, traced


def execute(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda", root: str = ROOT,
            hooks=None) -> tuple[dict, list[str]]:
    """One run; returns (the result object, the lines for standard error).
    ``hooks(ctx)``, for tests, may alter the service before the window."""
    import torch

    from benchmark import check, drive, spec, weights
    from benchmark.traffic import generator

    marks = {"imports": time.time()}
    if trace and device == "cuda":
        from benchmark import trace as trace_mod

        trace_mod.initialise()
        marks["profiler"] = time.time()
    cell = spec.load_cell(workload, root)
    weights_path, weights_dir = weights.resolve(cell.config, cell.reference, root)
    if weights_dir is not None:  # seeded weights: the program reads them as a deployment's weights directory
        os.environ["IRP_WEIGHTS_DIR"] = weights_dir
    cfg = dict(cell.config, weights_path=weights_path)
    cell.config = cfg
    clients = int(cell.mix["loop"]["clients"])
    users = [f"client{c}" for c in range(clients)]

    pool_box: dict = {}

    def make_pool():
        pool_box["pool"] = generator.make_pool(cell.mix, seed, workers=max(2, min(8, (os.cpu_count() or 2) - 1)))
        marks["pool"] = time.time()

    maker = threading.Thread(target=make_pool, name="bench-pool")
    maker.start()
    import image_restoration_platform_tpu_torch.api.submit as submit_module
    from image_restoration_platform_tpu_torch.obs.metrics import get_counters

    submit_job = submit_module.submit_job

    ctx = drive.build_service(cfg, device)
    marks["service"] = time.time()
    maker.join()
    pool = pool_box["pool"]
    warmed = drive.warm(ctx, cfg, pool)
    marks["warm-up"] = time.time()
    drive.grant(ctx, users)
    # the host path once, at the window's concurrency, before the window
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=clients) as warm_pool:
        warm_jobs = list(warm_pool.map(lambda i: drive.submit(ctx, drive.Job(i, i % len(pool), 0.0),
                                                               pool[i % len(pool)], cell.mix.get("options", {})),
                                       range(clients)))
    marks["warm round"] = time.time()
    if hooks is not None:
        hooks(ctx)
    spans = None
    if trace:
        spans = drive.Spans()
        spans.install(ctx, submit_module)
    compile_before = ctx.engine.compile_count
    counters_before = get_counters().snapshot()
    ledger_before = len(ctx.ledger.entries())
    if device == "cuda":
        torch.cuda.synchronize()

    try:
        jobs, t0, t1, traced = _window(ctx, cell, pool, seed, seconds, trace)
    finally:
        submit_module.submit_job = submit_job
    setup_s = (time.time() - (time.perf_counter() - t0)) - T_PROCESS

    counters_after = get_counters().snapshot()
    counters = {k: counters_after.get(k, 0.0) - counters_before.get(k, 0.0) for k in counters_after}
    compile_delta = ctx.engine.compile_count - compile_before
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    info = card(device)
    run = Run(cell, seconds, (t0, t1), jobs, setup_s, counters, traced.get("trace"), spans,
              spec.peaks(info["kind"], root) if device == "cuda" else {})
    metrics = {}
    for metric in (cell.per_layer if trace else cell.end_to_end):
        value = metric.read(run)
        if value is not None:
            metrics[metric.name] = {"value": float(value), "unit": metric.unit}

    # correctness: answers read now, the program freed, then the reference
    sampled = check.sample(jobs, pool, seed)
    answers = [check.served_answer(j) for j in sampled]
    ok_jobs = sum(j.ok for j in jobs)
    credit_gap = check.credit_gap(ctx.ledger.entries()[ledger_before:], set(users), ok_jobs)
    ctx.shutdown()
    del ctx, spans, run
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    refs = check.reference_answers(cfg, cell.reference.network, {j.upload: pool[j.upload].data for j in sampled},
                                   device)
    # no answer at all compares as the worst gap
    numbers = check.compare(answers, [refs[j.upload] for j in sampled]) if sampled else {"pixel_mean_gap": 255.0}
    numbers["failed_jobs"] = float(len(jobs) - ok_jobs + sum(not j.ok for j in warm_jobs))
    numbers["credit_gap"] = float(credit_gap)
    correct, checks = check.verdict(numbers, cfg["limits"])
    ref_s = time.perf_counter() - t_ref

    lines = [
        f"card: {info['kind']}, power limit {info['power_limit']}",
        f"window: {len(jobs)} jobs, {ok_jobs} succeeded, {seconds} s; set-up {setup_s:.3f} s, of it warm-up "
        f"{warmed.pop('seconds'):.3f} s of {warmed}; reference {ref_s:.3f} s over {len(sampled)} jobs",
        "set-up marks, s from the process's start: "
        + ", ".join(f"{k} {v - T_PROCESS:.3f}" for k, v in sorted(marks.items(), key=lambda kv: kv[1])),
        f"compile_count delta over the window: {compile_delta}",
    ]
    if trace:
        lines.append(f"trace: {traced['trace'].note if traced.get('trace') else traced.get('error')}")
    found = forbidden_modules()
    if found:
        return {}, lines + [f"refused: the process holds {', '.join(found)}"]
    lines += [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]

    result = {
        "correct": bool(correct),
        "attempted": len(jobs),
        "failed": len(jobs) - ok_jobs,
        "metrics": metrics,
        "device": {"platform": info["platform"], "kind": info["kind"], "count": 1, "memory_peak_bytes": int(peak)},
    }
    if trace and traced.get("trace") is not None:
        t = traced["trace"]
        result["device"]["busy_s"] = t.busy_ns() * 1e-9
        result["device"]["window_s"] = t.window_s
        result["breakdown"] = t.breakdown()
    result["checks"] = checks
    return result, lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    prepare_environment(ROOT)
    import torch

    from benchmark import spec

    chips = spec.load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import image_restoration_platform_tpu_torch  # noqa: F401
    except ImportError as error:
        print(f"the program is not here: {error}", file=sys.stderr)
        return 3
    result, lines = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    for line in lines:
        print(line, file=sys.stderr)
    if not result:
        return 4
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
