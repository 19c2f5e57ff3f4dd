"""The system under test and the load on it: the port's service graph built
as a deployment runs it, warmed on the cell's own shapes, and driven
through ``api/submit.py:submit_job(sync=True)`` by closed-loop clients for
a fixed window.

Every job is timed by the host's clock from its send. With ``spans`` the
benchmark's own timers wrap the layers' entry points on the service's
instances (the program's files are not changed).
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from .traffic import generator

CREDITS_PER_CLIENT = 10**7
# what the vision service answers for an ordinary photograph
SAFE_SEARCH_CLEAR = {"adult": "VERY_UNLIKELY", "violence": "VERY_UNLIKELY", "racy": "VERY_UNLIKELY",
                     "spoof": "VERY_UNLIKELY", "medical": "VERY_UNLIKELY"}


@dataclasses.dataclass
class Job:
    client: int
    upload: int
    due: float
    start: float = 0.0
    end: float = 0.0
    status: int = 0
    ok: bool = False
    body: dict | None = None
    error: str = ""


def build_service(cfg: dict, device: str):
    """The port's ``AppContext`` with ``Config()`` defaults and the
    configuration's serving settings, jobs and blobs in memory, and its
    moderation answered by ``vision_backend``."""
    from image_restoration_platform_tpu_torch.api.context import AppContext
    from image_restoration_platform_tpu_torch.config import Config
    from image_restoration_platform_tpu_torch.serve.moderation import ModerationService

    config = Config()
    serving = cfg["serving"]
    fields = {f.name for f in dataclasses.fields(config.serving)}
    overrides = {k: (tuple(v) if isinstance(v, list) else v) for k, v in serving.items() if k in fields}
    config.serving = dataclasses.replace(config.serving, **overrides)
    config.upload = dataclasses.replace(config.upload, max_dimension=serving["max_dimension"],
                                        jpeg_quality=serving["upload_jpeg_quality"])
    ctx = AppContext(config=config, device=device)
    ctx.moderation = ModerationService(vision_client=vision_backend, audit_log=ctx.moderation.audit)
    return ctx


def vision_backend(image_bytes: bytes) -> dict:
    """The moderation's vision service, as a deployment configures one: it
    clears the synthetic photographs, as the real service clears ordinary
    photographs. The program's own stand-in for an unconfigured service
    refuses an upload by its length in bytes, which would tie the traffic to
    that rule."""
    return dict(SAFE_SEARCH_CLEAR)


def bucket_of(longest: int, buckets) -> int:
    return next((b for b in sorted(buckets) if longest <= b), max(buckets))


def warm(ctx, cfg: dict, pool: list) -> dict:
    """Build every executable the cell's traffic can reach: the tiled SR
    program at each canvas the pool lands on, in the egress the restorator
    takes on this machine."""
    from image_restoration_platform_tpu_torch import imageio

    if cfg["surface"] != "sr_tiled":
        raise ValueError(f"unknown surface {cfg['surface']!r}")
    engine, arch = ctx.engine, cfg["arch"]
    t0 = time.perf_counter()
    buckets = [*cfg["serving"]["size_buckets"], arch["tiled_canvas"]]
    canvases = sorted({bucket_of(max(u.height, u.width), buckets) for u in pool})
    if canvases[0] <= arch["direct_max"]:
        raise ValueError("the mix sends uploads to the direct SR path, which this surface does not warm")
    outputs = ("yuv420", "rgb") if imageio.native_available() else ("rgb",)
    for canvas in canvases:
        for output in outputs:
            engine.sr_tiled(np.zeros((canvas, canvas, 3), np.uint8), cfg["family"], tile=arch["tile"],
                            overlap=arch["overlap"], tile_batch=arch["tile_batch"], output=output)
    return {"seconds": time.perf_counter() - t0, "canvas": canvases, "outputs": list(outputs)}


def grant(ctx, users: list[str]) -> None:
    """Paid credits for each client, as the admin grant route gives them."""
    for user in users:
        ctx.user_store.grant(user, CREDITS_PER_CLIENT)
        ctx.store.delete(f"credits:{user}")


def submit(ctx, job: Job, upload, options: dict) -> Job:
    from image_restoration_platform_tpu_torch.api.submit import submit_job
    from image_restoration_platform_tpu_torch.problem import Problem

    job.start = time.perf_counter()
    try:
        status, body, _ = submit_job(ctx, {"id": f"client{job.client}"}, [(upload.filename, upload.data)],
                                     options=dict(options), sync=True)
        job.status, job.body, job.ok = status, body, status == 200
    except Problem as problem:
        job.status, job.error = problem.status, str(problem.detail)
    except Exception as error:  # noqa: BLE001 - a failed job is counted, the run goes on
        job.status, job.error = 500, repr(error)
    job.end = time.perf_counter()
    return job


def closed_loop(ctx, pool, mix: dict, seed: int, t_start: float, seconds: float) -> list[Job]:
    """``clients`` threads, each sending its next job when the last returns,
    from ``t_start`` until the window closes; jobs in flight then finish."""
    clients = int(mix["loop"]["clients"])
    orders = generator.client_orders(len(pool), clients, 100000, seed)
    jobs: list[list[Job]] = [[] for _ in range(clients)]
    t_end = t_start + seconds

    def client(c):
        i = 0
        while time.perf_counter() < t_end:
            job = Job(c, orders[c][i], due=time.perf_counter())
            jobs[c].append(submit(ctx, job, pool[job.upload], mix.get("options", {})))
            i += 1

    threads = [threading.Thread(target=client, args=(c,), name=f"bench-client-{c}") for c in range(clients)]
    while time.perf_counter() < t_start:
        time.sleep(0.0005)
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [j for js in jobs for j in js]


class Spans:
    """The benchmark's timers around the service's layers, installed on its
    instances for the traced run: per job the seconds in ``submit_job``, in
    the restorator and in what the restorator waits for (the engine's tiled
    call)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records: list[tuple[str, int, float, float]] = []

    def _timed(self, name, fn):
        import torch

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(f"bench.{name}"):
                    return fn(*args, **kwargs)
            finally:
                with self.lock:
                    self.records.append((name, threading.get_ident(), t0, time.perf_counter()))

        return wrapper

    def install(self, ctx, submit_module) -> None:
        ctx.restorator.restore = self._timed("restore", ctx.restorator.restore)
        ctx.engine.sr_tiled = self._timed("wait", ctx.engine.sr_tiled)
        submit_module.submit_job = self._timed("submit", submit_module.submit_job)

    def self_ms(self, outer: str, inner: str, t0: float, t1: float) -> float | None:
        """Mean ms of the ``outer`` spans that lie in [t0, t1], less the
        ``inner`` spans of the same thread inside each."""
        with self.lock:
            records = list(self.records)
        inner_by_thread: dict[int, list[tuple[float, float]]] = {}
        for n, tid, a, b in records:
            if n == inner:
                inner_by_thread.setdefault(tid, []).append((a, b))
        selfs = []
        for n, tid, a, b in records:
            if n == outer and t0 <= a and b <= t1:
                covered = sum(y - x for x, y in inner_by_thread.get(tid, ()) if a <= x and y <= b)
                selfs.append(b - a - covered)
        return 1000.0 * sum(selfs) / len(selfs) if selfs else None
