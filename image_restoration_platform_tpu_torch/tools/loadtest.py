"""Concurrent load test against a running server (continuous micro-batched
serving under concurrent traffic).

Port of scripts/loadtest.py, with the port's imageio and measure guard; the
same arguments, summary line and JSON record:

    python -m image_restoration_platform_tpu_torch.tools.loadtest [base_url] [n_requests] [concurrency]

Prints throughput and latency percentiles; the server's /metrics endpoint
shows the realised device batch sizes. The credit grant hits an admin
route: start the server with ADMIN_DEV_OPEN=1 (or put the loadtest user in
ADMIN_USERS), since admin routes are fail-closed by default. aiohttp is
imported inside ``main`` (a machine without it still imports the module).
"""

from __future__ import annotations

import asyncio
import json
import sys
import time
import uuid

import numpy as np

from .. import imageio
from ..utils.measure_guard import stamp


async def one_request(session, base, photo, results):
    import aiohttp

    form = aiohttp.FormData()
    form.add_field("image", photo, filename="load.jpg", content_type="image/jpeg")
    t0 = time.perf_counter()
    async with session.post(
        f"{base}/v1/jobs?sync=1",
        data=form,
        headers={
            "Authorization": "Bearer dev-user-loadtest",
            "Idempotency-Key": str(uuid.uuid4()),
        },
    ) as resp:
        body = await resp.json()
        ok = resp.status == 200 and body.get("result", {}).get("success")
        results.append((ok, (time.perf_counter() - t0) * 1000))


async def server_probe(session, base):
    """Ask the SERVER to run the fresh-buffer D2H probe (it owns the card;
    this process opens no device). Returns the measure_guard record, or
    ok=False on any error."""
    import aiohttp

    try:
        async with session.post(
            f"{base}/v1/admin/probe/d2h",
            headers={"Authorization": "Bearer dev-user-loadtest",
                     "Idempotency-Key": str(uuid.uuid4())},
            timeout=aiohttp.ClientTimeout(total=240),
        ) as resp:
            if resp.status == 200:
                return await resp.json()
            return {"ok": False, "error": f"probe http {resp.status}"}
    except Exception as error:
        return {"ok": False, "error": repr(error)[:200]}


async def run(base: str, n: int, concurrency: int) -> dict:
    import aiohttp

    rng = np.random.default_rng(0)
    img = np.clip(rng.normal(0, 20, (512, 512, 3)) + [90, 80, 70], 0, 255).astype(np.uint8)
    photo = imageio.encode_jpeg(img, quality=80)

    async with aiohttp.ClientSession() as session:
        # grant credits + warm
        await session.post(
            f"{base}/v1/admin/credits/grant",
            json={"userId": "loadtest", "amount": n + 10},
            headers={
                "Authorization": "Bearer dev-user-loadtest",
                "Idempotency-Key": str(uuid.uuid4()),
            },
        )
        warm = []
        await one_request(session, base, photo, warm)
        assert warm[0][0], "warmup request failed"

        pre = await server_probe(session, base)

        results = []
        semaphore = asyncio.Semaphore(concurrency)

        async def limited():
            async with semaphore:
                await one_request(session, base, photo, results)

        t0 = time.perf_counter()
        await asyncio.gather(*[limited() for _ in range(n)])
        wall = time.perf_counter() - t0

        post = await server_probe(session, base)

    ok = sum(1 for r in results if r[0])
    lat = np.asarray([r[1] for r in results])
    record = {
        "ok": ok, "n": n, "req_per_s": round(n / wall, 2),
        "p50_ms": round(float(np.percentile(lat, 50)), 1),
        "p95_ms": round(float(np.percentile(lat, 95)), 1),
        "concurrency": concurrency,
    }
    stamp(record, pre, post, clock="host")
    print(
        f"{ok}/{n} ok | {n / wall:.2f} req/s | "
        f"p50 {record['p50_ms']:.0f} ms | p95 {record['p95_ms']:.0f} ms | "
        f"concurrency {concurrency} | validity {record['validity']['status']}"
    )
    print(json.dumps(record), flush=True)
    return record


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    base = argv[0] if len(argv) > 0 else "http://localhost:8080"
    n = int(argv[1]) if len(argv) > 1 else 64
    concurrency = int(argv[2]) if len(argv) > 2 else 16
    return asyncio.run(run(base, n, concurrency))


if __name__ == "__main__":
    main()
