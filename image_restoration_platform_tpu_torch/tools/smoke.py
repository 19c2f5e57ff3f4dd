"""Smoke test against a running deployment: health, a sync restore, and the
async job lifecycle; exits non-zero on any failure.

Port of scripts/smoke.py, with the port's imageio; the same checks, PASS /
FAIL lines and exit codes:

    python -m image_restoration_platform_tpu_torch.tools.smoke [base_url]

aiohttp is imported inside ``main`` (a machine without it still imports
the module).
"""

from __future__ import annotations

import asyncio
import sys
import uuid

import numpy as np

from .. import imageio

AUTH = {"Authorization": "Bearer dev-user-smoke"}


def check(name, ok):
    print(f"{'PASS' if ok else 'FAIL'}  {name}", flush=True)
    if not ok:
        sys.exit(1)


async def run(base: str) -> None:
    import aiohttp

    rng = np.random.default_rng(0)
    img = np.clip(rng.normal(0, 18, (256, 256, 3)) + [80, 70, 60], 0, 255).astype(np.uint8)
    photo = imageio.encode_jpeg(img, quality=80)

    async with aiohttp.ClientSession() as session:
        async with session.get(f"{base}/health/live") as r:
            check("health/live", r.status == 200)
        async with session.get(f"{base}/health/ready") as r:
            body = await r.json()
            check("health/ready", r.status in (200, 503) and "dependencies" in body)

        form = aiohttp.FormData()
        form.add_field("image", photo, filename="smoke.jpg", content_type="image/jpeg")
        async with session.post(
            f"{base}/v1/jobs?sync=1",
            data=form,
            headers={**AUTH, "Idempotency-Key": str(uuid.uuid4())},
        ) as r:
            body = await r.json()
            ok = r.status == 200 and body.get("result", {}).get("success") is True
            check("sync restore", ok)
            timings = body["result"]["timings"]
            check("timings contract", all(k in timings for k in ("classify_ms", "prompt_ms", "restore_ms", "total_ms")))

        form = aiohttp.FormData()
        form.add_field("image", photo, filename="smoke2.jpg", content_type="image/jpeg")
        async with session.post(
            f"{base}/v1/jobs",
            data=form,
            headers={**AUTH, "Idempotency-Key": str(uuid.uuid4())},
        ) as r:
            check("async submit 202", r.status == 202)
            job_id = (await r.json())["id"]

        for _ in range(120):
            async with session.get(f"{base}/v1/jobs/{job_id}", headers=AUTH) as r:
                status = (await r.json())["status"]
            if status in ("succeeded", "failed", "dead_letter"):
                break
            await asyncio.sleep(0.5)
        check("async job succeeded", status == "succeeded")

        async with session.get(f"{base}/v1/credits/balance", headers=AUTH) as r:
            check("credits balance", r.status == 200)
    print("smoke ok", flush=True)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    asyncio.run(run(argv[0] if argv else "http://localhost:8080"))


if __name__ == "__main__":
    main()
