"""PyTorch port: the HTTP API against the JAX package's, route by route.

Both apps run through ``aiohttp.test_utils.TestClient`` on the CPU with the
same configuration (buckets 64 and 128, restore-unet-small, no batcher, one
queue worker) and see the same requests in the same order. The JAX engine
computes in f32 at ``precision=HIGHEST`` (set for this module and restored
after it), the port's engine in f32. Bars: same status codes, the same
problem+json type, title and detail, the same body keys (a job result's
metadata included; the admin analytics body holds every key of the
reference's, ``tpu`` among them), scores within 1e-4, the same prompt text, and decoded restored pixels within
mean 0.5 and max 4 levels.

A 16-bit PNG upload is re-encoded to an 8-bit JPEG by the upload preprocess
of both apps, so the HDR pre-pass is not on the HTTP path; the same PNG is
also restored by each app's own ``ctx.restorator``, where it takes the
pre-pass (defocus fixture of tests/test_hdr_ingest.py).
"""

import asyncio
import base64
import json
import os
import tempfile
import uuid

import jax
import numpy as np
import pytest
from aiohttp import FormData
from aiohttp.test_utils import TestClient, TestServer

import fixtures
from image_restoration_platform_tpu import api as japi
from image_restoration_platform_tpu import config as jconfig
from image_restoration_platform_tpu import imageio as jimageio
from image_restoration_platform_tpu.ops import deblur as JD
from image_restoration_platform_tpu.serve import RestorationEngine as JEngine
from image_restoration_platform_tpu.train.ood import ood_clean
from image_restoration_platform_tpu_torch import api as tapi
from image_restoration_platform_tpu_torch import config as tconfig
from test_hdr_ingest import _fft_convolve, write_png16
from torch_reference_codec import build_reference_codec

build_reference_codec()  # before any xdist worker loads the reference's codec (see the helper)

AUTH = {"Authorization": "Bearer dev-user-alice"}
MODEL = {"model": "restore-unet-small"}


def _configs(cfg_mod, user_limit=120):
    cfg = cfg_mod.Config()
    cfg.serving = cfg_mod.ServingConfig(size_buckets=(64, 128), max_batch=4, max_wait_ms=2.0)
    cfg.rate_limit = cfg_mod.RateLimitConfig(user_limit=user_limit)
    return cfg


def _contexts(user_limit=120):
    jcfg, tcfg = _configs(jconfig, user_limit), _configs(tconfig, user_limit)
    jctx = japi.AppContext(config=jcfg, engine=JEngine(compute_dtype=jax.numpy.float32, serving_config=jcfg.serving),
                           use_batcher=False, queue_workers=1)
    tctx = tapi.AppContext(config=tcfg, use_batcher=False, queue_workers=1, device="cpu")
    return jctx, tctx


@pytest.fixture(scope="module")
def contexts():
    previous = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    pair = _contexts()
    for ctx in pair:
        ctx.user_store.grant("alice", 1000)
    yield pair
    for ctx in pair:
        ctx.shutdown()
    jax.config.update("jax_default_matmul_precision", previous)


def both(pair, scenario):
    """Run ``scenario(client, ctx)`` against the JAX app, then the port's."""

    async def runner(ctx, create_app):
        app = create_app(ctx=ctx, config=ctx.config)
        app.on_shutdown.clear()  # the module's contexts outlive each test server
        async with TestClient(TestServer(app)) as client:
            return await scenario(client, ctx)

    return [asyncio.run(runner(ctx, create)) for ctx, create in zip(pair, (japi.create_app, tapi.create_app))]


def form_for(data, filename="photo.jpg", prompt=None, options=MODEL):
    form = FormData()
    form.add_field("image", data, filename=filename, content_type="image/jpeg")
    if prompt:
        form.add_field("prompt", prompt)
    form.add_field("options", json.dumps(options))
    return form


def idem():
    return {"Idempotency-Key": str(uuid.uuid4())}


def _problem(status, body):
    return status, {k: body.get(k) for k in ("type", "title", "status", "detail", "remainingCredits")}


def _assert_results_match(ref, port):
    """Two restore results: keys, scores, prompt, decoded pixels."""
    assert ref["success"] is True and port["success"] is True, (ref.get("error"), port.get("error"))
    assert set(port) == set(ref)
    assert set(port["metadata"]) == set(ref["metadata"])
    assert set(port["timings"]) == set(ref["timings"])
    assert port["metadata"]["sizeBucket"] == ref["metadata"]["sizeBucket"]
    assert port["metadata"]["model"] == ref["metadata"]["model"]
    assert set(port["degradationAnalysis"]) == set(ref["degradationAnalysis"])
    for k, v in ref["degradationAnalysis"].items():
        assert abs(port["degradationAnalysis"][k] - v) <= 1e-4, k
    assert port["enhancedPrompt"] == ref["enhancedPrompt"]
    a, b = (jimageio.decode_image(base64.b64decode(r["restoredImage"])).pixels.astype(np.int32) for r in (ref, port))
    assert a.shape == b.shape
    diff = np.abs(a - b)
    assert diff.mean() <= 0.5 and diff.max() <= 4, (diff.mean(), diff.max())


def _defocus_png16() -> bytes:
    # seed 33: the pre-pass fires, and the mock moderation passes the re-encoded JPEG
    clean = ood_clean(np.random.default_rng(33), 1, 128)[0]
    blurred = np.clip(_fft_convolve(clean, JD.disk_psf(2.5)), 0.0, 1.0)
    return write_png16(np.round(blurred * 65535.0).astype(np.uint16))


# ------------------------------------------------------------------ health


def test_health_live_and_ready(contexts):
    async def scenario(client, ctx):
        live = await client.get("/health/live")
        ready = await client.get("/health/ready")
        body = await ready.json()
        return live.status, sorted(await live.json()), ready.status, body

    (ls, lkeys, rs, ref), (ls2, lkeys2, rs2, port) = both(contexts, scenario)
    assert (ls2, lkeys2, rs2) == (ls, lkeys, rs) == (200, ["service", "status", "timestamp"], 200)
    assert port["status"] == ref["status"] and set(port) == set(ref)
    assert set(port["dependencies"]) == set(ref["dependencies"])
    for name, dep in ref["dependencies"].items():
        assert port["dependencies"][name]["status"] == dep["status"], name
    device = port["dependencies"]["device"]
    assert device["platform"] == "cpu" == ref["dependencies"]["device"]["platform"]
    assert device["deviceCount"] == 1 and device["name"] == "cpu"


# -------------------------------------------------------------------- jobs


def test_sync_job_and_restore_single(contexts):
    image = fixtures.create_dark_image((48, 48))

    async def scenario(client, ctx):
        sync = await client.post("/v1/jobs?sync=1", data=form_for(image, prompt="fix my photo"),
                                 headers={**AUTH, **idem()})
        single = await client.post("/api/restore/single", data=form_for(image, prompt="fix my photo"), headers=AUTH)
        return sync.status, await sync.json(), single.status, await single.json()

    (s1, ref, s2, ref_single), (t1, port, t2, port_single) = both(contexts, scenario)
    assert (t1, t2) == (s1, s2) == (200, 200)
    assert set(port) == set(ref) and port["status"] == ref["status"] == "succeeded"
    assert port["credits"] == ref["credits"] and port["attempts"] == ref["attempts"]
    _assert_results_match(ref["result"], port["result"])
    _assert_results_match(ref_single, port_single)
    assert "fix my photo" in port["result"]["enhancedPrompt"]


def test_async_job_polling_stream_image_and_balance(contexts):
    image = fixtures.create_clean_image((32, 32))

    async def scenario(client, ctx):
        resp = await client.post("/v1/jobs", data=form_for(image), headers={**AUTH, **idem()})
        accepted = await resp.json()
        job_id = accepted["id"]
        location = resp.headers["Location"] == f"/v1/jobs/{job_id}"
        for _ in range(300):
            status = await (await client.get(f"/v1/jobs/{job_id}", headers=AUTH)).json()
            if status["status"] in ("succeeded", "failed", "dead_letter"):
                break
            await asyncio.sleep(0.1)
        async with client.get(f"/v1/jobs/{job_id}/stream", headers=AUTH) as stream:
            text = (await stream.read()).decode()
        events = [json.loads(line[len("data: "):]) for line in text.splitlines() if line.startswith("data: ")]
        img = await client.get(f"/v1/jobs/{job_id}/image", headers=AUTH)
        img_bytes = await img.read()
        other = await client.get(f"/v1/jobs/{job_id}", headers={"Authorization": "Bearer dev-user-mallory"})
        listed = await (await client.get("/v1/jobs", headers=AUTH)).json()
        balance = await (await client.get("/v1/credits/balance", headers=AUTH)).json()
        return {
            "accepted": (resp.status, sorted(accepted), accepted["status"], location),
            "final": (status["status"], sorted(status)),
            "events": [e["status"] for e in events],
            "image": (img.status, img.headers["Content-Type"], img_bytes[:3]),
            "other_user": other.status,
            "listed": job_id in [j["id"] for j in listed["jobs"]],
            "balance": balance,
        }, status["result"]

    (ref, ref_result), (port, port_result) = both(contexts, scenario)
    assert port == ref
    assert ref["final"][0] == "succeeded" and ref["events"][-1] == "succeeded"
    assert ref["image"] == (200, "image/jpeg", b"\xff\xd8\xff") and ref["other_user"] == 403
    _assert_results_match(ref_result, port_result)


def test_idempotent_replay_and_conflict(contexts):
    image = fixtures.create_clean_image((32, 32))

    async def scenario(client, ctx):
        key = idem()
        r1 = await client.post("/v1/jobs", data=form_for(image), headers={**AUTH, **key})
        b1 = await r1.json()
        r2 = await client.post("/v1/jobs", data=form_for(image), headers={**AUTH, **key})
        b2 = await r2.json()
        r3 = await client.post("/v1/jobs", data=form_for(fixtures.create_dark_image((32, 32))), headers={**AUTH, **key})
        return (r1.status, r2.status, r2.headers.get("Idempotency-Replayed"), b2["id"] == b1["id"],
                _problem(r3.status, await r3.json()))

    ref, port = both(contexts, scenario)
    assert port == ref
    assert ref[:4] == (202, 202, "true", True) and ref[4][0] == 409


def test_rate_limited_caller():
    pair = _contexts(user_limit=2)
    try:
        async def scenario(client, ctx):
            out = []
            for _ in range(3):
                r = await client.get("/v1/credits/balance", headers={"Authorization": "Bearer dev-user-rl"})
                out.append((r.status, r.headers.get("RateLimit-Limit"), r.headers.get("RateLimit-Remaining"),
                            r.headers.get("Retry-After") is not None))
            return out, _problem(r.status, await r.json())

        ref, port = both(pair, scenario)
    finally:
        for ctx in pair:
            ctx.shutdown()
    assert port == ref
    assert [s for s, *_ in ref[0]] == [200, 200, 429] and ref[0][2][3]


def test_client_errors_match(contexts):
    """A missing image, an unsupported extension, a magic-byte mismatch, an
    oversized upload, no bearer token, too few credits, an unknown route."""
    png_as_jpeg = fixtures.create_png_image((32, 32))

    async def scenario(client, ctx):
        out = {}
        empty = FormData()
        empty.add_field("prompt", "nothing attached")
        for name, form, filename in (("missing", empty, None),
                                     ("extension", form_for(b"GIF89a", filename="x.gif"), None),
                                     ("magic", form_for(b"not an image at all"), None),
                                     ("oversized", form_for(b"\xff\xd8\xff" + b"\x00" * (11 * 1024 * 1024)), None)):
            r = await client.post("/v1/jobs", data=form, headers={**AUTH, **idem()})
            out[name] = _problem(r.status, await r.json())
        r = await client.post("/v1/jobs", data=form_for(png_as_jpeg, filename="x.png"), headers={**AUTH, **idem()})
        out["png_ok"] = r.status
        r = await client.get("/v1/credits/balance")
        out["no_bearer"] = _problem(r.status, await r.json())
        broke = {"Authorization": "Bearer dev-user-broke"}
        statuses = []
        for _ in range(4):
            r = await client.post("/v1/jobs", data=form_for(fixtures.create_clean_image((32, 32))),
                                  headers={**broke, **idem()})
            statuses.append(r.status)
        out["credits"] = statuses, _problem(r.status, await r.json())
        r = await client.get("/v1/nowhere", headers=AUTH)
        out["unknown"] = _problem(r.status, await r.json())
        return out

    ref, port = both(contexts, scenario)
    assert port == ref
    assert [ref[k][0] for k in ("missing", "extension", "magic", "oversized", "no_bearer", "unknown")] == [
        400, 415, 415, 413, 401, 404]
    assert ref["credits"][0] == [202, 202, 202, 402] and ref["credits"][1][1]["remainingCredits"] == 0


def test_uploads_webhook_console_metrics_and_admin(contexts, monkeypatch, tmp_path):
    """The remaining routes: signed upload slot, PUT and submit by token, the
    Stripe webhook without a secret, the console files, /metrics, and the
    admin routes (analytics, replay, D2H probe, traces, grant, profile)."""
    monkeypatch.setenv("ADMIN_USERS", "alice")
    monkeypatch.delenv("STRIPE_WEBHOOK_SECRET", raising=False)
    image = fixtures.create_clean_image((32, 32))

    async def scenario(client, ctx):
        out = {}
        slot = await (await client.get("/v1/uploads/signed-url", headers=AUTH)).json()
        put = await client.put(slot["uploadUrl"], data=image, headers=AUTH)
        form = FormData()
        form.add_field("uploadToken", slot["token"])
        form.add_field("options", json.dumps(MODEL))
        by_token = await client.post("/v1/jobs?sync=1", data=form, headers={**AUTH, **idem()})
        out["upload"] = (sorted(slot), put.status, (await put.json())["bytes"], by_token.status,
                         (await by_token.json())["status"])
        hook = await client.post("/v1/webhooks/stripe", data=b"{}")
        out["webhook"] = _problem(hook.status, await hook.json())
        for path in ("/", "/console.js", "/console.css"):
            r = await client.get(path)
            out[path] = (r.status, len(await r.read()) > 0)
        metrics = await client.get("/metrics")
        text = await metrics.text()
        out["metrics"] = (metrics.status, "http_request_duration_ms_p95" in text)
        analytics = await client.get("/v1/admin/analytics", headers=AUTH)
        body = await analytics.json()
        out["analytics"] = (analytics.status, sorted(body), sorted(body["credits"]), sorted(body["queue"]))
        replay = await client.post(f"/v1/admin/jobs/{uuid.uuid4()}/replay", headers={**AUTH, **idem()})
        out["replay"] = _problem(replay.status, await replay.json())[0]
        probe = await client.post("/v1/admin/probe/d2h?mb=2", headers={**AUTH, **idem()})
        out["probe"] = (probe.status, await probe.json())
        traces = await client.get("/v1/admin/traces?limit=5", headers=AUTH)
        out["traces"] = (traces.status, sorted((await traces.json())["resourceSpans"][0]))
        grant = await client.post("/v1/admin/credits/grant", json={"userId": "gina", "amount": 3},
                                  headers={**AUTH, **idem()})
        out["grant"] = (grant.status, await grant.json())
        denied = await client.get("/v1/admin/analytics", headers={"Authorization": "Bearer dev-user-mallory"})
        out["denied"] = _problem(denied.status, await denied.json())
        return out

    ref, port = both(contexts, scenario)
    # every key of the reference's body is in the port's (the port adds "device")
    ref_keys = ref.pop("analytics")
    port_keys = port.pop("analytics")
    assert port_keys[0] == ref_keys[0] == 200
    assert set(ref_keys[1]) <= set(port_keys[1]) and "tpu" in port_keys[1] and port_keys[2:] == ref_keys[2:]
    assert port == ref
    assert ref["upload"][1] == 200 and ref["upload"][3] == 200 and ref["webhook"][0] == 503
    assert ref["probe"] == (200, {"mode": "cpu", "ok": True}) and ref["grant"][0] == 200

    # the port's profiler writes a Chrome trace (the reference's writes a
    # jax.profiler trace and is not run here)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))

    async def profile(client, ctx):
        r = await client.post("/v1/admin/profile?seconds=0.1", headers={**AUTH, **idem()})
        return r.status, await r.json()

    async def runner():
        app = tapi.create_app(ctx=contexts[1], config=contexts[1].config)
        app.on_shutdown.clear()
        async with TestClient(TestServer(app)) as client:
            return await profile(client, contexts[1])

    status, body = asyncio.run(runner())
    assert status == 200 and body["traceDir"].startswith(str(tmp_path))
    assert os.path.getsize(os.path.join(body["traceDir"], "trace.json")) > 0


def test_16_bit_png(contexts):
    """Through POST /v1/jobs?sync=1 (re-encoded to 8-bit JPEG by the upload
    preprocess), then through each app's restorator (the HDR pre-pass)."""
    png16 = _defocus_png16()
    assert jimageio.decode_bit_depth(png16[:32]) == 16

    async def scenario(client, ctx):
        r = await client.post("/v1/jobs?sync=1", data=form_for(png16, filename="defocus.png"),
                              headers={**AUTH, **idem()})
        body = await r.json()
        direct = await asyncio.to_thread(ctx.restorator.restore, png16, None, {"userId": "alice"}, dict(MODEL))
        return r.status, body, direct

    (s1, ref, ref_direct), (s2, port, port_direct) = both(contexts, scenario)
    assert s2 == s1 == 200
    assert set(port) == set(ref) and port["status"] == ref["status"] == "succeeded"
    _assert_results_match(ref["result"], port["result"])
    assert ref["result"]["metadata"]["sizeBucket"] == 128
    _assert_results_match(ref_direct, port_direct)
    # the pre-pass fired: the direct results differ from the HTTP path's
    # (the same pixels quantized to 8 bits first)
    direct_px, http_px = (jimageio.decode_image(base64.b64decode(r["restoredImage"])).pixels.astype(np.int32)
                          for r in (port_direct, port["result"]))
    assert np.abs(direct_px - http_px).mean() > 1.0
