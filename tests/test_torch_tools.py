"""PyTorch port: the operator entry points of tools/ (smoke, loadtest,
validate_secrets) against the reference scripts of scripts/.

``tools.smoke`` and ``tools.loadtest`` run against the port's app on the CPU
(restore-unet-small buckets as tests/test_torch_api.py builds them, one
queue worker), served by ``aiohttp.test_utils.TestServer`` on a real port
from a thread of its own, so each tool's ``main`` runs its own event loop
as it does from the command line. ``tools.validate_secrets`` runs beside
scripts/validate_secrets.py in subprocesses: the same exit codes and lines
with secrets missing, with ``ALLOW_DEGRADED=1`` and with every secret set."""

import asyncio
import json
import os
import subprocess
import sys
import threading

import pytest
from aiohttp.test_utils import TestServer

from image_restoration_platform_tpu_torch import api, config
from image_restoration_platform_tpu_torch.tools import loadtest, smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_CHECKS = ["health/live", "health/ready", "sync restore", "timings contract", "async submit 202",
                "async job succeeded", "credits balance"]


@pytest.fixture(scope="module")
def base_url():
    """The port's app on the CPU behind a TestServer on a real port; the
    loadtest user may use the admin routes (credit grant, device probe)."""
    saved = {k: os.environ.get(k) for k in ("ALLOW_DEGRADED", "ADMIN_USERS")}
    os.environ.update({"ALLOW_DEGRADED": "1", "ADMIN_USERS": "loadtest"})
    cfg = config.Config()
    cfg.serving = config.ServingConfig(size_buckets=(64, 128), max_batch=4, max_wait_ms=2.0)
    ctx = api.AppContext(config=cfg, use_batcher=False, queue_workers=1, device="cpu")
    loop = asyncio.new_event_loop()
    server = TestServer(api.create_app(ctx=ctx, config=cfg), loop=loop)
    loop.run_until_complete(server.start_server())
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        yield str(server.make_url("")).rstrip("/")
    finally:
        asyncio.run_coroutine_threadsafe(server.close(), loop).result(timeout=60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=60)
        loop.close()
        ctx.shutdown()
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def test_smoke_passes_against_the_port_s_app(base_url, capsys):
    smoke.main([base_url])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [f"PASS  {name}" for name in SMOKE_CHECKS] + ["smoke ok"]
    source = open(os.path.join(REPO, "scripts", "smoke.py")).read()
    assert all(f'check("{name}"' in source for name in SMOKE_CHECKS)


def test_smoke_fails_with_exit_code_1(base_url, capsys):
    with pytest.raises(SystemExit) as exit_info:
        smoke.main([base_url + "/nowhere"])  # every route 404s under this prefix
    assert exit_info.value.code == 1
    assert capsys.readouterr().out.strip().splitlines() == ["FAIL  health/live"]


def test_loadtest_reports_throughput_and_percentiles(base_url, capsys):
    record = loadtest.main([base_url, "4", "2"])
    summary, last = capsys.readouterr().out.strip().splitlines()[-2:]
    assert json.loads(last) == record
    assert set(record) == {"ok", "n", "req_per_s", "p50_ms", "p95_ms", "concurrency", "validity"}
    assert record["ok"] == record["n"] == 4 and record["concurrency"] == 2
    assert record["req_per_s"] > 0 and 0 < record["p50_ms"] <= record["p95_ms"]
    assert record["validity"]["status"] == "CPU"  # the server's device probe on a CPU engine
    assert summary.startswith("4/4 ok | ") and " req/s | p50 " in summary and summary.endswith("validity CPU")


def _secrets_env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in config.REQUIRED_SECRETS and k != "ALLOW_DEGRADED"}
    env.pop("PYTHONPATH", None)
    return {**env, **extra}


@pytest.mark.parametrize("case", ["missing", "degraded", "present"])
def test_validate_secrets_as_the_reference(case):
    extra = {"missing": {}, "degraded": {"ALLOW_DEGRADED": "1"},
             "present": {k: "set" for k in config.REQUIRED_SECRETS}}[case]
    runs = [subprocess.run(cmd, cwd=REPO, env=_secrets_env(**extra), capture_output=True, text=True, timeout=300)
            for cmd in ([sys.executable, "scripts/validate_secrets.py"],
                        [sys.executable, "-m", "image_restoration_platform_tpu_torch.tools.validate_secrets"])]
    ref, port = runs
    assert (port.returncode, port.stdout) == (ref.returncode, ref.stdout)
    assert port.returncode == (1 if case == "missing" else 0)
    if case == "missing":
        assert [line for line in port.stderr.splitlines() if line.startswith("[secrets]")] == \
               [line for line in ref.stderr.splitlines() if line.startswith("[secrets]")] != []
    else:
        want = "degraded mode: missing " if case == "degraded" else "all required secrets present: "
        assert port.stdout.startswith(want)
