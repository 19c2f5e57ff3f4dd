"""PyTorch port: package isolation and device rules.

The port imports neither ``jax`` nor anything of the JAX package (checked
in a fresh interpreter, by exact top-level name: the port's own name starts
with the JAX package's); its entry points run on CUDA unless the caller
asks for the CPU, and raise without a card; chip_smoke.py refuses to run
without a card or outside a checkout."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

from image_restoration_platform_tpu_torch.config import ServingConfig
from image_restoration_platform_tpu_torch.serve import MicroBatcher, RestorationEngine, RestoratorService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "image_restoration_platform_tpu_torch"
JAX_PKG = "image_restoration_platform_tpu"

_PROBE = f"""
import importlib, pkgutil, sys
import {PORT}
names = [m.name for m in pkgutil.walk_packages({PORT}.__path__, "{PORT}.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "{JAX_PKG}" or m.startswith("{JAX_PKG}.")
)
print(len(names), leaked)
print(" ".join(n[len("{PORT}."):] for n in names))
"""

# the modules of the super-resolution, diffusion and fusion slice, of the
# HTTP service with its host services, the device classifier and resize, of
# the trainer, of the meshes, and of the measurement and quality entry points
NEW_MODULES = {
    "bench", "entry", "eval", "eval.common", "eval.gates", "eval.quality", "eval.ood", "eval.flagship_quick",
    "eval.diffusion_steps", "eval.conditioning_ablation", "utils.peaks",
    "parallel", "parallel.mesh", "parallel.sharding", "parallel.halo", "parallel.pipeline",
    "train", "train.__main__", "train.data", "train.ood", "train.realphoto", "train.trainer",
    "models.srnet", "models.diffusion", "ops.tile", "ops.cuda.blend", "serve.programs.sr", "serve.programs.fusion",
    "api", "api.app", "api.auth", "api.context", "api.middleware", "api.routes", "api.submit", "classify.classifier",
    "config", "obs.metrics", "obs.tracing", "ops.resize", "ops.stats", "problem", "serve.blobs", "serve.credits",
    "serve.durable", "serve.idempotency", "serve.jobs", "serve.moderation", "serve.queue", "serve.ratelimit",
    "serve.redis_store", "serve.store", "serve.vision", "serve.warmup", "utils.measure_guard", "utils.retry",
    "retrain", "retrain.chip_queue", "retrain.rank_candidates", "retrain.validate_staging",
    "tools", "tools.smoke", "tools.loadtest", "tools.validate_secrets",
}

# the service graph and the submission path, in an interpreter without aiohttp
_NO_AIOHTTP_PROBE = f"""
import sys
sys.modules["aiohttp"] = None
import {PORT}.api
from {PORT}.api import AppContext
from {PORT}.api.context import AppContext
from {PORT}.api.submit import submit_job, preprocess, validate_upload
try:
    from {PORT}.api import create_app
except ImportError:
    print("aiohttp refused")
print(sorted(m for m, v in sys.modules.items() if m.startswith("aiohttp") and v is not None))
"""


# the retrain chain and the operator tools, in an interpreter without aiohttp
# (the card's machine has none): every module imports
_TOOLS_NO_AIOHTTP_PROBE = f"""
import importlib, pkgutil, sys
sys.modules["aiohttp"] = None
import {PORT}.retrain, {PORT}.tools
names = [m.name for pkg in ({PORT}.retrain, {PORT}.tools)
         for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(len(names), sorted(m for m, v in sys.modules.items() if m.startswith("aiohttp") and v is not None))
"""


def test_port_imports_nothing_of_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    first, modules = out.stdout.strip().splitlines()
    count, leaked = first.split(" ", 1)
    assert int(count) >= 84  # every module of the port was imported
    assert NEW_MODULES <= set(modules.split())
    assert leaked == "[]"


def test_service_graph_imports_without_aiohttp():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _NO_AIOHTTP_PROBE], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["aiohttp refused", "[]"]


def test_retrain_and_tools_import_without_aiohttp():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _TOOLS_NO_AIOHTTP_PROBE], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "6 []"


def test_no_port_manifest_names_the_jax_package():
    """The port's data files (the retrain queues) run the port's modules only."""
    for root, _dirs, names in os.walk(os.path.join(REPO, PORT)):
        for name in names:
            if name.endswith(".json"):
                text = open(os.path.join(root, name)).read()
                assert f"{JAX_PKG}." not in text and f"{JAX_PKG}/" not in text, name


def _imported_roots(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_source_names_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, PORT)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        roots = _imported_roots(path)
        assert "jax" not in roots and JAX_PKG not in roots, path


def test_kernel_sources_sit_beside_their_wrappers():
    """Each wrapper names a source that exists under csrc/, and importing
    the wrappers built nothing (kernels build at first launch)."""
    from image_restoration_platform_tpu_torch.ops.cuda import attention, blend, build

    for module in (attention, blend):
        assert os.path.isfile(os.path.join(build.CSRC_DIR, module.SOURCE)), module.SOURCE
    assert attention.flash_kernel._fn is None or torch.cuda.is_available()
    assert blend.blend_kernel._fn is None or torch.cuda.is_available()
    text = open(os.path.join(build.CSRC_DIR, blend.SOURCE)).read()
    assert "irp_blend_tiles" in text and "ops/pallas/blend.py" in text


def test_blend_reads_no_environment_switch():
    """A CUDA tensor takes the kernel, a CPU tensor the plain fold: the
    port's tile and blend modules read no environment variable."""
    for rel in ("ops/tile.py", "ops/cuda/blend.py"):
        text = open(os.path.join(REPO, PORT, rel)).read()
        assert "environ" not in text and "IRP_PALLAS_BLEND" not in text, rel
        assert "fold(" not in text.replace("blend_tiles(", "") and "index_add" not in text, rel


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RestorationEngine()
    engine = RestorationEngine(device="cpu", serving_config=ServingConfig(size_buckets=(64,)))
    assert engine.device.type == "cpu" and engine.dtype == torch.float32
    with pytest.raises(RuntimeError):
        RestoratorService(engine=engine)
    with pytest.raises(RuntimeError):
        MicroBatcher(engine)
    RestoratorService(engine=engine, device="cpu")


def test_app_context_and_main_need_cuda_unless_asked_for_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from image_restoration_platform_tpu_torch.api import AppContext, app

    monkeypatch.setenv("ALLOW_DEGRADED", "1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AppContext()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        app.main()
    served = []
    monkeypatch.setattr(app.web, "run_app", lambda application, **kw: served.append(application["ctx"]))
    app.main(device="cpu")
    ctx = served[0]
    try:
        assert ctx.device.type == ctx.engine.device.type == ctx.classifier.device.type == "cpu"
        assert ctx.restorator.engine is ctx.engine and ctx.batcher.engine is ctx.engine
    finally:
        ctx.shutdown()


def test_chip_smoke_refuses_without_a_card_or_a_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    here = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert here.returncode != 0 and '"ok"' not in here.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout
