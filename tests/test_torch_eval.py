"""PyTorch port: the eval tools (image_restoration_platform_tpu_torch/eval/).

The helpers of eval/common.py equal the scripts' own (taken out of
scripts/eval_quality.py and scripts/eval_ood.py by their source and run on
the same arrays); ``serving_forward`` in f32 equals the reference's OOD
serving fixture in f32 (precision=HIGHEST) within 1e-3 on inputs that make
the deblock and deblur stages fire, and is the engine's own program (its
output rounded to bytes is the engine's); each tool prints the JSON keys (or the
lines) of its script at a small size on the CPU (eval.ood beside the
reference script run with the same flags; the others against the schema
their script's source writes); and without a card each tool raises unless
given ``--device cpu``."""

import ast
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu_torch.eval import common
from image_restoration_platform_tpu_torch.eval import conditioning_ablation, diffusion_steps, flagship_quick, ood, quality

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {
    "quality": quality, "ood": ood, "flagship_quick": flagship_quick, "diffusion_steps": diffusion_steps,
    "conditioning_ablation": conditioning_ablation,
}


def _script_helpers(script: str, names: tuple) -> dict:
    """The functions ``names`` defined inside ``main`` of scripts/<script>."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", script)).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    defs = [n for n in main.body if isinstance(n, ast.FunctionDef) and n.name in names]
    consts = [n for n in main.body if isinstance(n, ast.Assign) and isinstance(n.value, ast.Constant)]
    namespace = {"np": np, "jnp": jnp}
    exec(compile(ast.Module(body=consts + defs, type_ignores=[]), script, "exec"), namespace)
    assert set(names) <= set(namespace)
    return namespace


def test_helpers_equal_the_scripts():
    ref = _script_helpers("eval_quality.py", ("psnr", "per_image_psnr", "gain_stats", "smooth_batch"))
    ood_ref = _script_helpers("eval_ood.py", ("psnr",))
    assert ref["DAMAGE_PSNR_MAX"] == common.DAMAGE_PSNR_MAX
    rng = np.random.default_rng(0)
    a, b = rng.random((4, 16, 16, 3), dtype=np.float32), rng.random((4, 16, 16, 3), dtype=np.float32)
    b[1] = a[1]  # an identity row: the 1e-10 floor
    assert common.psnr(a, b) == pytest.approx(ref["psnr"](jnp.asarray(a), jnp.asarray(b)), abs=1e-5)
    assert common.psnr(a, b) == pytest.approx(ood_ref["psnr"](a, b), abs=1e-9)
    np.testing.assert_allclose(common.per_image_psnr(a, b), ref["per_image_psnr"](a, b), rtol=0, atol=1e-6)
    pins = [rng.uniform(20, 60, 8), rng.uniform(20, 60, 8)]
    pouts = [p + rng.normal(2, 1, 8) for p in pins]
    for damage_only in (True, False):
        np.testing.assert_allclose(common.gain_stats(pins, pouts, damage_only),
                                   ref["gain_stats"](pins, pouts, damage_only), rtol=1e-12)
    np.testing.assert_array_equal(common.smooth_batch(9001, 3, 32), np.asarray(ref["smooth_batch"](9001, 3, 32)))


def test_serving_forward_equals_the_reference_fixture_in_f32():
    from image_restoration_platform_tpu.classify.fused import batch_classify_and_condition
    from image_restoration_platform_tpu.models import get_family as jget_family
    from image_restoration_platform_tpu.models import weights as JW
    from image_restoration_platform_tpu.ops.deblock import deblock_and_recondition
    from image_restoration_platform_tpu.ops.deblur import deblur_and_recondition
    from image_restoration_platform_tpu_torch.train.ood import ood_eval_batch

    family = jget_family("restore-unet")
    params = JW.load_params(family.init(jax.random.PRNGKey(0), family.config), JW.weights_path("restore-unet"))

    def reference(degraded):
        n, s = degraded.shape[0], degraded.shape[1]
        valid = jnp.tile(jnp.asarray([[s, s]], jnp.int32), (n, 1))
        is_jpeg = jnp.ones((n,), jnp.float32)
        canvas_u8 = jnp.clip(jnp.round(degraded * 255.0), 0, 255).astype(jnp.uint8)
        scores, cond = batch_classify_and_condition(canvas_u8.astype(jnp.float32), valid, is_jpeg)
        canvas_u8, scores, cond = deblock_and_recondition(canvas_u8, valid, is_jpeg, scores, cond)
        canvas_u8, cond = deblur_and_recondition(canvas_u8, valid, is_jpeg, scores, cond)
        pred = family.apply(params, canvas_u8.astype(jnp.float32) / 255.0, cond, config=family.config)
        return jnp.clip(pred.astype(jnp.float32), 0.0, 1.0)

    model = common.load_model("restore-unet", "cpu", torch.float32)
    x = np.concatenate([ood_eval_batch(2026, 2, 128, name)[0] for name in ("motion", "jpeg_q10_60")])
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(reference)(jnp.asarray(x)))
    got = common.serving_forward("restore-unet", model, x, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    with pytest.raises(ValueError):
        common.serving_forward("sr-x2", model, x)



def test_serving_forward_is_the_engine_program():
    """``serving_forward`` runs the program the engine serves: its f32 output
    rounded to bytes is the engine's u8 output, in bf16 on the engine's own
    model."""
    from image_restoration_platform_tpu_torch.serve import RestorationEngine
    from image_restoration_platform_tpu_torch.train.ood import ood_eval_batch

    engine = RestorationEngine(device="cpu", dtype=torch.bfloat16)
    x = np.concatenate([ood_eval_batch(2026, 1, 128, name)[0] for name in ("motion", "jpeg_q10_60")])
    canvas = np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)
    served, _, _ = engine.restore_batch(canvas, is_jpeg=np.ones((2,), np.float32), family_name="restore-unet")
    got = common.serving_forward("restore-unet", engine.model("restore-unet"), x, torch.bfloat16)
    np.testing.assert_array_equal(torch.round(got * 255.0).to(torch.uint8).numpy(), served)

def _keys(obj):
    """The nested key structure of a JSON value."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    return "number"


def _literals(structure) -> set:
    """Every key of a nested key structure."""
    out = set()
    for k, v in structure.items():
        out.add(k)
        if isinstance(v, dict):
            out |= _literals(v)
    return out


def _run(cmd, extra_env=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(IRP_EVAL_SEEDS="1", **(extra_env or {}))
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


def _port_json(tool, args):
    return json.loads(_run([sys.executable, "-m", f"image_restoration_platform_tpu_torch.eval.{tool}", *args,
                            "--device", "cpu"])[-1])


def test_ood_prints_the_scripts_json():
    """The reference script run beside the port with the same flags."""
    args = ["--n", "2", "--size", "32", "--family", "restore-unet-small"]
    ref = json.loads(_run([sys.executable, os.path.join("scripts", "eval_ood.py"), *args], {"JAX_PLATFORMS": "cpu"})[-1])
    port = _port_json("ood", args)
    assert _keys(port) == _keys(ref)
    assert {k: port[k] for k in ("family", "n", "size", "corpus")} == {k: ref[k] for k in ("family", "n", "size", "corpus")}


_GAIN = {"gain_db": "number", "agg_gain_db": "number"}
_ROWS = {**_GAIN, "damage_rows": "number"}
_ABLATION = {k: "number" for k in ("gain_db_conditioned", "gain_db_neutral", "delta_db", "pct")}
# the schema each script prints (the reference scripts run eagerly on a CPU
# for about a minute each even at these sizes, so their keys are read from
# their source): the port's JSON must have exactly these keys, and each key
# is a literal of the script
SCHEMAS = {
    "quality": (
        ["--n", "2", "--seeds", "1", "--size", "32", "--family", "restore-unet-small", "--family", "sr-x2"],
        "eval_quality.py",
        {"n": "number", "seeds": "number", "size": "number", "families": {
            "restore-unet-small": {"rich": _ROWS, "photo": _ROWS},
            "sr-x2": {"smooth": {"clean": _GAIN}, "rich": {"clean": _GAIN, "degraded": _GAIN},
                      "photo": {"clean": _GAIN, "degraded": _GAIN}}}},
    ),
    "flagship_quick": (["--n", "2", "--size", "32"], "eval_flagship_quick.py", {"rich": "number", "photo": "number"}),
    "conditioning_ablation": (["--n", "2", "--size", "32"], "eval_conditioning_ablation.py",
                              {"rich": _ABLATION, "photo": _ABLATION}),
}


@pytest.mark.parametrize("tool", sorted(SCHEMAS))
def test_tool_prints_the_scripts_json(tool):
    args, script, schema = SCHEMAS[tool]
    source = open(os.path.join(REPO, "scripts", script)).read()
    missing = {k for k in _literals(schema) if f'"{k}"' not in source}
    assert missing == set(), f"{script} names no {missing}"
    port = _port_json(tool, args)
    if tool == "conditioning_ablation":  # pct is null where the neutral gain is not positive
        for dist in port:
            port[dist]["pct"] = 0.0 if port[dist]["pct"] is None else port[dist]["pct"]
    assert _keys(port) == schema


def test_diffusion_steps_prints_the_scripts_lines():
    lines = _run([sys.executable, "-m", "image_restoration_platform_tpu_torch.eval.diffusion_steps", "--device", "cpu",
                  "--n", "2", "--size", "32", "--steps", "1,2"])
    assert lines[0].startswith("degraded PSNR: ") and lines[0].endswith(" dB")
    assert [line.split(":")[0] for line in lines[1:]] == ["steps=1", "steps=2"]
    assert all(" dB  (warm " in line and line.endswith(" ms/b2)") for line in lines[1:])


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_needs_a_card_unless_asked_for_the_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TOOLS[tool].main([])
