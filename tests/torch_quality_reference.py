"""The JAX package's side of the port's quality-gate tests, and the quality
table of both packages on the CPU.

``Reference`` runs the reference families with their shipped weights as
tests/test_quality.py does (f32 at precision=HIGHEST; ``excess=False``
compiles with XLA's excess precision off, rounding after every op as eager
PyTorch does); ``jax_heldout`` and ``jax_near_clean`` are that test's
inputs; ``ood_reference`` and ``real_reference`` are the serving fixtures of
tests/test_quality_ood.py and tests/test_quality_real.py.

Run as a script, it prints one JSON object: every gate's value from the
reference on its own inputs and from the port on the same inputs (bf16, CPU),
and the port's in-distribution values on its own draws:

    JAX_PLATFORMS=cpu python tests/torch_quality_reference.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import torch

from image_restoration_platform_tpu.classify.fused import batch_classify_and_condition
from image_restoration_platform_tpu.models import get_family as jget_family
from image_restoration_platform_tpu.models import weights as JW
from image_restoration_platform_tpu.ops.deblock import deblock_and_recondition
from image_restoration_platform_tpu.ops.deblur import deblur_and_recondition
from image_restoration_platform_tpu.train.data import DataConfig as JDataConfig
from image_restoration_platform_tpu.train.data import _random_clean_rich as jrandom_clean_rich
from image_restoration_platform_tpu.train.data import synthetic_batch as jsynthetic_batch
from image_restoration_platform_tpu_torch.eval import gates as G
from image_restoration_platform_tpu_torch.eval.common import psnr

BF16, F32 = torch.bfloat16, torch.float32
JDTYPE = {BF16: jnp.bfloat16, F32: jnp.float32}


def _params(name):
    family = jget_family(name)
    return JW.load_params(family.init(jax.random.PRNGKey(0), family.config), JW.weights_path(name))


class Reference:
    """The reference families, each apply compiled once per input shapes and
    type (f32 at precision=HIGHEST), with XLA's excess precision on (as the
    reference's tests run) or off."""

    def __init__(self):
        self._params, self._compiled = {}, {}

    def params(self, name):
        if name not in self._params:
            self._params[name] = _params(name)
        return self._params[name]

    def apply(self, name, dtype, *args, excess=True):
        family = jget_family(name)
        if name.startswith("sr-"):
            fn = lambda p, x: family.apply(p, x, family.config)  # noqa: E731
        elif name == "diffusion-restore":
            fn = lambda p, x, c, key: family.apply(p, x, c, key, config=family.config)  # noqa: E731
        else:
            fn = lambda p, x, c: family.apply(p, x, c, config=family.config)  # noqa: E731
        cast = [a if isinstance(a, jax.Array) and a.dtype == jnp.uint32 else jnp.asarray(a).astype(JDTYPE[dtype])
                for a in args]
        key = (name, dtype, excess, tuple(a.shape for a in cast))
        if key not in self._compiled:
            with jax.default_matmul_precision("highest" if dtype == F32 else "default"):
                self._compiled[key] = jax.jit(fn).lower(self.params(name), *cast).compile(
                    compiler_options={"xla_allow_excess_precision": excess})
        out = self._compiled[key](self.params(name), *cast)
        return np.asarray(jnp.clip(out.astype(jnp.float32), 0.0, 1.0))


def jax_heldout(seed: int, photo: bool):
    """(degraded, clean, cond) of the reference's ``synthetic_batch`` at a gate seed."""
    batch = jsynthetic_batch(jax.random.PRNGKey(seed), G.N, JDataConfig(size=G.SIZE, photo=photo))
    return tuple(np.asarray(a) for a in batch)


def jax_near_clean(seed: int):
    """(near-clean, clean, cond): the reference's near-clean draws and their
    serving conditioning."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    clean = jrandom_clean_rich(k1, G.N, G.SIZE, 3)
    near = jnp.clip(clean + jax.random.normal(k2, clean.shape) * G.NEAR_CLEAN_NOISE, 0.0, 1.0)
    valid = jnp.tile(jnp.asarray([[G.SIZE, G.SIZE]], jnp.int32), (G.N, 1))
    _s, cond = batch_classify_and_condition(near * 255.0, valid, jnp.ones((G.N,), jnp.float32))
    return np.asarray(near), np.asarray(clean), np.asarray(cond)


def diffusion_noise(shape, dtype):
    """The sampler's start as the reference draws it from PRNGKey(0), in the
    input's type."""
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape, dtype=JDTYPE[dtype]))
    return torch.from_numpy(noise.astype(np.float32)).to(dtype)


def ood_reference():
    """serve(x, excess=True): the reference's OOD serving fixture (u8 canvas
    -> classify -> deblock -> deblur -> re-condition -> backbone in bf16)."""
    family = jget_family("restore-unet")
    params = _params("restore-unet")

    def fn(degraded):
        n, s = degraded.shape[0], degraded.shape[1]
        valid = jnp.tile(jnp.asarray([[s, s]], jnp.int32), (n, 1))
        is_jpeg = jnp.ones((n,), jnp.float32)
        canvas_u8 = jnp.clip(jnp.round(degraded * 255.0), 0, 255).astype(jnp.uint8)
        scores, cond = batch_classify_and_condition(canvas_u8.astype(jnp.float32), valid, is_jpeg)
        canvas_u8, scores, cond = deblock_and_recondition(canvas_u8, valid, is_jpeg, scores, cond)
        canvas_u8, cond = deblur_and_recondition(canvas_u8, valid, is_jpeg, scores, cond)
        pred = family.apply(params, canvas_u8.astype(jnp.bfloat16) / jnp.bfloat16(255.0),
                            cond.astype(jnp.bfloat16), config=family.config)
        return jnp.clip(pred.astype(jnp.float32), 0.0, 1.0)

    compiled = {}

    def serve(x, excess=True):
        x = jnp.asarray(x)
        if excess not in compiled:
            compiled[excess] = jax.jit(fn).lower(x).compile(compiler_options={"xla_allow_excess_precision": excess})
        return np.asarray(compiled[excess](x))

    return serve


def real_reference():
    """serve(x): the reference's real-photo fixture (classify the input,
    backbone in bf16, no stages)."""
    family = jget_family("restore-unet")
    params = _params("restore-unet")

    @jax.jit
    def serve(x):
        valid = jnp.tile(jnp.asarray([[G.SIZE, G.SIZE]], jnp.int32), (x.shape[0], 1))
        _s, cond = batch_classify_and_condition(x * 255.0, valid, jnp.ones((x.shape[0],), jnp.float32))
        pred = family.apply(params, x.astype(jnp.bfloat16), cond.astype(jnp.bfloat16), config=family.config)
        return jnp.clip(pred.astype(jnp.float32), 0.0, 1.0)

    return lambda x: np.asarray(serve(jnp.asarray(x)))


def sr_gain(ref: Reference, name: str, degraded, clean, dtype) -> float:
    """The reference test's SR gain over nearest."""
    scale = jget_family(name).config.scale
    n, h, w, c = degraded.shape
    lr = degraded.reshape(n, h // scale, scale, w // scale, scale, c).mean(axis=(2, 4))
    baseline = np.repeat(np.repeat(lr, scale, axis=1), scale, axis=2)
    return psnr(ref.apply(name, dtype, lr), clean) - psnr(baseline, clean)


def _table() -> dict:
    """Every gate's value: the reference on its inputs, the port (CPU bf16)
    on the same inputs, and the port on its own draws."""
    from image_restoration_platform_tpu_torch.eval.common import load_model
    from image_restoration_platform_tpu_torch.train.ood import OOD_DEGRADATIONS, ood_clean, ood_eval_batch

    ref = Reference()
    port = {n: load_model(n, "cpu", BF16) for n in ("restore-unet", "sr-x2", "sr-x4", "diffusion-restore")}
    rows: dict = {}
    data = {"rich": jax_heldout(G.HELDOUT_SEED, False), "photo": jax_heldout(G.HELDOUT_PHOTO_SEED, True)}
    degraded, clean, cond = data["rich"]
    rows["flagship_gain"] = (psnr(ref.apply("restore-unet", BF16, degraded, cond), clean) - psnr(degraded, clean),
                             G.flagship_gain(port["restore-unet"], degraded, clean, cond, BF16))
    for seed in G.NEAR_CLEAN_SEEDS:
        near, clean, cond = jax_near_clean(seed)
        pred = ref.apply("restore-unet", BF16, near, cond)
        got = G.near_clean_harm(port["restore-unet"], near, clean, BF16)
        rows[f"near_clean_{seed}_psnr"] = (psnr(pred, clean), got[0])
        rows[f"near_clean_{seed}_mad"] = (float(np.mean(np.abs(pred - clean))) * 255.0, got[1])
    for name in ("sr-x2", "sr-x4"):
        for dist, (degraded, clean, _) in data.items():
            rows[f"{name}_{dist}_gain"] = (sr_gain(ref, name, degraded, clean, BF16),
                                           G.sr_gain_over_nearest(port[name], degraded, clean, BF16))
        scale = jget_family(name).config.scale
        hr = G.smooth_gate_batch()
        lr = hr.reshape(hr.shape[0], G.SIZE // scale, scale, G.SIZE // scale, scale, 3).mean(axis=(2, 4))
        pred = ref.apply(name, BF16, lr)
        got = G.sr_smooth(port[name], BF16)
        rows[f"{name}_smooth_psnr"] = (psnr(pred, hr), got["sr_psnr"])
        rows[f"{name}_smooth_laplacian"] = (G.hf_energy(pred), got["hf_pred"])
    for dist, (degraded, clean, cond) in data.items():
        want = psnr(ref.apply("diffusion-restore", BF16, degraded, cond, jax.random.PRNGKey(0)), clean)
        got = G.diffusion_gain(port["diffusion-restore"], degraded, clean, cond, diffusion_noise(degraded.shape, BF16),
                               BF16)
        rows[f"diffusion_{dist}_gain"] = (want - psnr(degraded, clean), got)
    serve = ood_reference()
    port_ood = G.ood_report("restore-unet", port["restore-unet"], BF16)
    for name in OOD_DEGRADATIONS:
        degraded, clean = ood_eval_batch(G.OOD_SEED, G.N, G.SIZE, name)
        rows[f"ood_{name}"] = (psnr(serve(degraded), clean) - psnr(degraded, clean), port_ood[name])
    degraded, clean = ood_eval_batch(G.OOD_SEED, G.N, G.SIZE, "motion")
    pred = serve(degraded)
    rows["ood_motion_per_image"] = (
        float(np.mean([psnr(pred[i], clean[i]) - psnr(degraded[i], clean[i]) for i in range(G.N)])),
        port_ood["motion_per_image"])
    clean = ood_clean(np.random.default_rng(G.OOD_CLEAN_SEED), G.N, G.SIZE)
    per_mad = G.per_image_mad(serve(clean), clean)
    rows["ood_clean_mean_mad"] = (float(per_mad.mean()), port_ood["clean_mean_mad"])
    rows["ood_clean_worst_mad"] = (float(per_mad.max()), port_ood["clean_worst_mad"])
    table = {k: {"reference_cpu_bf16": v[0], "port_cpu_bf16_same_inputs": v[1]} for k, v in rows.items()}
    own = G.in_distribution_report(port, BF16, "cpu")
    for key, value in own.items():
        if isinstance(value, dict):  # the smooth case reads its PSNR and Laplacian
            table[f"{key}_psnr"]["port_cpu_bf16_own_draws"] = value["sr_psnr"]
            table[f"{key}_laplacian"]["port_cpu_bf16_own_draws"] = value["hf_pred"]
        else:
            table[key]["port_cpu_bf16_own_draws"] = value
    return table


if __name__ == "__main__":
    import json

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    print(json.dumps(_table(), indent=1))
