"""PyTorch port: the shipped flagship's train loss in bf16 and f32 against
the JAX trainer's.

The shipped weights (weights/restore-unet.npz) on one batch of 4 at 128 px,
drawn as chip_smoke.py's card-against-CPU check draws it, under the
r5-anchor recipe's loss (scripts/queues/r5_anchor.json: identity weight 6,
compression anchor 0.5). In f32 the two agree to 1e-5 on the loss and 1e-5
in gradient cosine; in bf16 the losses agree to 1e-3, and the gap between
bf16 and f32 is the reference's own to 10 %. At this state the gap is over
2 % in the reference too (measured 6.27 %), so a 2 % bar on bf16 against f32
measures bf16, not the port. The gradient readings are printed (pytest -s):
at this state bf16 rounding dominates the gradient in both, and the
reference's bf16 is read twice, as XLA compiles it (f32 kept inside its
fusions) and rounded after every op as eager PyTorch rounds."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_train_parity as P
from image_restoration_platform_tpu.models import get_family as jget_family
from image_restoration_platform_tpu.models import weights as JW
from image_restoration_platform_tpu.train import trainer as jtrainer
from image_restoration_platform_tpu_torch.models import weights as W
from image_restoration_platform_tpu_torch.train import DataConfig, synthetic_batch
from image_restoration_platform_tpu_torch.train import trainer as T

torch.set_num_threads(4)

FLAGSHIP = dict(family="restore-unet", batch_size=4, image_size=128, identity_weight=6.0, anchor_comp=0.5,
                seed=601)
FLAGSHIP_DATA = dict(photo=True, deconv=True, grain=True, smooth=True, compression_solo=0.3, lowlight_solo=0.18)


def _flagship():
    """The shipped weights in both layouts and chip_smoke.py's CPU batch."""
    family = jget_family("restore-unet")
    jparams = JW.load_params(family.init(jax.random.PRNGKey(0), family.config), W.weights_path("restore-unet"))
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), jparams)
    state = W.params_from_jax(W.flatten_params(jax.tree_util.tree_map(np.asarray, jparams)))
    data_cfg = DataConfig(size=FLAGSHIP["image_size"], **FLAGSHIP_DATA)
    batch = synthetic_batch(torch.Generator().manual_seed(FLAGSHIP["seed"]), FLAGSHIP["batch_size"], data_cfg,
                            with_masks=True)
    return jparams, state, tuple(b.numpy() for b in batch)


def test_shipped_flagship_bf16_gap_is_the_references():
    jparams, state, batch = _flagship()
    runs = {}
    for name, bf16 in (("f32", False), ("bf16", True)):
        jcfg = jtrainer.TrainConfig(**FLAGSHIP, compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
        tcfg = T.TrainConfig(**FLAGSHIP, compute_dtype=torch.bfloat16 if bf16 else torch.float32)
        runs[f"jax_{name}"] = P.jax_value_and_grad(jcfg, jparams, batch)
        loss, grads, names = P.port_value_and_grad(tcfg, state, batch)
        runs[f"port_{name}"] = (loss, grads)
    runs["jax_bf16_rounded"] = P.jax_value_and_grad(jcfg, jparams, batch, excess_precision=False)
    flat = {k: (loss, P.flat_grads(grads, names)) for k, (loss, grads) in runs.items()}

    def rel(a, b):
        (la, ga), (lb, gb) = flat[a], flat[b]
        return {"loss_rel": (la - lb) / lb, "grad_norm_rel": float(ga.norm() - gb.norm()) / float(gb.norm()),
                "grad_cosine": P.cosine(ga, gb)}

    readings = {"losses": {k: v[0] for k, v in flat.items()},
                **{f"{a}_vs_{b}": rel(a, b) for a, b in (("port_f32", "jax_f32"), ("port_bf16", "jax_bf16"),
                                                        ("jax_bf16", "jax_f32"), ("jax_bf16_rounded", "jax_f32"),
                                                        ("port_bf16", "port_f32"))}}
    print(json.dumps({"flagship_bf16_vs_f32": readings}))
    f32, bf16 = readings["port_f32_vs_jax_f32"], readings["port_bf16_vs_jax_bf16"]
    assert abs(f32["loss_rel"]) <= 1e-5 and f32["grad_cosine"] >= 0.99999, readings
    assert abs(bf16["loss_rel"]) <= 1e-3, readings
    jax_gap, port_gap = readings["jax_bf16_vs_jax_f32"]["loss_rel"], readings["port_bf16_vs_port_f32"]["loss_rel"]
    assert abs(port_gap - jax_gap) <= 0.1 * abs(jax_gap), readings
    # the reference's own bf16 misses a 2 % bar on the loss at this state
    assert abs(jax_gap) > 0.02, readings
