"""PyTorch port: the train step of every branch in bf16 against the JAX
trainer in bf16.

The f32 parity files (tests/test_torch_train_step.py, _diffusion.py) cannot
see a bf16-only difference, such as a layer the port keeps in bf16 where the
reference keeps f32. Here both packages run their loss in bf16 on the CPU, on
the narrow models of tests/torch_train_parity.py (the JAX side compiled as it
runs, with XLA's excess precision on), and the port's rounding is held to the
reference's: the port's bf16 loss and gradients are no further from f32 than
the reference's own bf16 is (1.5x; the f32 anchor is the port's f32 run,
which the f32 parity files hold to the reference's at 1e-5), and the two
bf16 gradients agree (cosine >= 0.998). The sampler
draws its noise in the compute type, so its bf16 run injects JAX's bf16 draw.

XLA on the CPU sums a bf16 bias gradient in bf16 where PyTorch sums in f32,
so the reference's output-layer biases are the noisiest tensors here: the
bars are on the loss and the whole gradient. Each branch prints its readings
(pytest -s)."""

import json

import pytest
import torch

import torch_train_parity as P
from image_restoration_platform_tpu.train import trainer as jtrainer
from image_restoration_platform_tpu_torch.models import weights as W
from image_restoration_platform_tpu_torch.train import trainer as T

torch.set_num_threads(4)

SELF_GAP = 1.5  # the port's bf16 error over the reference's own
COSINE = 0.998


@pytest.mark.parametrize("branch", list(P.BRANCHES))
def test_bf16_train_loss_matches_jax_bf16(branch):
    with P.narrow_families():
        jparams = P._jax_params(P.BRANCHES[branch][0])
        batch = P._batch()
        state = W.params_from_jax(W.flatten_params(jparams))
        jcfg = P.train_config(branch, jtrainer, bf16=True)
        jbf16, jgrads = P.jax_value_and_grad(jcfg, jparams, batch)
        draws = P._jax_draws(jcfg, jcfg.family, 0, batch[1])
        tf32, fgrads, names = P.port_value_and_grad(P.train_config(branch, T), state, batch,
                                                    P._jax_draws(P.train_config(branch, jtrainer), jcfg.family, 0,
                                                                 batch[1]))
        tbf16, tgrads, _ = P.port_value_and_grad(P.train_config(branch, T, bf16=True), state, batch, draws)

    ref, jg, tg = (P.flat_grads(g, names) for g in (fgrads, jgrads, tgrads))
    print(json.dumps({branch: {"loss_f32": tf32, "jax_bf16_loss_gap": jbf16 - tf32, "port_bf16_loss_gap": tbf16 - tf32,
                               "jax_bf16_grad_dist": float((jg - ref).norm() / ref.norm()),
                               "port_bf16_grad_dist": float((tg - ref).norm() / ref.norm()),
                               "port_vs_jax_bf16_grad_cosine": P.cosine(tg, jg)}}))
    assert abs(tbf16 - tf32) <= SELF_GAP * abs(jbf16 - tf32) + 1e-7 * abs(tf32), (branch, tf32, jbf16, tbf16)
    jax_dist, port_dist = float((jg - ref).norm()), float((tg - ref).norm())
    assert port_dist <= SELF_GAP * jax_dist, (branch, jax_dist, port_dist)
    assert P.cosine(tg, jg) >= COSINE, (branch, P.cosine(tg, jg))
