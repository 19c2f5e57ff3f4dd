"""PyTorch port: the losses, the schedule and the optimizer of the trainer
against the JAX ``train/trainer.py`` and optax.

The three losses at atol 1e-6 on numpy inputs; the learning rate at every
step of three schedules against optax's ``warmup_cosine_decay_schedule``
(the reference's ``make_optimizer``) at atol 1e-9 (rates are ~1e-3); three
steps of AdamW after the global-norm clip on a fixed parameter tree and
fixed gradients (the clip triggering on one step and not on the others)
against the reference's optax chain at atol 1e-6, through the port's
optimizer as the train step drives it (fused AdamW with ``capturable=True``,
the learning rate a tensor filled by ``set_lr_``, the step count on the
device). optax computes Adam's bias corrections in f32 (1 - 0.999**k from
the f32 0.999); the fused kernel from the f32 step count in f64 on the CPU:
the updates differ by ~1e-5 of lr at the second step, inside the bar at lr
1e-2."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_restoration_platform_tpu.train import trainer as J
from image_restoration_platform_tpu_torch.train import trainer as T

torch.set_num_threads(2)


def _pair(seed):
    rng = np.random.default_rng(seed)
    pred = rng.random((3, 16, 16, 3)).astype(np.float32)
    target = np.clip(pred + rng.normal(0, 0.05, pred.shape), 0, 1).astype(np.float32)
    inputs = np.clip(target + rng.normal(0, 0.02, pred.shape) * np.asarray([0.1, 1, 3])[:, None, None, None],
                     0, 1).astype(np.float32)
    return pred, target, inputs


@pytest.mark.parametrize("loss", ["charbonnier", "identity_weighted_charbonnier", "gradient_loss"])
def test_losses_match_jax(loss):
    pred, target, inputs = _pair(0)
    args = {"charbonnier": (1e-3,), "identity_weighted_charbonnier": (inputs, 1e-3, 6.0), "gradient_loss": ()}[loss]
    ref = getattr(J, loss)(jnp.asarray(pred), jnp.asarray(target), *[jnp.asarray(a) if isinstance(a, np.ndarray)
                                                                     else a for a in args])
    got = getattr(T, loss)(torch.from_numpy(pred), torch.from_numpy(target),
                           *[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args])
    np.testing.assert_allclose(float(got), float(ref), rtol=0, atol=1e-6)


SCHEDULES = [
    dict(learning_rate=2e-4, warmup_steps=200, total_steps=10_000),
    dict(learning_rate=2e-5, warmup_steps=200, total_steps=50),  # warm-up = total // 10
    dict(learning_rate=1e-3, warmup_steps=3, total_steps=12),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=["default", "short", "tiny"])
def test_lr_schedule_matches_optax(kw):
    jcfg, tcfg = J.TrainConfig(**kw), T.TrainConfig(**kw)
    warmup = min(jcfg.warmup_steps, max(1, jcfg.total_steps // 10))
    ref = optax.warmup_cosine_decay_schedule(0.0, jcfg.learning_rate, warmup, jcfg.total_steps,
                                             jcfg.learning_rate * 0.05)
    ours = T.lr_schedule(tcfg)
    steps = sorted(set(range(0, min(jcfg.total_steps + 20, 400))) | {jcfg.total_steps // 2, jcfg.total_steps})
    for k in steps:
        assert abs(ours(k) - float(ref(k))) <= 1e-9, (k, ours(k), float(ref(k)))
    assert ours(0) == 0.0


def test_adamw_with_clip_matches_optax():
    kw = dict(learning_rate=1e-2, weight_decay=0.5, warmup_steps=1, total_steps=10)
    optimizer = J.make_optimizer(J.TrainConfig(**kw))
    rng = np.random.default_rng(4)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32), "b": np.zeros(5, np.float32),
              "s": np.ones(3, np.float32)}
    # global norms ~0.5, ~20 (clipped), ~0.05
    grads = [{k: (rng.normal(size=v.shape) * scale).astype(np.float32) for k, v in params.items()}
             for scale in (0.1, 4.0, 0.01)]
    jparams, state = {k: jnp.asarray(v) for k, v in params.items()}, None
    state = optimizer.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    tcfg = T.TrainConfig(**kw)
    topt, sched = T.make_optimizer(tcfg, list(tparams.values())), T.lr_schedule(tcfg)
    for k, g in enumerate(grads):
        updates, state = optimizer.update({n: jnp.asarray(v) for n, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        T.set_lr_(topt, sched(k))
        for n, p in tparams.items():
            p.grad = torch.from_numpy(g[n].copy())
        norm = T.clip_by_global_norm_([p.grad for p in tparams.values()])
        want = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in g.values()))
        assert abs(float(norm) - want) <= 1e-5 * want
        topt.step()
        for n, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[n]), rtol=0, atol=1e-6,
                                       err_msg=f"step {k} {n}")
    # the decay reached the parameter whose gradients were zero-mean noise
    assert not np.allclose(np.asarray(jparams["s"]), 1.0)


def test_clip_leaves_small_gradients_untouched():
    g = [torch.tensor([0.3, -0.4]), torch.tensor([0.5])]
    before = [x.clone() for x in g]
    norm = T.clip_by_global_norm_(g)
    assert float(norm) < 1.0 and all(torch.equal(a, b) for a, b in zip(g, before))
    big = [torch.tensor([3.0, 4.0])]
    T.clip_by_global_norm_(big)
    np.testing.assert_allclose(big[0].numpy(), [0.6, 0.8], rtol=1e-6)
