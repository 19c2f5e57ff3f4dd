"""Shared by tests/test_torch_train_step.py and test_torch_train_diffusion.py:
the train step of every branch of the port against the JAX trainer.

Narrow models (base 16, norm groups of two channels, 32 px, batch 2) are
registered under the same names in both packages; the JAX package's
``make_train_step`` runs its own ``loss_fn`` and optax optimizer at
``precision=HIGHEST`` in f32, the port's ``TrainStep`` in f32 on the CPU,
from the same parameters (JAX's init via ``params_from_jax``; the zero
output heads are given random weights in both, so that every parameter
gets a gradient from the first step) and the same numpy batch. The
diffusion branches get the JAX draws of each step (``fold_in`` of the
step's key) injected.

Bars, at every step:
- the loss at rtol 1e-5, on the reference's parameters and on the port's own
  trajectory;
- each parameter's gradient, at the reference's parameters, within 3e-5 of
  its tensor's largest gradient (measured up to 1.8e-5 on the first layer of
  the conditioning MLP, whose gradient sums the FiLM paths of every block
  and cancels: its largest element is ~1e-5);
- after each step, each parameter within 1e-5 of its tensor's largest value,
  plus, per element, the sum over the steps so far of lr times
  min(2, 1e-4 x (tensor's largest gradient / the element's gradient)). Adam
  divides each gradient by its own running size, so an element whose
  gradient is small against its tensor's largest still moves by ~lr and
  carries its gradient's relative round-off (bounded by the gradient bar
  over the element's size) into that step. The bias of the attention keys
  has no gradient at all (softmax is invariant to a shift of every logit in
  a row): it is held to a round-off gradient (1e-6 of the tensor's largest)
  in both, and its elements take the 2 lr allowance."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from image_restoration_platform_tpu.models import diffusion as jdiff
from image_restoration_platform_tpu.models import registry as jreg
from image_restoration_platform_tpu.models import srnet as jsrnet
from image_restoration_platform_tpu.models import unet as junet
from image_restoration_platform_tpu.train import trainer as jtrainer
from image_restoration_platform_tpu_torch.models import registry as treg
from image_restoration_platform_tpu_torch.models import weights as W
from image_restoration_platform_tpu_torch.models.diffusion import DiffusionConfig
from image_restoration_platform_tpu_torch.models.srnet import SRNetConfig
from image_restoration_platform_tpu_torch.models.unet import UNetConfig
from image_restoration_platform_tpu_torch.train import trainer as T

N, SIZE = 2, 32
GRAD_REL = 3e-5
ADAM_REL = 1e-4
NARROW = dict(base_channels=16, channel_mults=(1, 2), blocks_per_level=1, attn_heads=2, norm_groups=8)
# branch -> (family, TrainConfig extras); the SR family's name must start
# with "sr-" (the reference picks the SR branch by name)
BRANCHES = {
    "restore_anchor": ("restore-narrow", dict(anchor_comp=0.5, identity_weight=6.0)),
    "sr": ("sr-x2-narrow", {}),
    "diffusion_eps": ("diffusion-narrow-eps", {}),
    "diffusion_x0": ("diffusion-narrow", {}),
    "sampler_aware": ("diffusion-narrow", dict(diffusion_sampler_steps=2)),
}


def _configs():
    """family -> (JAX config, port config), the same numbers."""
    restore = dict(NARROW, input_scale=2, residual_shrink=0.01)
    diff = dict(NARROW, in_channels=6, time_conditioned=True)
    return {
        "restore-narrow": (junet.UNetConfig(**restore), UNetConfig(**restore)),
        "sr-x2-narrow": (jsrnet.SRNetConfig(scale=2, channels=16, num_blocks=2),
                         SRNetConfig(scale=2, channels=16, num_blocks=2)),
        "diffusion-narrow": (jdiff.DiffusionConfig(unet=junet.UNetConfig(**diff)),
                             DiffusionConfig(unet=UNetConfig(**diff))),
        "diffusion-narrow-eps": (jdiff.DiffusionConfig(parameterization="eps", unet=junet.UNetConfig(**diff)),
                                 DiffusionConfig(parameterization="eps", unet=UNetConfig(**diff))),
    }


@contextlib.contextmanager
def narrow_families():
    """The narrow families registered in both packages while the block runs."""
    saved_j, saved_t = dict(jreg._FAMILIES), dict(treg._FAMILIES)
    for name, (jcfg, tcfg) in _configs().items():
        if isinstance(jcfg, jsrnet.SRNetConfig):
            jreg.register(jreg.ModelFamily(name, jsrnet.init, jsrnet.apply, jcfg))
        elif isinstance(jcfg, jdiff.DiffusionConfig):
            jreg.register(jreg.ModelFamily(name, jdiff.init, jdiff.restore, jcfg))
        else:
            jreg.register(jreg.ModelFamily(name, junet.init, junet.apply, jcfg))
        treg.register(treg.ModelFamily(name, tcfg))
    try:
        yield
    finally:
        jreg._FAMILIES.clear()
        jreg._FAMILIES.update(saved_j)
        treg._FAMILIES.clear()
        treg._FAMILIES.update(saved_t)


def train_config(branch, module, bf16=False):
    family, extra = BRANCHES[branch]
    if module is jtrainer:
        dtype = jnp.bfloat16 if bf16 else jnp.float32
    else:
        dtype = torch.bfloat16 if bf16 else torch.float32
    return module.TrainConfig(family=family, batch_size=N, image_size=SIZE, learning_rate=1e-3, warmup_steps=2,
                              total_steps=20, compute_dtype=dtype, seed=3, **extra)


def _batch(seed=0):
    """(degraded, clean, cond, anchor) made with numpy: smooth clean images,
    degraded by noise and a darkening; the first row is anchored."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32) / SIZE
    phase = rng.uniform(0, 6.28, (N, 1, 1, 3)).astype(np.float32)
    clean = 0.5 + 0.35 * np.sin(6.0 * xx[None, :, :, None] + 4.0 * yy[None, :, :, None] + phase)
    degraded = np.clip(clean * 0.8 + rng.normal(0, 0.05, clean.shape), 0, 1).astype(np.float32)
    cond = rng.uniform(0, 1, (N, 28)).astype(np.float32)
    return degraded, clean.astype(np.float32), cond, np.asarray([1.0, 0.0], np.float32)


@functools.lru_cache(maxsize=None)
def _jax_init(network, seed=3):
    """JAX's init of one network config (the diffusion families share theirs)."""
    init = jsrnet.init if isinstance(network, jsrnet.SRNetConfig) else junet.init
    return jax.jit(lambda key: init(key, network))(jax.random.PRNGKey(seed))


def _jax_params(family, seed=3):
    """JAX's init with the zero output head replaced by random weights."""
    config = jreg.get_family(family).config
    params = jax.tree_util.tree_map(lambda x: x, _jax_init(getattr(config, "unet", config), seed))
    head = "up" if family.startswith("sr-") else "head"
    w = params[head]["w"]
    params[head]["w"] = jax.random.normal(jax.random.PRNGKey(seed + 1), w.shape) * 0.05
    return params


def _jax_draws(cfg, family, step, clean):
    """The random draws of the JAX loss at ``step``, for the port."""
    if not family.startswith("diffusion"):
        return None
    if cfg.diffusion_sampler_steps > 0:
        # the sampler draws its noise in the compute type
        key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed + 177), step)
        noise = jax.random.normal(key, clean.shape, cfg.compute_dtype).astype(jnp.float32)
        return {"noise": torch.from_numpy(np.array(noise))}
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed + 77), step)
    k_t, k_eps = jax.random.split(key)
    return {"t_frac": torch.from_numpy(np.array(jax.random.uniform(k_t, (clean.shape[0],)))),
            "eps": torch.from_numpy(np.array(jax.random.normal(k_eps, clean.shape)))}


def _key_bias(name):
    """The key slice of an attention qkv bias (channels C..2C of 3C), else None."""
    if name.endswith("attn.qkv.b"):
        c = NARROW["base_channels"] * NARROW["channel_mults"][-1]
        return slice(c, 2 * c)
    return None


def jax_loss_fn(cfg):
    """The reference's own loss_fn for ``cfg``, taken out of its train step."""
    step, _ = jtrainer.make_train_step(cfg)
    inner = step.__wrapped__
    free = dict(zip(inner.__code__.co_freevars, (c.cell_contents for c in inner.__closure__)))
    return free["loss_fn"]


@functools.lru_cache(maxsize=None)
def _jax_loss_and_optimizer(branch):
    """The reference's loss_fn (jitted with its gradient) and optimizer, once
    per branch."""
    return jax.jit(jax.value_and_grad(jax_loss_fn(train_config(branch, jtrainer)))), _jax_optimizer()


@functools.lru_cache(maxsize=None)
def _jax_optimizer():
    """The reference's optimizer for the shared schedule (the branches'
    TrainConfigs differ in nothing it reads), jitted once."""
    optimizer = jtrainer.make_optimizer(train_config("sr", jtrainer))
    return jax.jit(optimizer.init), jax.jit(optimizer.update)


def check_train_steps(branch: str, steps: int, through_trainer: bool = False) -> None:
    """``steps`` steps of ``branch`` in both packages, held to the bars above.
    ``through_trainer`` takes the port's steps through ``Trainer.train_step``
    (the executable tier) instead of calling ``TrainStep``; it cannot inject
    the diffusion draws."""
    jcfg, tcfg = train_config(branch, jtrainer), train_config(branch, T)
    family = tcfg.family
    batch = _batch()
    jbatch = tuple(jnp.asarray(a) for a in batch)
    tbatch = tuple(torch.from_numpy(a) for a in batch)

    with jax.default_matmul_precision("highest"):
        value_and_grad, (opt_init, opt_update) = _jax_loss_and_optimizer(branch)
        jparams = _jax_params(family)
        opt_state = opt_init(jparams)

        ts, _ = T.make_train_step(tcfg, "cpu")
        if through_trainer:
            trainer = T.Trainer(tcfg, device="cpu")
            state = trainer.state
            model = state.model
        else:
            model = ts.build_model()
            state = T.TrainState(model, T.make_optimizer(tcfg, model.parameters()), 0)
        model.load_state_dict(W.params_from_jax(W.flatten_params(jparams)), strict=True)
        names = [n for n, _ in model.named_parameters()]
        allowance = {name: 0.0 for name in names}  # the lr term of each element's bar
        conditioning = {name: 0.0 for name in names}

        for step in range(steps):
            jloss, jgrads = value_and_grad(jparams, *jbatch, step)
            draws = _jax_draws(jcfg, family, step, batch[1])
            # the port's loss and gradients at the reference's parameters
            at_ref = ts.build_model()
            at_ref.load_state_dict(W.params_from_jax(W.flatten_params(jparams)), strict=True)
            tloss = ts.loss(at_ref, *tbatch, step, draws)
            tgrads = torch.autograd.grad(tloss, list(at_ref.parameters()))
            np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
            ref_grads = W.params_from_jax(W.flatten_params(jgrads))
            for name, g in zip(names, tgrads):
                ref = ref_grads[name].numpy()
                top = np.abs(ref).max()
                key = _key_bias(name)
                if key is not None:
                    assert np.abs(ref[key]).max() <= 1e-6 * top and g[key].abs().max() <= 1e-6 * top, name
                np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=GRAD_REL * top + 1e-12,
                                           err_msg=f"{branch} step {step} grad {name}")
                conditioning[name] = np.maximum(conditioning[name], top / np.maximum(np.abs(ref), 1e-30))
                allowance[name] = allowance[name] + ts.schedule(step) * np.minimum(2.0, ADAM_REL * conditioning[name])

            # one step of each
            updates, opt_state = opt_update(jgrads, opt_state, jparams)
            jparams = optax.apply_updates(jparams, updates)
            if through_trainer:
                assert draws is None, "the trainer draws its own diffusion noise"
                loss = trainer.train_step(tbatch)
            else:
                loss = ts(state, *tbatch, draws=draws)
            np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
            ref_params = W.params_from_jax(W.flatten_params(jparams))
            for name, p in model.named_parameters():
                ref = ref_params[name].numpy()
                excess = np.abs(p.detach().numpy() - ref) - (1e-5 * np.abs(ref).max() + allowance[name])
                assert excess.max() <= 0.0, f"{branch} step {step} param {name}: {excess.max()} over the bar"
        assert state.step == steps


def flat_grads(grads, names):
    return torch.cat([grads[n].double().flatten() for n in names])


def cosine(a, b):
    return float(a @ b) / float(a.norm() * b.norm())


def jax_value_and_grad(cfg, params, batch, excess_precision=True):
    """The reference's loss and gradients (port names) at step 0.
    ``excess_precision=False`` makes XLA round to bf16 after every op, as
    eager PyTorch does, instead of keeping f32 inside its fusions."""
    args = (params, *(jnp.asarray(a) for a in batch), 0)
    with jax.default_matmul_precision("highest"):
        compiled = jax.jit(jax.value_and_grad(jax_loss_fn(cfg))).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": excess_precision})
        loss, grads = compiled(*args)
    return float(loss), W.params_from_jax(W.flatten_params(jax.tree_util.tree_map(np.asarray, grads)))


def port_value_and_grad(cfg, state, batch, draws=None):
    """The port's loss, gradients and parameter names at step 0 on the CPU."""
    ts = T.TrainStep(cfg, torch.device("cpu"))
    model = ts.build_model()
    model.load_state_dict(state, strict=True)
    loss = ts.loss(model, *(torch.as_tensor(a) for a in batch), 0, draws)
    names = [n for n, _ in model.named_parameters()]
    return loss.item(), dict(zip(names, torch.autograd.grad(loss, list(model.parameters())))), names
