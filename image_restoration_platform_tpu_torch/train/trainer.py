"""Training: the train step, AdamW with the reference's schedule, checkpoints.

Counterpart of image_restoration_platform_tpu/train/trainer.py on one card:

- loss: Charbonnier (robust L1) + gradient difference for edge fidelity, with
  the identity weighting and the compression-only anchor of the restore
  branch; SR, diffusion (eps / x0) and sampler-aware branches as there;
- optimizer: ``torch.optim.AdamW`` (fused, capturable) driven by optax's
  ``warmup_cosine_decay_schedule`` (step k takes the schedule's value at k,
  so step 0 takes lr 0), after optax's ``clip_by_global_norm(1.0)``; weight
  decay applies to every parameter, and a parameter that got no gradient
  gets a zero one, as in optax;
- executables (train/exec.py): as the reference jits its train step and
  each data distribution's draw, ``Trainer`` runs both through an
  executable tier keyed by their structure: on a card one CUDA graph for
  the train step (a mesh step too, where one card holds it) and one per
  ``DataConfig``, replayed every step; on the CPU, with ``eager=True`` and
  for a mesh over distinct devices the same code eagerly. A step
  is split for that into its host part (``TrainStep.prepare``: the
  schedule's lr into the optimizer's device tensor, the step's noise seed)
  and its device part (``TrainStep.update``), which reads nothing from the
  host;
- parameters and Adam moments stay f32; the layers cast weights to the
  activation type at each call (models/nn.py), so the forward runs in
  ``compute_dtype`` without ``cast_for_compute``, which is serving's;
- ``remat=True`` is ``torch.utils.checkpoint`` around the restore forward
  (the forward runs again in the backward: two attention launches a step);
- randomness: the model's init from ``seed``, the data from a generator
  seeded ``seed + 1`` that persists across ``run()`` calls, the diffusion
  noise of step k from a generator seeded from (``seed + 77``, k) or
  (``seed + 177``, k) for the sampler, like the reference's ``fold_in``
  (a CUDA graph registers both generators, so its replays draw what eager
  steps would);
- checkpoints: ``torch.save`` of params, optimizer state, step and the data
  stream in place of orbax; a resume copies them into the live tensors, so
  captured graphs stay valid;
- ``mesh`` (parallel/mesh.py): every data slot runs the forward and the
  backward on its shard of the batch with a replica of the model
  (column-parallel over its tensor slots when the tensor axis is larger than
  1); the outputs are gathered on the first slot, where the loss is computed
  over the whole batch, so one mesh step is the unsharded step whatever the
  loss's form. A slot on the model's own device with a tensor axis of 1
  runs the model itself, and autograd adds its shard's gradients into the
  model's; the gradients of the other replicas are added to them on the
  first slot. The model alone holds the optimizer; the clip and AdamW run
  there and the updated parameters are copied back to the other replicas. When a process
  group is up (``parallel.mesh.maybe_initialize_distributed``), the data
  axis also spans the processes: every process draws the same batch and
  runs its own part, the outputs are exchanged (``all_gather``) so every
  process computes the same loss, and the summed gradients are
  ``all_reduce``d before the clip. Every tensor a mesh step writes (the
  gradients of the model and of every replica, the sum of the copies'
  gradients, the exchanges' buffers) is allocated once and written in
  place, so the mesh step is one CUDA graph where the layout plan puts every
  data and tensor slot on the trainer's card (``parallel.mesh.capture_plan``)
  and any process group is NCCL's; elsewhere it runs eagerly under its key.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from ..models import diffusion as diff_mod
from ..models import get_family
from ..models import weights as weights_mod
from ..models.registry import check_attention_shapes
from ..models.srnet import SRNet
from ..parallel.mesh import AXIS_DATA, capture_plan, process_group_backend, process_span
from ..parallel.sharding import accumulate_grads_, scatter_state_, shard_params
from ..serve.engine import resolve_device
from ..serve.exec_cache import ExecCache, capture_stream, exec_key
from ..utils.logging import get_logger
from .data import DataConfig, synthetic_batch
from .exec import DataGraph, EagerStep, TrainGraph


@dataclass(frozen=True)
class TrainConfig:
    """The reference's TrainConfig, field for field, with ``compute_dtype`` a
    ``torch.dtype`` (each field's history is in its comments there)."""

    family: str = "restore-unet"
    batch_size: int = 32
    image_size: int = 128
    learning_rate: float = 2e-4
    weight_decay: float = 1e-4
    warmup_steps: int = 200
    total_steps: int = 10_000
    charbonnier_eps: float = 1e-3
    grad_loss_weight: float = 0.1
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    seed: int = 0
    # weight multiplier for near-identity examples in the restoration loss
    identity_weight: float = 3.0
    # > 0 (diffusion family only): train through the unrolled K-step DDIM
    # sampler against the clean target (sampler-aware fine-tuning)
    diffusion_sampler_steps: int = 0
    # the data distribution (DataConfig.photo / deconv / grain / smooth /
    # smooth_share / clean_fraction / compression_solo / lowlight_solo)
    data_photo: bool = False
    # fraction of batches drawn from the rich photo=False distribution
    data_mix_rich: float = 0.0
    data_deconv: bool = False
    # fraction of batches drawn with deconv=False (the mild photo distribution)
    data_mix_mild: float = 0.0
    data_grain: bool = False
    data_smooth: bool = False
    data_smooth_share: float = 0.10
    data_clean_fraction: float = 0.15
    data_compression_solo: float = 0.0
    data_lowlight_solo: float = 0.0
    # identity anchor on compression-only rows: lambda * charbonnier(pred,
    # INPUT), which wins only where the clean-target pull cancels out
    anchor_comp: float = 0.0


def charbonnier(pred, target, eps):
    return torch.mean(torch.sqrt((pred - target) ** 2 + eps * eps))


def identity_weighted_charbonnier(pred, target, inputs, eps, identity_weight=3.0):
    """Charbonnier with per-example weights that emphasise the near-identity
    regime (inputs already close to the target), so the model learns 'do no
    harm' on clean inputs."""
    per_ex = torch.mean(torch.sqrt((pred - target) ** 2 + eps * eps), dim=(1, 2, 3))  # [N]
    input_mse = torch.mean((inputs - target) ** 2, dim=(1, 2, 3))  # [N]
    w = 1.0 + identity_weight * torch.exp(-input_mse / 1e-3)
    return torch.sum(per_ex * w) / torch.sum(w)


def gradient_loss(pred, target):
    """L1 on spatial finite differences: keeps restored edges crisp."""
    dy_p, dy_t = pred[:, 1:] - pred[:, :-1], target[:, 1:] - target[:, :-1]
    dx_p, dx_t = pred[:, :, 1:] - pred[:, :, :-1], target[:, :, 1:] - target[:, :, :-1]
    return torch.mean((dy_p - dy_t).abs()) + torch.mean((dx_p - dx_t).abs())


def lr_schedule(cfg: TrainConfig):
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, total_steps,
    0.05 * lr) as a function of the step count."""
    warmup = min(cfg.warmup_steps, max(1, cfg.total_steps // 10))
    peak = cfg.learning_rate
    decay_steps = cfg.total_steps - warmup
    if decay_steps <= 0:
        raise ValueError(f"the cosine decay needs total_steps > the {warmup} warm-up steps, got {cfg.total_steps}")
    alpha = 0.0 if peak == 0.0 else (0.05 * peak) / peak

    def schedule(step: int) -> float:
        if step < warmup:
            return peak * step / warmup
        t = min(step - warmup, decay_steps)
        return peak * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps)) + alpha)

    return schedule


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.AdamW:
    """optax.adamw's update (b1 0.9, b2 0.999, eps 1e-8, decoupled weight
    decay on every parameter) as PyTorch's fused AdamW with
    ``capturable=True``: its learning rate is a 0-d f32 tensor on the
    parameters' device, which the train step fills from the schedule
    (``set_lr_``), and its step counts live there too, so an update reads
    nothing from the host and a CUDA graph can hold it. The fused kernel
    exists on the CPU as well (the foreach path that ``capturable=True``
    takes alone refuses CPU tensors), so the CPU tests hold the card's
    update: bias corrections from the device's f32 step count."""
    params = list(params)
    lr = torch.zeros((), dtype=torch.float32, device=params[0].device)
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay,
                             fused=True, capturable=True)


def set_lr_(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Fill the optimizer's learning-rate tensors with ``lr`` (a kernel on
    the device's stream: no synchronisation)."""
    for group in optimizer.param_groups:
        group["lr"].fill_(lr)


def trained_params(optimizer: torch.optim.Optimizer) -> list[torch.Tensor]:
    return [p for group in optimizer.param_groups for p in group["params"]]


def load_optimizer_state_(optimizer: torch.optim.Optimizer, saved: dict) -> None:
    """The Adam moments and step counts of ``saved`` (an optimizer
    ``state_dict``) copied into ``optimizer``'s own state tensors in place,
    so a CUDA graph that holds them stays valid; a parameter without saved
    state gets zeros (a fresh start). The hyperparameters stay the
    optimizer's: the schedule sets the learning rate at every step."""
    params = trained_params(optimizer)
    if any(i >= len(params) for i in saved["state"]):
        raise ValueError(f"the saved optimizer state covers {len(saved['state'])} tensors, not {len(params)}")
    for i, p in enumerate(params):
        state, kept = optimizer.state[p], saved["state"].get(i, {})
        if state:
            for key, value in state.items():
                if key in kept:
                    value.copy_(kept[key])
                else:
                    value.zero_()
        else:
            for key, value in kept.items():
                state[key] = value.to(p.device, torch.float32 if key == "step" else p.dtype, copy=True)


def clip_by_global_norm_(grads: list[torch.Tensor]) -> torch.Tensor:
    """optax.clip_by_global_norm(1.0) in place: g unchanged while the global
    norm is under 1, else g / norm. Returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_div_(grads, torch.clamp(norm, min=1.0))
    return norm


@dataclass
class TrainState:
    """The model (f32 parameters), its optimizer, and the steps taken; under
    a mesh also the model's replica on each data row, each row's first
    slot (``homes``), where its shard of the batch goes, and the buffers
    the mesh step writes in place (``exchange``)."""

    model: torch.nn.Module
    optimizer: torch.optim.AdamW
    step: int = 0
    replicas: list | None = None
    homes: list | None = None
    exchange: dict = dataclasses.field(default_factory=dict)

    @property
    def copies(self) -> list:
        """The replicas that are copies of the model (not the model itself)."""
        return [r for r in self.replicas or () if r is not self.model]


class TrainStep:
    """One optimizer step of ``cfg.family`` on ``device``: ``loss`` is the
    reference's ``loss_fn``; calling the object takes a step in place.

    ``draws`` injects the diffusion branches' random draws ({"t_frac",
    "eps"}, or {"noise"} for the sampler); by default they come from the
    step's generator (``seed``)."""

    def __init__(self, cfg: TrainConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        family = get_family(cfg.family)
        self.family = family
        self.model_cfg = family.config
        if not family.trainable:
            raise ValueError(f"the trainer has no loss for model family {cfg.family!r}: it trains the restore "
                             "UNets, the diffusion UNet and SRNet")
        self.is_sr = family.kind == "sr"
        self.is_diffusion = family.kind == "diffusion"
        self.schedule = lr_schedule(cfg)
        self.noise_gen = torch.Generator(device=device)

    def build_model(self) -> torch.nn.Module:
        """The family's module with random weights from ``cfg.seed``. SR
        trains with the residual limiter off (``limit_pool=0``): its clamp
        zeroes gradients outside the envelope. Same parameters as serving's."""
        gen = torch.Generator().manual_seed(self.cfg.seed)
        if self.is_sr:
            model = SRNet(dataclasses.replace(self.model_cfg, limit_pool=0))
        else:
            model = self.family.build()
        return model.init_(gen).to(self.device)

    def init_state(self) -> TrainState:
        model = self.build_model()
        return TrainState(model, make_optimizer(self.cfg, model.parameters()), 0)

    def seed(self, step: int) -> None:
        """Reseed the diffusion branches' generator for ``step``: each step's
        noise is a function of the step, as with ``fold_in(PRNGKey(base),
        step)``, (``seed + 77``, k) or (``seed + 177``, k) for the sampler."""
        if self.is_diffusion:
            base = self.cfg.seed + (177 if self.cfg.diffusion_sampler_steps > 0 else 77)
            self.noise_gen.manual_seed(base * 1_000_003 + step)

    def _inputs(self, degraded, clean, cond, draws: dict | None):
        """The model's per-example inputs for the whole batch (each with the
        batch on dim 0) and what the objective needs besides the output."""
        cfg, dt = self.cfg, self.cfg.compute_dtype
        if self.is_diffusion and cfg.diffusion_sampler_steps > 0:
            noise = draws["noise"] if draws else self.noise_gen
            return (degraded.to(dt), cond.to(dt), noise), {}
        if self.is_diffusion:
            # denoising loss: noise the clean image, condition on the
            # degraded one (3 extra channels) and its degradation profile
            n = clean.shape[0]
            x0 = clean * 2.0 - 1.0
            x_cond = degraded * 2.0 - 1.0
            if draws:
                t_frac, eps = draws["t_frac"], draws["eps"]
            else:
                t_frac = torch.rand((n,), generator=self.noise_gen, device=clean.device)
                eps = torch.randn(x0.shape, generator=self.noise_gen, device=clean.device)
            xt = diff_mod.add_noise(x0, eps, t_frac)
            x_in = torch.cat([xt, x_cond], dim=-1).to(dt)
            return (x_in, cond.to(dt), t_frac * self.model_cfg.timesteps), {"x0": x0, "xt": xt, "eps": eps}
        if self.is_sr:
            # low-res = box-downsampled degraded image, target = clean
            s = self.model_cfg.scale
            n, h, w, c = degraded.shape
            lr = degraded.reshape(n, h // s, s, w // s, s, c).mean(dim=(2, 4))
            return (lr.to(dt),), {}
        return (degraded.to(dt), cond.to(dt)), {}

    def _forward(self, model, *inputs) -> torch.Tensor:
        if self.is_diffusion and self.cfg.diffusion_sampler_steps > 0:
            # sampler-aware: the K-step DDIM restore with autograd on
            scfg = dataclasses.replace(self.model_cfg, sample_steps=self.cfg.diffusion_sampler_steps)
            return diff_mod.restore(model, *inputs, scfg)
        if self.is_diffusion:
            x_in, c, t = inputs
            return model(x_in, c, t=t)
        if self.cfg.remat and not self.is_sr:
            # the model draws no random numbers, so there is no generator
            # state to stash (reading it is refused under graph capture)
            return checkpoint(model, *inputs, use_reentrant=False, preserve_rng_state=False)
        return model(*inputs)

    def _objective(self, out, degraded, clean, anchor, aux: dict) -> torch.Tensor:
        """The loss of the whole batch's model output."""
        cfg = self.cfg
        if (self.is_diffusion and cfg.diffusion_sampler_steps > 0) or self.is_sr:
            # regress the final image on clean
            pred = out.float()
            return charbonnier(pred, clean, cfg.charbonnier_eps) + cfg.grad_loss_weight * gradient_loss(pred, clean)
        if self.is_diffusion:
            if self.model_cfg.parameterization == "x0":
                return torch.mean((out.float() - aux["x0"]) ** 2)
            return torch.mean((out.float() - aux["xt"] - aux["eps"]) ** 2)
        pred = out.float()
        loss = identity_weighted_charbonnier(pred, clean, degraded, cfg.charbonnier_eps, cfg.identity_weight)
        if cfg.anchor_comp > 0.0:
            # identity anchor on compression-only rows: a pull toward the INPUT
            per_ex = torch.mean(torch.sqrt((pred - degraded) ** 2 + cfg.charbonnier_eps**2), dim=(1, 2, 3))
            loss = loss + cfg.anchor_comp * torch.sum(anchor * per_ex) / torch.clamp(torch.sum(anchor), min=1.0)
        return loss + cfg.grad_loss_weight * gradient_loss(pred, clean)

    def loss(self, model, degraded, clean, cond, anchor, step: int = 0, draws: dict | None = None):
        """The reference's ``loss_fn`` of one batch."""
        if not draws:
            self.seed(step)
        return self._loss(model, degraded, clean, cond, anchor, draws)

    def _loss(self, model, degraded, clean, cond, anchor, draws: dict | None):
        """``loss`` with the noise generator as it stands."""
        inputs, aux = self._inputs(degraded, clean, cond, draws)
        return self._objective(self._forward(model, *inputs), degraded, clean, anchor, aux)

    def replicate(self, state: TrainState, mesh) -> None:
        """Give ``state`` a replica of its model on every data row of
        ``mesh`` (column-parallel over the row's tensor slots; the model
        itself on a row whose one slot is the model's device)."""
        state.replicas = [shard_params(state.model, mesh, i) for i in range(mesh.shape[AXIS_DATA])]
        state.homes = [mesh.tensor_slots(i)[0] for i in range(mesh.shape[AXIS_DATA])]

    def _mesh_loss(self, state: TrainState, degraded, clean, cond, anchor, draws: dict | None):
        """The loss of the whole batch with every data slot running its
        shard: the slots' outputs are gathered on this process's first slot
        (and across processes, where this process's part keeps its graph)."""
        inputs, aux = self._inputs(degraded, clean, cond, draws)
        processes, rank = process_span()
        dp = len(state.replicas)
        n = inputs[0].shape[0]
        if n % (dp * processes):
            raise ValueError(f"batch {n} not divisible by {dp} data slots x {processes} processes")
        per = n // (dp * processes)
        outs = []
        for i, (replica, home) in enumerate(zip(state.replicas, state.homes)):
            lo = (rank * dp + i) * per
            outs.append(self._forward(replica, *(a[lo : lo + per].to(home) for a in inputs)).to(self.device))
        out = torch.cat(outs, dim=0)
        if process_group_backend() is not None:
            import torch.distributed as dist

            key = ("gathered", tuple(out.shape), out.dtype)
            if key not in state.exchange:
                state.exchange[key] = [torch.empty_like(out) for _ in range(processes)]
            parts = state.exchange[key]
            dist.all_gather(parts, out.detach().contiguous())
            out = torch.cat([out if r == rank else part for r, part in enumerate(parts)], dim=0)
        return self._objective(out, degraded, clean, anchor, aux)

    def prepare(self, state: TrainState) -> None:
        """The host's part of the next step: the schedule's lr for it into
        the optimizer's tensor, and its noise seed."""
        set_lr_(state.optimizer, self.schedule(state.step))
        self.seed(state.step)

    def update(self, state: TrainState, degraded, clean, cond, anchor, draws: dict | None = None) -> torch.Tensor:
        """The device part of a step, which a CUDA graph can hold: the
        gradients (allocated by ``allocate_grads_``) zeroed in place, the
        loss and its backward, the global-norm clip and AdamW; under a mesh
        ``_mesh_update``. Returns the loss before the update."""
        if state.replicas is not None:
            return self._mesh_update(state, degraded, clean, cond, anchor, draws)
        grads = [p.grad for p in trained_params(state.optimizer)]
        torch._foreach_zero_(grads)
        loss = self._loss(state.model, degraded, clean, cond, anchor, draws)
        loss.backward()
        clip_by_global_norm_(grads)
        state.optimizer.step()
        return loss.detach()

    @staticmethod
    def allocate_grads_(state: TrainState) -> None:
        """A gradient tensor for every parameter, allocated once: the step
        accumulates into it, and a parameter the loss does not reach keeps
        zeros, as optax gives it. Under a mesh also the gradients of every
        copy of the model, the sum of the copies' gradients and the flat
        buffer of the gradients' ``all_reduce``."""
        params = trained_params(state.optimizer)
        for p in params + [p for r in state.copies for p in r.parameters()]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if state.copies and "grads" not in state.exchange:
            state.exchange["grads"] = {name: torch.zeros_like(p) for name, p in state.model.named_parameters()}
        if state.replicas is not None and process_group_backend() is not None and "flat" not in state.exchange:
            state.exchange["flat"] = torch.zeros(sum(p.numel() for p in params), device=params[0].device)

    def __call__(self, state: TrainState, degraded, clean, cond, anchor, draws: dict | None = None) -> torch.Tensor:
        """One step, eagerly: loss, gradients, global-norm clip, AdamW at the
        schedule's lr for this step. Returns the loss before the update."""
        self.prepare(state)
        self.allocate_grads_(state)
        loss = self.update(state, degraded, clean, cond, anchor, draws)
        state.step += 1
        return loss

    def _mesh_update(self, state: TrainState, degraded, clean, cond, anchor, draws: dict | None) -> torch.Tensor:
        """``update`` with every data slot running its shard of the batch,
        writing only what ``allocate_grads_`` allocated; the updated
        parameters are copied into the replicas that are copies."""
        params = trained_params(state.optimizer)
        copies = state.copies
        torch._foreach_zero_([p.grad for p in params] + [p.grad for r in copies for p in r.parameters()])
        loss = self._mesh_loss(state, degraded, clean, cond, anchor, draws)
        loss.backward()
        # the loss is the whole batch's, so each replica holds its shard's
        # part of the gradient: the copies' parts are summed in turn, then
        # added to what the slots running the model itself left in it
        if copies:
            summed = state.exchange["grads"]
            torch._foreach_zero_(list(summed.values()))
            for replica in copies:
                accumulate_grads_(replica, summed)
            with torch.no_grad():
                for name, p in state.model.named_parameters():
                    p.grad.add_(summed[name])
        if process_group_backend() is not None:
            import torch.distributed as dist

            flat = state.exchange["flat"]
            torch.cat([p.grad.reshape(-1) for p in params], out=flat)
            dist.all_reduce(flat)
            torch._foreach_copy_([p.grad for p in params],
                                 [v.view_as(p) for v, p in zip(flat.split([p.numel() for p in params]), params)])
        clip_by_global_norm_([p.grad for p in params])
        state.optimizer.step()
        self.sync_replicas(state)
        return loss.detach()

    @staticmethod
    def sync_replicas(state: TrainState) -> None:
        """Copy the model's parameters into its replicas that are copies, in place."""
        master = dict(state.model.named_parameters())
        for replica in state.copies:
            scatter_state_(replica, master)


def make_train_step(cfg: TrainConfig, device: str | torch.device = "cuda"):
    """Returns (train_step, init_state), as the reference does; train_step
    updates a TrainState in place and returns the loss."""
    step = TrainStep(cfg, resolve_device(device))
    return step, step.init_state


class Trainer:
    def __init__(
        self,
        cfg: TrainConfig = TrainConfig(),
        device: str | torch.device | None = None,
        checkpoint_dir: str | None = None,
        warm_start: bool = False,
        mesh=None,
        eager: bool = False,
    ):
        """``device`` defaults to "cuda", or with a ``mesh`` to its first
        slot, which holds the f32 model and the optimizer. ``eager`` runs the
        train step and the data draws eagerly on a card instead of replaying
        their CUDA graphs, to compare the two; on the CPU they always run
        eagerly, and so does a mesh that a capture cannot hold
        (``_eager_by_plan``)."""
        self.cfg = cfg
        if mesh is not None:
            if device is not None and torch.device(device).type != mesh.primary.type:
                raise ValueError(f"trainer device {device} is not on the mesh's slots ({mesh.primary})")
            device = mesh.primary
        self.mesh = mesh
        self.device = resolve_device("cuda" if device is None else device)
        self.logger = get_logger("trainer")
        if self.device.type == "cuda":
            per_slot = cfg.batch_size // (mesh.shape[AXIS_DATA] if mesh is not None else 1)
            check_attention_shapes(cfg.family, (cfg.image_size,), max(per_slot, 1), cfg.compute_dtype)
        self.step_fn, self._init = make_train_step(cfg, self.device)
        self.state = self._init()
        if warm_start:
            # resume from the family's exported serving weights
            path = weights_mod.weights_path(cfg.family)
            if os.path.exists(path):
                self.state.model.load_state_dict(weights_mod.load_state_dict(path), strict=True)
                self.logger.info("warm-started from weights", {"path": path})
        if mesh is not None and mesh.size > 1:
            self.step_fn.replicate(self.state, mesh)
        self.checkpoint_dir = checkpoint_dir
        photo = dict(
            photo=cfg.data_photo, grain=cfg.data_grain, smooth=cfg.data_smooth, smooth_share=cfg.data_smooth_share,
            clean_fraction=cfg.data_clean_fraction, compression_solo=cfg.data_compression_solo,
            lowlight_solo=cfg.data_lowlight_solo,
        )
        self._data_cfg = DataConfig(size=cfg.image_size, deconv=cfg.data_deconv, **photo)
        self._data_cfg_rich = DataConfig(size=cfg.image_size, photo=False, clean_fraction=cfg.data_clean_fraction)
        self._data_cfg_mild = DataConfig(size=cfg.image_size, deconv=False, **photo)
        self._data_gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self._mix_acc = 0.0
        self._mix_acc_mild = 0.0
        self.eager = eager
        self._exec_cache = ExecCache()
        self._graph_pool = None  # every graph's memory pool, made at the first capture
        self._capture_streams: dict = {}

    # ---------------------------------------------------- executable tier

    @property
    def compile_count(self) -> int:
        """Executables built: the train step's and one per data distribution."""
        return self._exec_cache.compile_count

    def exec_stats(self) -> dict:
        """compile_count, the executables built and the CUDA graphs
        captured; on a mesh also the executables a card runs eagerly by the
        layout plan (``_eager_by_plan``)."""
        stats = {"compile_count": self.compile_count, **self._exec_cache.stats()}
        if self.mesh is not None:
            stats["eager_executables"] = self._exec_cache.count("eager_by_plan")
        return stats

    def _eager_by_plan(self) -> bool:
        """A mesh step that a card cannot hold in one CUDA graph: its data
        and tensor slots are distinct devices (``capture_plan``), or its
        process group is not NCCL's."""
        if self.state.replicas is None:
            return False
        return capture_plan(self.mesh).grid != self.device or process_group_backend() not in (None, "nccl")

    def _captures(self) -> bool:
        return self.device.type == "cuda" and not self.eager and not self._eager_by_plan()

    def _pool(self) -> tuple:
        """(memory pool, capture stream) of every graph of this trainer."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return self._graph_pool, capture_stream(self._capture_streams, self.device)

    def _step_executable(self, batch):
        """The train step's executable for ``batch``'s shapes: the
        structure of the step (family, batch, size, compute type, remat,
        sampler steps, device and mesh), then the batch's shapes and types."""
        cfg = self.cfg
        mesh = None if self.mesh is None else tuple(self.mesh.shape.items())
        structural = (cfg.family, cfg.batch_size, cfg.image_size, str(cfg.compute_dtype), cfg.remat,
                      cfg.diffusion_sampler_steps, str(self.device), mesh)

        def build():
            if self._captures():
                return TrainGraph(self.step_fn, self.state, batch, *self._pool())
            by_plan = self.device.type == "cuda" and not self.eager
            if by_plan:
                self.logger.warning("the mesh train step runs eagerly: its slots are distinct devices "
                                    "or its process group is not NCCL's", {"mesh": repr(self.mesh)})
            return EagerStep(self.step_fn, self.state, eager_by_plan=by_plan)

        return self._exec_cache.get(exec_key("train", structural, batch), build)

    def _draw_executable(self, data_cfg: DataConfig):
        """The data draw's executable for ``data_cfg`` at this batch size."""
        def draw():
            return synthetic_batch(self._data_gen, self.cfg.batch_size, data_cfg, with_masks=True)

        def build():
            return DataGraph(draw, self._data_gen, *self._pool()) if self._captures() else draw

        key = exec_key("data", (data_cfg, self.cfg.batch_size, str(self.device)), ())
        return self._exec_cache.get(key, build)

    def _next_data_config(self) -> DataConfig:
        """The distribution of the next batch: deterministic, fraction-exact
        interleaves of the rich and the mild distributions (error-diffusion
        accumulators that advance every step; on a collision rich wins and
        the mild credit carries to the next step)."""
        cfg, cfg_step = self.cfg, self._data_cfg
        if cfg.data_photo and cfg.data_mix_rich > 0.0:
            self._mix_acc += cfg.data_mix_rich
            if self._mix_acc >= 1.0:
                self._mix_acc -= 1.0
                cfg_step = self._data_cfg_rich
        if cfg.data_photo and cfg.data_deconv and cfg.data_mix_mild > 0.0:
            self._mix_acc_mild += cfg.data_mix_mild
            if self._mix_acc_mild >= 1.0 and cfg_step is self._data_cfg:
                self._mix_acc_mild -= 1.0
                cfg_step = self._data_cfg_mild
        return cfg_step

    def next_batch(self):
        """The next step's (degraded, clean, cond, comp_only) from the data
        stream, drawn by its distribution's executable. Where that replays a
        CUDA graph these are its output buffers, which its next draw
        overwrites: clone what is kept."""
        return self._draw_executable(self._next_data_config())()

    def train_step(self, batch) -> torch.Tensor:
        """One step on ``batch`` through the step executable; returns the
        loss before the update (where that replays a CUDA graph, its output
        buffer, which the next step overwrites)."""
        return self._step_executable(batch)(batch)

    def run(self, steps: int, log_every: int = 50) -> list[float]:
        """``steps`` train steps on fresh synthetic batches; returns the
        losses of the logged steps. The data stream persists across calls,
        so a long schedule can be chunked without repeating batches."""
        losses = []
        t0 = time.time()
        for i in range(steps):
            loss = self.train_step(self.next_batch())
            if i % log_every == 0 or i == steps - 1:
                loss_val = float(loss)
                losses.append(loss_val)
                self.logger.info(
                    "train step",
                    {
                        "step": self.state.step,
                        "loss": round(loss_val, 5),
                        "imgs_per_sec": round(self.cfg.batch_size * (i + 1) / (time.time() - t0), 1),
                    },
                )
        return losses

    # ------------------------------------------------------- checkpointing

    def save_checkpoint(self, path: str | None = None) -> str:
        """``{path}/step_<k>.pt``: params, optimizer state, step, and the
        data stream (generator state and interleave accumulators)."""
        path = path or self.checkpoint_dir
        if path is None:
            raise ValueError("no checkpoint directory configured")
        os.makedirs(path, exist_ok=True)
        out = os.path.join(path, f"step_{self.state.step}.pt")
        torch.save(
            {
                "params": self.state.model.state_dict(),
                "opt_state": self.state.optimizer.state_dict(),
                "step": self.state.step,
                "data": {"rng": self._data_gen.get_state(), "mix_acc": self._mix_acc,
                         "mix_acc_mild": self._mix_acc_mild},
            },
            out,
        )
        return out

    def load_params(self, path: str) -> dict[str, torch.Tensor]:
        return torch.load(path, map_location="cpu")["params"]

    def resume_checkpoint(self, path: str) -> None:
        """Restore params, Adam moments, step and the data stream, so
        continued training keeps its Adam state, schedule position and
        batches. Everything is copied into the live tensors, so the
        executables built before stay valid."""
        saved = torch.load(path, map_location="cpu")
        self.state.model.load_state_dict(saved["params"], strict=True)
        load_optimizer_state_(self.state.optimizer, saved["opt_state"])
        self.state.step = int(saved["step"])
        self.step_fn.sync_replicas(self.state)
        self._data_gen.set_state(saved["data"]["rng"])
        self._mix_acc = float(saved["data"]["mix_acc"])
        self._mix_acc_mild = float(saved["data"]["mix_acc_mild"])
