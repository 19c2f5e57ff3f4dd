"""GPipe-style pipeline parallelism over the mesh's ``pipe`` slots.

Counterpart of image_restoration_platform_tpu/parallel/pipeline.py. Each
stage slot holds one contiguous part of the network; microbatches enter
stage 0 one tick after another and move to the next stage's slot after
each tick, so the schedule takes ``n_micro + pipe - 1`` ticks with the
classic fill and drain bubbles (``pipeline_bubble_fraction``). The
reference's stages are one SPMD program that ``ppermute``s a packed buffer
between devices and computes on zeros in its bubbles; here the carry (a
dict of tensors) is copied to the next stage's slot as it is, and a stage
with no microbatch in a tick does nothing.

- SRNet (``srnet_pipeline_apply``): its body is a chain of identical
  residual blocks, split evenly over the stages; the stem and the head run
  outside the pipe on the first slot.
- UNet (``unet_pipeline_apply``): the network split into segments at its
  structural boundaries (stem, each encoder level, the bottleneck, each
  decoder level, the head), grouped into ``pipe`` stages. The FiLM
  embedding is computed once, and travels with the activation, the encoder
  skips not yet consumed and the base image of the global residual. With a
  data axis, every microbatch is also split over the data rows, each with
  its own pipe.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models import nn as L
from ..models.srnet import residual_limit
from .mesh import AXIS_DATA, AXIS_PIPE, Mesh
from .sharding import gather, replicate


def pipeline_bubble_fraction(n_micro: int, pipe: int) -> float:
    """Idle fraction of the static GPipe schedule."""
    return (pipe - 1) / (n_micro + pipe - 1)


def _to(carry, device):
    """A carry (tensors, tuples and dicts of them) copied to ``device``."""
    if isinstance(carry, torch.Tensor):
        return carry.to(device)
    if isinstance(carry, tuple):
        return tuple(_to(v, device) for v in carry)
    return {k: _to(v, device) for k, v in carry.items()}


def _gpipe(stage_fns, slots: list, payloads: list) -> list:
    """Run ``payloads`` (one per microbatch, on any slot) through the stage
    functions, stage p on ``slots[p]``, on the static schedule; returns the
    last stage's outputs in microbatch order."""
    pipe, n_micro = len(stage_fns), len(payloads)
    state = [None] * pipe
    done = [None] * n_micro
    for tick in range(n_micro + pipe - 1):
        if tick < n_micro:
            state[0] = _to(payloads[tick], slots[0])
        state = [None if s is None else fn(s) for fn, s in zip(stage_fns, state)]
        if tick >= pipe - 1:
            done[tick - pipe + 1] = state[-1]
        # every stage hands its carry to the next stage's slot
        state = [None] + [None if s is None else _to(s, slots[p + 1]) for p, s in enumerate(state[:-1])]
    return done


def _refuse_folded(model) -> None:
    """The pipelines split the unfolded networks' forwards; a W-folded
    model (models/folded.py) has another forward."""
    if getattr(model, "folded", False):
        raise ValueError("the pipelines take the unfolded network: engine.model(family, folded=False)")


def srnet_pipeline_apply(model, x: torch.Tensor, mesh: Mesh, n_micro: int = 4) -> torch.Tensor:
    """SRNet forward with the residual-block chain pipelined over ``pipe``.

    x: [N, H, W, 3] in [0, 1] on the mesh's first slot; N must divide by
    n_micro and the block count by the pipe size. The same operations in
    the same order as ``SRNet.forward``; only their placement differs."""
    _refuse_folded(model)
    c = model.config
    slots = mesh.slots(AXIS_PIPE)
    pipe = len(slots)
    blocks = list(model.blocks)
    if len(blocks) % pipe != 0:
        raise ValueError(f"{len(blocks)} blocks not divisible by pipe={pipe}")
    if x.shape[0] % n_micro != 0:
        raise ValueError(f"batch {x.shape[0]} not divisible by n_micro={n_micro}")
    per_stage = len(blocks) // pipe
    stages = [replicate(nn.Sequential(*blocks[p * per_stage : (p + 1) * per_stage]), slots[p]) for p in range(pipe)]

    h0 = model.stem(x)  # the stem, outside the pipe
    feat = gather(_gpipe(stages, slots, list(h0.chunk(n_micro, dim=0))), x.device)
    feat = model.pre_up(feat) + h0  # the head, outside the pipe
    out = L.pixel_shuffle(model.up(feat), c.scale) + L.upsample_nearest(x, c.scale)
    return residual_limit(x, out, c)


def _unet_segments(config):
    """The UNet forward as an ordered list of ``fn(model, carry) -> carry``,
    ``model`` the network's copy on the segment's slot.

    carry: {x, emb} at the start; then {base, emb, h, skips}; {out} after
    the head. The segment bodies are ``RestorationUNet.forward``'s calls in
    its order."""
    c = config
    groups = c.norm_groups

    def stem(m, carry):
        x = carry["x"]
        x_in = L.space_to_depth(x, c.input_scale) if c.input_scale > 1 else x
        base = x if x.shape[-1] == c.out_channels else x[..., : c.out_channels]
        return {"base": base, "emb": carry["emb"], "h": m.stem(x_in), "skips": ()}

    def enc_level(m, carry, level):
        lv = m.enc[level]
        h, emb = carry["h"], carry["emb"]
        for block in lv.blocks:
            h = block(h, emb, groups)
        skips = carry["skips"] + (h,)
        if hasattr(lv, "down"):
            h = lv.down(h, stride=2)
        return {**carry, "h": h, "skips": skips}

    def mid(m, carry):
        h, emb = carry["h"], carry["emb"]
        h = m.mid.block1(h, emb, groups)
        if h.shape[1] * h.shape[2] <= c.max_attn_tokens:
            h = m.mid.attn(h, c.attn_heads)
        return {**carry, "h": m.mid.block2(h, emb, groups)}

    def dec_level(m, carry, level):
        lv = m.dec[level]
        h, emb, skips = carry["h"], carry["emb"], carry["skips"]
        skip, skips = skips[-1], skips[:-1]
        if h.shape[1] != skip.shape[1]:
            h = L.upsample_nearest(h, skip.shape[1] // h.shape[1])
        for j, block in enumerate(lv.blocks):
            h = block(h, emb, groups, cat=skip if j == 0 else None)
        if hasattr(lv, "up"):
            h = lv.up(h)
        return {**carry, "h": h, "skips": skips}

    def head(m, carry):
        residual = m.head(m.head_norm.silu(carry["h"], groups))
        if c.input_scale > 1:
            residual = L.pixel_shuffle(residual, c.input_scale)
        if c.residual_shrink > 0.0:
            r = residual.float()
            residual = torch.sign(r) * torch.clamp(r.abs() - c.residual_shrink, min=0.0)
        return {"out": carry["base"] + residual.to(carry["base"].dtype)}

    levels = range(len(c.channel_mults))
    return (
        [stem]
        + [lambda m, carry, level=level: enc_level(m, carry, level) for level in levels]
        + [mid]
        + [lambda m, carry, level=level: dec_level(m, carry, level) for level in levels]
        + [head]
    )


def unet_pipeline_apply(
    model, x: torch.Tensor, cond: torch.Tensor, mesh: Mesh, n_micro: int = 4, t: torch.Tensor | None = None
) -> torch.Tensor:
    """UNet forward pipelined over ``pipe`` (each stage slot runs its
    contiguous group of segments) and, with a data axis, each microbatch
    split over the data rows. x [N, H, W, in_channels] in [0, 1] and cond
    [N, cond_dim] on the mesh's first slot; N must divide by n_micro and the
    microbatch by the data size. Same operations in the same order as
    ``RestorationUNet.forward``."""
    _refuse_folded(model)
    c = model.config
    dp, pipe = mesh.shape[AXIS_DATA], mesh.shape[AXIS_PIPE]
    n = x.shape[0]
    if n % n_micro != 0:
        raise ValueError(f"batch {n} not divisible by n_micro={n_micro}")
    if (n // n_micro) % dp != 0:
        raise ValueError(f"microbatch {n // n_micro} not divisible by data={dp}")

    # the FiLM embedding, once, on the first slot
    emb_in = cond.to(x.dtype)
    if c.time_conditioned:
        if t is None:
            t = torch.zeros((n,), dtype=torch.float32, device=x.device)
        emb_in = torch.cat([emb_in, L.sinusoidal_embedding(t, c.emb_dim).to(x.dtype)], dim=-1)
    emb = model.cond_mlp2(L.silu(model.cond_mlp1(emb_in)))

    segments = _unet_segments(c)
    if pipe > len(segments):
        raise ValueError(f"pipe={pipe} exceeds {len(segments)} UNet segments")
    groups = [list(g) for g in np.array_split(np.arange(len(segments)), pipe)]

    micro = [(xm.chunk(dp, dim=0), em.chunk(dp, dim=0)) for xm, em in zip(x.chunk(n_micro), emb.chunk(n_micro))]
    rows = []
    for i in range(dp):
        slots = list(mesh.devices[i, 0, 0, :])
        models = [replicate(model, d) for d in slots]
        stage_fns = []
        for p in range(pipe):
            def stage(carry, m=models[p], seg_ids=groups[p]):
                for s in seg_ids:
                    carry = segments[s](m, carry)
                return carry

            stage_fns.append(stage)
        outs = _gpipe(stage_fns, slots, [{"x": xs[i], "emb": es[i]} for xs, es in micro])
        rows.append([o["out"] for o in outs])
    # microbatch by microbatch, each joined over the data rows
    return gather([gather([rows[i][m] for i in range(dp)], x.device) for m in range(n_micro)], x.device)
