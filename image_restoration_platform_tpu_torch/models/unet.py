"""RestorationUNet — the flagship conditioned restoration backbone.

Counterpart of image_restoration_platform_tpu/models/unet.py (``apply``):
encoder with stride-2 conv downsampling, bottleneck self-attention, decoder
with nearest upsampling whose first block per level consumes the encoder
skip as a virtual concat, FiLM conditioning from the 28-dim degradation
vector, a space-to-depth stem (``input_scale``) and a soft-shrunk global
residual. Module and parameter names follow the JAX parameter tree, so a
state dict from ``weights.params_from_jax`` loads with ``strict=True``.

With ``time_conditioned`` (the diffusion family's epsilon/x0 predictor) the
conditioning MLP also takes the sinusoidal embedding of the timestep:
``cond_mlp1`` has ``cond_dim + emb_dim`` inputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from . import nn as L


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 3
    out_channels: int = 3
    base_channels: int = 64
    channel_mults: tuple[int, ...] = (1, 2, 4)
    blocks_per_level: int = 2
    cond_dim: int = 28
    emb_dim: int = 256
    attn_heads: int = 4
    norm_groups: int = 32
    time_conditioned: bool = False
    # bottleneck attention is skipped above this many tokens (the 1024 bucket)
    max_attn_tokens: int = 4096
    # space-to-depth stem factor
    input_scale: int = 1
    # soft-threshold on the global residual: sign(r) * max(|r| - s, 0)
    residual_shrink: float = 0.0


def embedding(model: nn.Module, x: torch.Tensor, cond: torch.Tensor, t: torch.Tensor | None) -> torch.Tensor:
    """The conditioning embedding [N, emb_dim] of ``model`` (a UNet with
    ``cond_mlp1`` and ``cond_mlp2``) in x's type: the MLP of cond, and of
    the timestep's sinusoidal embedding for a time-conditioned config (t
    None means zeros)."""
    c = model.config
    emb_in = cond.to(x.dtype)
    if c.time_conditioned:
        if t is None:
            t = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
        # the embedding is f32 and meets the compute type only here
        emb_in = torch.cat([emb_in, L.sinusoidal_embedding(t, c.emb_dim).to(x.dtype)], dim=-1)
    return model.cond_mlp2(L.silu(model.cond_mlp1(emb_in)))


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, emb_dim: int):
        super().__init__()
        self.norm1 = L.GroupNorm(in_ch)
        self.conv1 = L.Conv(in_ch, out_ch)
        self.film = L.Film(emb_dim, 2 * out_ch)
        self.norm2 = L.GroupNorm(out_ch)
        self.conv2 = L.Conv(out_ch, out_ch)
        self.skip = L.Conv(in_ch, out_ch, kernel=1) if in_ch != out_ch else None

    def forward(self, x, emb, groups: int, cat=None):
        """``cat``: a second input concatenated to x on channels, consumed
        through the split GroupNorm and split-weight convs."""
        if cat is None:
            parts = [self.norm1.silu(x, groups)]
        else:
            parts = self.norm1.cat([x, cat], groups, silu=True)
        # conv1's bias and the FiLM ride in the norm2 moments' prologue
        h = self.conv1.cat(parts, bias=False)
        h = self.norm2.film_silu(h, self.conv1.full_bias(), self.film.gamma_beta(emb, h.dtype), groups)
        h = self.conv2(h)
        if self.skip is None:
            skip = x
        elif cat is None:
            skip = self.skip(x)
        else:
            skip = self.skip.cat([x, cat])
        return skip + h

    def init_(self, gen: torch.Generator) -> None:
        self.conv1.init_(gen)
        self.film.init_(gen)
        self.conv2.init_(gen, scale=0.1)
        if self.skip is not None:
            self.skip.init_(gen)


class Level(nn.Module):
    def __init__(self, blocks: list[ResBlock], down: bool = False, up: bool = False, ch: int = 0):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        if down:
            self.down = L.Conv(ch, ch)
        if up:
            self.up = L.Conv(ch, ch)


class Mid(nn.Module):
    def __init__(self, ch: int, emb_dim: int):
        super().__init__()
        self.block1 = ResBlock(ch, ch, emb_dim)
        self.attn = L.Attention(ch)
        self.block2 = ResBlock(ch, ch, emb_dim)


class RestorationUNet(nn.Module):
    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        c = self.config = config
        ch = [c.base_channels * m for m in c.channel_mults]
        s2 = c.input_scale * c.input_scale
        self.cond_mlp1 = L.Dense(c.cond_dim + (c.emb_dim if c.time_conditioned else 0), c.emb_dim)
        self.cond_mlp2 = L.Dense(c.emb_dim, c.emb_dim)
        self.stem = L.Conv(c.in_channels * s2, ch[0])

        enc, in_ch = [], ch[0]
        for level, out_ch in enumerate(ch):
            blocks = []
            for _ in range(c.blocks_per_level):
                blocks.append(ResBlock(in_ch, out_ch, c.emb_dim))
                in_ch = out_ch
            enc.append(Level(blocks, down=level < len(ch) - 1, ch=out_ch))
        self.enc = nn.ModuleList(enc)
        self.mid = Mid(in_ch, c.emb_dim)

        dec = []
        for level in reversed(range(len(ch))):
            out_ch = ch[level]
            blocks = [
                ResBlock(in_ch + out_ch if j == 0 else out_ch, out_ch, c.emb_dim)
                for j in range(c.blocks_per_level)
            ]
            in_ch = out_ch
            dec.append(Level(blocks, up=level > 0, ch=out_ch))
        self.dec = nn.ModuleList(dec)

        self.head_norm = L.GroupNorm(ch[0])
        self.head = L.Conv(ch[0], c.out_channels * s2)

    def init_(self, gen: torch.Generator) -> "RestorationUNet":
        """Random weights from ``gen`` with the JAX package's scales (zero
        FiLM and head, so the untrained model is the identity)."""
        self.cond_mlp1.init_(gen)
        self.cond_mlp2.init_(gen)
        self.stem.init_(gen)
        for level in list(self.enc) + list(self.dec):
            for block in level.blocks:
                block.init_(gen)
            for name in ("down", "up"):
                if hasattr(level, name):
                    getattr(level, name).init_(gen)
        self.mid.block1.init_(gen)
        self.mid.attn.init_(gen)
        self.mid.block2.init_(gen)
        with torch.no_grad():
            self.head.w.zero_()
            self.head.b.zero_()
        return self

    def forward(
        self, x: torch.Tensor, cond: torch.Tensor, t: torch.Tensor | None = None, s2d_io: bool = False
    ) -> torch.Tensor:
        """x [N,H,W,in_channels] in [0,1] (or [N,H/s,W/s,3*s^2] with
        ``s2d_io``), cond [N,cond_dim], t [N] timesteps (time-conditioned
        models only; None means zeros) -> restored, in x's layout and type."""
        c = self.config
        dtype = x.dtype
        emb = embedding(self, x, cond, t)

        if s2d_io:
            if c.input_scale <= 1 or c.in_channels != c.out_channels:
                raise ValueError("s2d_io requires input_scale > 1 and in == out channels")
            x_in = x
        else:
            x_in = L.space_to_depth(x, c.input_scale) if c.input_scale > 1 else x
        h = self.stem(x_in)

        skips = []
        for level in self.enc:
            for block in level.blocks:
                h = block(h, emb, c.norm_groups)
            skips.append(h)
            if hasattr(level, "down"):
                h = level.down(h, stride=2)

        h = self.mid.block1(h, emb, c.norm_groups)
        if h.shape[1] * h.shape[2] <= c.max_attn_tokens:
            h = self.mid.attn(h, c.attn_heads)
        h = self.mid.block2(h, emb, c.norm_groups)

        for i, level in enumerate(self.dec):
            skip = skips[len(skips) - 1 - i]
            if h.shape[1] != skip.shape[1]:
                h = L.upsample_nearest(h, skip.shape[1] // h.shape[1])
            for j, block in enumerate(level.blocks):
                h = block(h, emb, c.norm_groups, cat=skip if j == 0 else None)
            if hasattr(level, "up"):
                h = level.up(h)

        h = self.head_norm.silu(h, c.norm_groups)
        residual = self.head(h)
        if c.input_scale > 1 and not s2d_io:
            residual = L.pixel_shuffle(residual, c.input_scale)
        if s2d_io or x.shape[-1] == c.out_channels:
            base = x
        else:
            base = x[..., : c.out_channels]
        if c.residual_shrink > 0.0:
            r = residual.float()
            residual = torch.sign(r) * torch.clamp(r.abs() - c.residual_shrink, min=0.0)
        return base + residual.to(dtype)
