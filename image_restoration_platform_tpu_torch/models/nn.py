"""Layer library of the port: functions on NHWC tensors and the modules that
hold their parameters.

Counterpart of image_restoration_platform_tpu/models/nn.py, with the same
numerics:

- activations are NHWC at every public function. Convolutions view them as
  NCHW through ``permute`` (no copy), so on the card the network runs in
  PyTorch's channels_last layout;
- parameters are cast to the activation type at the call (a no-op once the
  engine has cast them), except GroupNorm's scale and bias, which stay f32;
- ``dense``, ``film`` and bias adds run in the activation type;
- GroupNorm is the one-pass E[x^2] - mu^2 in f32 with ``gn_groups`` groups,
  folded into one per-(n, c) affine; the per-channel sums and the affine
  (with the SiLU that follows it, and the conv bias and FiLM before it in a
  ResBlock) are the fused kernels of ops/cuda/group_norm.py on a card;
- ``SAME`` padding is computed per axis like XLA's: a stride-2 3x3 conv on an
  even size pads (0, 1), not (1, 1);
- ``pixel_shuffle`` / ``space_to_depth`` use the (ph, pw, c) channel order,
  channel-minor, which is not ``F.pixel_shuffle``'s (c, ph, pw).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.attention import flash_attention
from ..ops.cuda.group_norm import film_modulate, gn_affine_silu, gn_film_moments, gn_moments

# ---------------------------------------------------------------- functions


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w [in, out] + b, in x's type."""
    return torch.matmul(x, w.to(x.dtype)) + b.to(x.dtype)


def _same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv_nchw(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """SAME conv of an NHWC tensor without bias; returns NHWC."""
    xc = x.permute(0, 3, 1, 2)
    ph = _same_pads(xc.shape[2], w.shape[2], stride)
    pw = _same_pads(xc.shape[3], w.shape[3], stride)
    w = w.to(x.dtype)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        out = F.conv2d(xc, w, None, stride, (ph[0], pw[0]))
    else:
        out = F.conv2d(F.pad(xc, (pw[0], pw[1], ph[0], ph[1])), w, None, stride, 0)
    return out.permute(0, 2, 3, 1)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME conv: x NHWC, w OIHW [co, ci, kh, kw], b [co] -> NHWC."""
    return _conv_nchw(x, w, stride) + b.to(x.dtype)


def conv2d_cat(parts: list[torch.Tensor], w: torch.Tensor, b: torch.Tensor | None, stride: int = 1) -> torch.Tensor:
    """conv2d over the channel concat of ``parts`` without forming it:
    conv(cat(a, b), W) == conv(a, W[:, :ca]) + conv(b, W[:, ca:]); ``b``
    None leaves the bias add to the caller."""
    out = None
    offset = 0
    for p in parts:
        pc = p.shape[-1]
        piece = _conv_nchw(p, w[:, offset : offset + pc], stride)
        out = piece if out is None else out + piece
        offset += pc
    return out if b is None else out + b.to(parts[0].dtype)


def gn_groups(c: int, groups: int) -> int:
    g = min(groups, c)
    while c % g != 0:
        g -= 1
    return g


def _group_moments(s1: torch.Tensor, s2: torch.Tensor, g: int, cnt: int, eps: float):
    n, c = s1.shape
    per = c // g
    mean_g = s1.reshape(n, g, per).sum(-1) / cnt
    ex2_g = s2.reshape(n, g, per).sum(-1) / cnt
    var_g = torch.clamp(ex2_g - mean_g * mean_g, min=0.0)
    mean_c = mean_g.repeat_interleave(per, dim=-1)
    inv_c = torch.rsqrt(var_g + eps).repeat_interleave(per, dim=-1)
    return mean_c, inv_c


def group_norm_stats(x: torch.Tensor, groups: int, eps: float = 1e-5):
    """NHWC -> (mean_c, inv_c), both [N, C] f32 (one-pass moments)."""
    n, h, w, c = x.shape
    g = gn_groups(c, groups)
    s1, s2 = gn_moments(x)
    return _group_moments(s1, s2, g, h * w * (c // g), eps)


def _folded_affine(scale: torch.Tensor, bias: torch.Tensor, mean_c: torch.Tensor, inv_c: torch.Tensor):
    """(x - mean) * inv * scale + bias as one [N, C] f32 affine."""
    s = scale.float()[None, :] * inv_c
    return s, bias.float()[None, :] - mean_c * s


def group_norm_silu(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int = 32, eps: float = 1e-5,
    silu: bool = True,
) -> torch.Tensor:
    """silu(GroupNorm(x)) (``silu=False``: the GroupNorm alone), in x's type."""
    s, bb = _folded_affine(scale, bias, *group_norm_stats(x, groups, eps))
    return gn_affine_silu(x, s, bb, silu)


def group_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int = 32, eps: float = 1e-5
) -> torch.Tensor:
    return group_norm_silu(x, scale, bias, groups, eps, silu=False)


def group_norm_cat(
    parts: list[torch.Tensor], scale: torch.Tensor, bias: torch.Tensor, groups: int = 32,
    eps: float = 1e-5, silu: bool = False,
) -> list[torch.Tensor]:
    """GroupNorm over the channel concat of ``parts``, returned still split
    (each part through SiLU with ``silu``)."""
    c = sum(p.shape[-1] for p in parts)
    g = gn_groups(c, groups)
    h, w = parts[0].shape[1], parts[0].shape[2]
    sums = [gn_moments(p) for p in parts]
    s1 = torch.cat([s for s, _ in sums], dim=-1)
    s2 = torch.cat([s for _, s in sums], dim=-1)
    s, bb = _folded_affine(scale, bias, *_group_moments(s1, s2, g, h * w * (c // g), eps))
    out, offset = [], 0
    for p in parts:
        pc = p.shape[-1]
        out.append(gn_affine_silu(p, s[:, offset : offset + pc], bb[:, offset : offset + pc], silu))
        offset += pc
    return out


def film_group_norm_silu(
    raw: torch.Tensor, conv_bias: torch.Tensor, gamma_beta: torch.Tensor, scale: torch.Tensor,
    bias: torch.Tensor, groups: int = 32, eps: float = 1e-5,
) -> torch.Tensor:
    """silu(GroupNorm(film_modulate(raw + conv_bias, gamma_beta))): the
    ResBlock's conv1 bias, FiLM, norm2 and SiLU from the bias-free conv
    output ``raw``, with the FiLM vectors [N, 2C] of ``Film.gamma_beta``."""
    n, h, w, c = raw.shape
    g = gn_groups(c, groups)
    y, s1, s2 = gn_film_moments(raw, conv_bias, gamma_beta)
    s, bb = _folded_affine(scale, bias, *_group_moments(s1, s2, g, h * w * (c // g), eps))
    return gn_affine_silu(y, s, bb)


def film(x: torch.Tensor, cond: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x * (1 + gamma) + beta with (gamma, beta) = dense(cond), in x's type."""
    return film_modulate(x, dense(cond.to(x.dtype), w, b))


def sinusoidal_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Transformer sinusoidal embedding of scalar timesteps [N] -> [N, dim]
    f32: cosines of t * freqs, then sines."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Depth-to-space [N,H,W,C*r^2] -> [N,H*r,W*r,C], (ph, pw, c) order."""
    n, h, w, c = x.shape
    r = factor
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


def space_to_depth(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Inverse of pixel_shuffle: [N,H,W,C] -> [N,H/r,W/r,C*r^2]."""
    n, h, w, c = x.shape
    s = factor
    x = x.reshape(n, h // s, s, w // s, s, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // s, w // s, s * s * c)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, factor, w, factor, c)
    return x.reshape(n, h * factor, w * factor, c)


# ----------------------------------------------------------------- modules


class Dense(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.b = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.w, self.b)

    def init_(self, gen: torch.Generator, scale: float = 1.0) -> None:
        std = scale * math.sqrt(2.0 / self.w.shape[0])
        with torch.no_grad():
            self.w.copy_(torch.randn(self.w.shape, generator=gen) * std)
            self.b.zero_()


class Film(Dense):
    """FiLM from cond [N, D]: zero-initialised, so it starts as identity."""

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        return film(x, cond, self.w, self.b)

    def gamma_beta(self, cond: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The FiLM vectors [N, 2C] (gamma | beta) of ``cond`` in ``dtype``."""
        return dense(cond.to(dtype), self.w, self.b)

    def init_(self, gen: torch.Generator, scale: float = 1.0) -> None:
        with torch.no_grad():
            self.w.zero_()
            self.b.zero_()


class Conv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(out_ch, in_ch, kernel, kernel))
        self.b = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        return conv2d(x, self.w, self.b, stride)

    def cat(self, parts: list[torch.Tensor], stride: int = 1, bias: bool = True) -> torch.Tensor:
        """The conv of the parts' channel concat; ``bias=False`` leaves the
        bias add to the caller."""
        return conv2d_cat(parts, self.w, self.b if bias else None, stride)

    def full_bias(self) -> torch.Tensor:
        """The bias vector [co] (a column-parallel layer gathers its slices)."""
        return self.b

    def part(self, x: torch.Tensor, start: int) -> torch.Tensor:
        """The stride-1 SAME conv of ``x`` with the kernel's input channels
        from ``start`` on, without the bias: one part of ``cat``."""
        return _conv_nchw(x, self.w[:, start:], 1)

    def add_bias(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.b.to(x.dtype)

    def init_(self, gen: torch.Generator, scale: float = 1.0) -> None:
        co, ci, kh, kw = self.w.shape
        std = scale * math.sqrt(2.0 / (ci * kh * kw))
        with torch.no_grad():
            self.w.copy_(torch.randn(self.w.shape, generator=gen) * std)
            self.b.zero_()


class GroupNorm(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor, groups: int = 32) -> torch.Tensor:
        return group_norm(x, self.scale, self.bias, groups)

    def silu(self, x: torch.Tensor, groups: int = 32) -> torch.Tensor:
        """silu(self(x)), in one pass over x after its moments."""
        return group_norm_silu(x, self.scale, self.bias, groups)

    def cat(self, parts: list[torch.Tensor], groups: int = 32, silu: bool = False) -> list[torch.Tensor]:
        return group_norm_cat(parts, self.scale, self.bias, groups, silu=silu)

    def film_silu(self, raw: torch.Tensor, conv_bias: torch.Tensor, gamma_beta: torch.Tensor,
                  groups: int = 32) -> torch.Tensor:
        """silu(self(film_modulate(raw + conv_bias, gamma_beta))) from the
        bias-free conv output ``raw``: the FiLM prologue of the moments."""
        return film_group_norm_silu(raw, conv_bias, gamma_beta, self.scale, self.bias, groups)


def takes_attention_kernel(tokens: int, head_dim: int) -> bool:
    """Whether ``Attention`` routes [N, H, tokens, head_dim] to the flash
    attention kernel (the reference's routing); other shapes take the plain
    einsum form there and here."""
    return tokens % min(256, tokens) == 0 and head_dim % 8 == 0


class Attention(nn.Module):
    """Spatial self-attention over the H x W grid (the UNet bottleneck)."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = GroupNorm(ch)
        self.qkv = Dense(ch, 3 * ch)
        self.proj = Dense(ch, ch)

    def forward(self, x: torch.Tensor, heads: int) -> torch.Tensor:
        n, h, w, c = x.shape
        hd = c // heads
        t = h * w
        y = self.norm(x)
        q, k, v = self.qkv(y.reshape(n, t, c)).chunk(3, dim=-1)
        q, k, v = (a.reshape(n, t, heads, hd).permute(0, 2, 1, 3).contiguous() for a in (q, k, v))
        if takes_attention_kernel(t, hd):
            out = flash_attention(q, k, v)
        else:
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
            out = torch.matmul(probs, v)
        out = out.permute(0, 2, 1, 3).reshape(n, t, c)
        return x + self.proj(out).reshape(n, h, w, c)

    def init_(self, gen: torch.Generator) -> None:
        self.qkv.init_(gen)
        self.proj.init_(gen, scale=0.1)


def cast_for_compute(module: nn.Module, dtype: torch.dtype, channels_last: bool = False) -> nn.Module:
    """Cast conv and dense parameters to the compute type once (the JAX
    package casts them at every call); GroupNorm parameters stay f32.
    ``channels_last`` stores conv kernels in the layout cuDNN prefers for
    channels_last activations."""
    for m in module.modules():
        if isinstance(m, (Conv, Dense)):
            with torch.no_grad():
                m.w.data = m.w.data.to(dtype)
                m.b.data = m.b.data.to(dtype)
                if channels_last and isinstance(m, Conv):
                    m.w.data = m.w.data.contiguous(memory_format=torch.channels_last)
        for p in getattr(m, "compute_params", lambda: ())():
            p.data = p.data.to(dtype)  # other kernels a module applies in the compute type
    return module
