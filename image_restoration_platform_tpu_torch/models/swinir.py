"""SwinIR — the Swin-transformer super-resolution network (Liang et al.,
"SwinIR: Image Restoration Using Swin Transformer", arXiv:2108.10257), in
its classical-SR form with the pixel-shuffle upsampler.

The JAX package has no counterpart. The forward follows the published one:
reflect-pad to a multiple of the window, the RGB mean shift, ``conv_first``,
the patch embedding's LayerNorm, residual Swin transformer blocks (RSTBs),
each of Swin layers that alternate plain and shifted 8 x 8 window attention
and end in a 3 x 3 conv on the block's residual path, the final LayerNorm,
``conv_after_body`` and the long skip, then ``conv_before_upsample`` with
LeakyReLU, conv + pixel shuffle stages, ``conv_last``, the mean added back
and the padding cropped. The pixel shuffle is PyTorch's (channel-major,
``(c, ph, pw)``), as published, not the layer library's (``(ph, pw, c)``).

Activations are NHWC at every layer, so a Swin layer's tokens are the
``[B, H, W, C]`` grid itself. The linears (``F.linear``, the bias in the
product's epilogue), LayerNorm (f32 statistics inside PyTorch's kernel),
GELU, roll and the convs are plain PyTorch; the window
attention is ``ops/cuda/window_attention.py`` (the hand-written kernel on a
card). Parameter names are the npz layout of the benchmark's reference
(``benchmark/reference/swinir.py``): ``layers/<i>/blocks/<j>/attn/qkv`` and
so on, convs HWIO in the file, dense kernels ``[in, out]``, the bias table
``[(2w - 1)^2, heads]``, so the family loads through ``models/weights.py``
with ``strict=True``. LayerNorm's parameters are cast with the compute type
(``compute_params``); the bias table stays f32, as the kernel reads it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.window_attention import window_attention
from . import nn as L

# the linears' and bias tables' draw: a normal of std LINEAR_INIT_STD
# (SwinIR's _init_weights); the convs take PyTorch's default, uniform with
# bound 1 / sqrt(fan_in); as benchmark/reference/swinir.py:init draws them
LINEAR_INIT_STD = 0.02


@dataclass(frozen=True)
class SwinIRConfig:
    """SwinIR-M, classical SR (the ``classical_sr`` settings of the published
    ``main_test_swinir.py``): 6 RSTBs of 6 Swin layers at width 180 with 6
    heads, windows of 8, MLP ratio 2, one conv a residual connection."""

    scale: int = 2
    in_channels: int = 3
    embed_dim: int = 180
    depths: tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    num_heads: tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    window_size: int = 8
    mlp_ratio: float = 2.0
    img_range: float = 1.0
    rgb_mean: tuple[float, float, float] = (0.4488, 0.4371, 0.4040)
    patch_norm: bool = True
    num_feat: int = 64  # the upsampler's width

    def shuffle_stages(self) -> list[int]:
        """The upsampler's pixel-shuffle factors, as published: one x3, or
        log2(scale) stages of x2."""
        return [3] if self.scale == 3 else [2] * int(math.log2(self.scale))


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale.to(x.dtype), self.bias.to(x.dtype), self.eps)

    def compute_params(self):
        return (self.scale, self.bias)


def _dense_init(layer: L.Dense, gen: torch.Generator) -> None:
    with torch.no_grad():
        layer.w.copy_(torch.randn(layer.w.shape, generator=gen) * LINEAR_INIT_STD)
        layer.b.zero_()


def _conv_init(layer: L.Conv, gen: torch.Generator) -> None:
    co, ci, kh, kw = layer.w.shape
    bound = 1.0 / math.sqrt(ci * kh * kw)
    with torch.no_grad():
        layer.w.copy_((torch.rand(layer.w.shape, generator=gen) * 2.0 - 1.0) * bound)
        layer.b.copy_((torch.rand(layer.b.shape, generator=gen) * 2.0 - 1.0) * bound)


def linear(layer: L.Dense, x: torch.Tensor) -> torch.Tensor:
    """x @ w + b of a ``Dense`` layer, the bias added in the product's
    epilogue: one pass over the output instead of a second, broadcast add."""
    return F.linear(x, layer.w.t(), layer.b)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, window^2, C], windows batch-major and
    row-major over the grid, tokens row-major in a window."""
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window * window, c)


def window_reverse(windows: torch.Tensor, window: int, b: int, h: int, w: int) -> torch.Tensor:
    """Inverse of ``window_partition``."""
    c = windows.shape[-1]
    x = windows.view(b, h // window, w // window, window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.qkv = L.Dense(dim, 3 * dim)
        self.proj = L.Dense(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = L.Dense(dim, hidden)
        self.fc2 = L.Dense(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.fc2, F.gelu(linear(self.fc1, x)))


class SwinLayer(nn.Module):
    """Pre-LayerNorm window attention (shifted by ``shift`` before it and
    back after it) and MLP, each on a residual."""

    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        s, ws = self.shift, self.window
        y = self.norm1(x)
        if s:
            y = torch.roll(y, shifts=(-s, -s), dims=(1, 2))
        qkv = linear(self.attn.qkv, window_partition(y, ws))
        o = window_attention(qkv, self.attn.relative_position_bias_table, self.attn.heads, s, (h // ws, w // ws))
        y = window_reverse(linear(self.attn.proj, o), ws, b, h, w)
        if s:
            y = torch.roll(y, shifts=(s, s), dims=(1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x))

    def init_(self, gen: torch.Generator) -> None:
        for layer in (self.attn.qkv, self.attn.proj, self.mlp.fc1, self.mlp.fc2):
            _dense_init(layer, gen)
        with torch.no_grad():
            self.attn.relative_position_bias_table.copy_(
                torch.randn(self.attn.relative_position_bias_table.shape, generator=gen) * LINEAR_INIT_STD)


class RSTB(nn.Module):
    """Residual Swin transformer block: Swin layers, then a 3 x 3 conv, on
    the block's residual."""

    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinLayer(dim, heads, window, 0 if i % 2 == 0 else window // 2, mlp_ratio) for i in range(depth))
        self.conv = L.Conv(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for block in self.blocks:
            y = block(y)
        return self.conv(y) + x


class SwinIR(nn.Module):
    def __init__(self, config: SwinIRConfig = SwinIRConfig()):
        super().__init__()
        c = self.config = config
        d = c.embed_dim
        self.conv_first = L.Conv(c.in_channels, d)
        self.patch_norm = LayerNorm(d) if c.patch_norm else None
        self.layers = nn.ModuleList(RSTB(d, depth, heads, c.window_size, c.mlp_ratio)
                                    for depth, heads in zip(c.depths, c.num_heads))
        self.norm = LayerNorm(d)
        self.conv_after_body = L.Conv(d, d)
        self.conv_before_upsample = L.Conv(d, c.num_feat)
        self.upsample = nn.ModuleList(L.Conv(c.num_feat, r * r * c.num_feat) for r in c.shuffle_stages())
        self.conv_last = L.Conv(c.num_feat, c.in_channels)
        self.register_buffer("mean", torch.tensor(c.rgb_mean, dtype=torch.float32), persistent=False)

    def init_(self, gen: torch.Generator) -> "SwinIR":
        """Random weights from ``gen``, drawn as the benchmark's reference
        draws them (LayerNorms stay 1 and 0)."""
        for m in self.modules():
            if isinstance(m, L.Conv):
                _conv_init(m, gen)
            elif isinstance(m, SwinLayer):
                m.init_(gen)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N,H,W,3] in [0,1] -> [N,H*scale,W*scale,3] f32."""
        c = self.config
        n, h, w, _ = x.shape
        ws = c.window_size
        ph, pw = (-h) % ws, (-w) % ws
        if ph or pw:
            x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="reflect").permute(0, 2, 3, 1)
        x = ((x.float() - self.mean) * c.img_range).to(x.dtype)
        feat = self.conv_first(x)
        y = self.patch_norm(feat) if self.patch_norm is not None else feat
        for layer in self.layers:
            y = layer(y)
        feat = self.conv_after_body(self.norm(y)) + feat
        y = F.leaky_relu(self.conv_before_upsample(feat), 0.01)
        for r, conv in zip(c.shuffle_stages(), self.upsample):
            y = F.pixel_shuffle(conv(y).permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)
        out = self.conv_last(y).float() / c.img_range + self.mean
        return out[:, : h * c.scale, : w * c.scale]
