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
``[B, H, W, C]`` grid itself. The attention's qkv and proj linears
(``F.linear``, the bias in the product's epilogue), the convs and the patch
embedding's and the final LayerNorm (f32 statistics inside PyTorch's kernel)
are plain PyTorch; the window attention is ``ops/cuda/window_attention.py``,
each Swin layer's residual adds, its two LayerNorms, the roll and the window
partition and reverse are ``ops/cuda/swin_add_norm.py``, and its MLP (fc1,
GELU, fc2) is ``ops/cuda/swin_mlp.py`` (hand-written kernels on a card). Parameter names are the npz layout of the benchmark's reference
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

from ..ops.cuda.swin_add_norm import add_norm_from_windows, add_norm_to_windows
from ..ops.cuda.swin_add_norm import check_shapes as check_add_norm_shapes
from ..ops.cuda.swin_mlp import PackedWeights, swin_mlp
from ..ops.cuda.swin_mlp import check_shapes as check_mlp_shapes
from ..ops.cuda.window_attention import check_shapes as check_window_shapes
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


def check_kernel_shapes(name: str, cfg: SwinIRConfig) -> None:
    """Raise, naming the family ``name``, unless the add-norm kernel takes its
    windows and width (``ops/cuda/swin_add_norm.py:check_shapes``), the
    window attention kernel its windows, heads and head dim
    (``ops/cuda/window_attention.py:check_shapes``) and the MLP kernel its
    width and hidden width (``ops/cuda/swin_mlp.py:check_shapes``)."""
    hidden = int(cfg.embed_dim * cfg.mlp_ratio)
    try:
        check_add_norm_shapes(cfg.window_size, cfg.embed_dim)
        for heads in cfg.num_heads:
            check_window_shapes(cfg.window_size, heads, cfg.embed_dim)
        check_mlp_shapes(cfg.embed_dim, hidden)
    except ValueError as error:
        raise ValueError(f"model family {name!r} gives its kernels windows of {cfg.window_size} with "
                         f"{cfg.embed_dim} channels over {cfg.num_heads} heads and an MLP of {hidden}, which they "
                         f"do not take: {error}") from error


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def affine(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        return self.scale.to(dtype), self.bias.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), *self.affine(x.dtype), self.eps)

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
        self.packed = PackedWeights()  # the kernel's layout of the four tensors, on a card

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """fc2(GELU(fc1(x))), the erf GELU, x [..., C] -> [..., C]."""
        return swin_mlp(x, self.fc1.w, self.fc1.b, self.fc2.w, self.fc2.b, self.packed)


class SwinLayer(nn.Module):
    """Pre-LayerNorm window attention (shifted by ``shift`` before it and
    back after it) and MLP, each on a residual. The layer's input is
    ``x + a`` and its output ``x' + m``: the MLP's residual add is left to
    the next layer's first add-norm kernel, which reads both terms anyway."""

    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, a: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """(x, a) [B, H, W, C] (``a`` None: the input is ``x``) -> (x', m),
        the output's two terms."""
        _, h, w, _ = x.shape
        s, ws = self.shift, self.window
        x, y = add_norm_to_windows(x, a, *self.norm1.affine(x.dtype), self.norm1.eps, s, ws)
        o = window_attention(linear(self.attn.qkv, y), self.attn.relative_position_bias_table, self.attn.heads, s,
                             (h // ws, w // ws))
        x, y = add_norm_from_windows(x, linear(self.attn.proj, o), *self.norm2.affine(x.dtype), self.norm2.eps, s, ws)
        return x, self.mlp(y)

    def init_(self, gen: torch.Generator) -> None:
        for layer in (self.attn.qkv, self.attn.proj, self.mlp.fc1, self.mlp.fc2):
            _dense_init(layer, gen)
        with torch.no_grad():
            self.attn.relative_position_bias_table.copy_(
                torch.randn(self.attn.relative_position_bias_table.shape, generator=gen) * LINEAR_INIT_STD)


class RSTB(nn.Module):
    """Residual Swin transformer block: Swin layers, then a 3 x 3 conv, on
    the block's residual. Its first layer takes no operand, and the last
    layer's two terms are summed in PyTorch before the conv, as is the
    conv's output with the block's input: the conv reads its input whole."""

    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinLayer(dim, heads, window, 0 if i % 2 == 0 else window // 2, mlp_ratio) for i in range(depth))
        self.conv = L.Conv(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, m = x, None
        for block in self.blocks:
            y, m = block(y, m)
        return self.conv(y + m) + x


class SwinIR(nn.Module):
    """The network around its residual groups (``groups``, RSTBs here): the
    shallow conv, the patch LayerNorm, the final LayerNorm and skip, and the
    pixel-shuffle upsampler; models/hat.py reuses it with HAT's groups."""

    # the modules whose own ``init_`` draws their linears and bias tables
    blocks: tuple[type, ...] = (SwinLayer,)

    def __init__(self, config: SwinIRConfig = SwinIRConfig()):
        super().__init__()
        c = self.config = config
        d = c.embed_dim
        self.conv_first = L.Conv(c.in_channels, d)
        self.patch_norm = LayerNorm(d) if c.patch_norm else None
        self.layers = self.groups(c)
        self.norm = LayerNorm(d)
        self.conv_after_body = L.Conv(d, d)
        self.conv_before_upsample = L.Conv(d, c.num_feat)
        self.upsample = nn.ModuleList(L.Conv(c.num_feat, r * r * c.num_feat) for r in c.shuffle_stages())
        self.conv_last = L.Conv(c.num_feat, c.in_channels)
        self.register_buffer("mean", torch.tensor(c.rgb_mean, dtype=torch.float32), persistent=False)

    def groups(self, c: SwinIRConfig) -> nn.ModuleList:
        return nn.ModuleList(RSTB(c.embed_dim, depth, heads, c.window_size, c.mlp_ratio)
                             for depth, heads in zip(c.depths, c.num_heads))

    def init_(self, gen: torch.Generator) -> "SwinIR":
        """Random weights from ``gen``, drawn as the benchmark's reference
        draws them (LayerNorms stay 1 and 0)."""
        for m in self.modules():
            if isinstance(m, L.Conv):
                _conv_init(m, gen)
            elif isinstance(m, self.blocks):
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
