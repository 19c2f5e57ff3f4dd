"""HAT — the Hybrid Attention Transformer for super-resolution (Chen et al.,
"Activating More Pixels in Image Super-Resolution Transformer", CVPR 2023,
arXiv:2205.04437), in its classical-SR form with the pixel-shuffle
upsampler.

The JAX package has no counterpart. The network around the residual groups
is SwinIR's (models/swinir.py: reflect pad, mean shift, ``conv_first``, the
patch LayerNorm, the final LayerNorm and long skip, the upsampler), so
``HAT`` is ``SwinIR`` with HAT's groups. A residual hybrid attention group
(RHAG) is hybrid attention blocks (HABs), one overlapping cross-attention
block (OCAB) and a 3 x 3 conv on the group's residual:

- a HAB adds to its input both the (shifted) 16 x 16 window self-attention
  of its first LayerNorm's output and ``conv_scale`` times the
  channel-attention block of the same output (CAB: a 3 x 3 conv to
  ``embed_dim / compress_ratio`` channels, GELU, a 3 x 3 conv back, gated by
  a sigmoid of two 1 x 1 convs of the tile's mean), then an MLP on a second
  residual;
- an OCAB attends from each 16 x 16 window to the 24 x 24 window around it
  (``ops/cuda/overlap_attention.py``), then an MLP.

Both blocks keep SwinLayer's two-term residual: a block's input is
``x + a`` and its output ``x' + m``, the MLP's add left to the next block's
first add-norm kernel. A HAB's add-norm writes its LayerNorm twice from one
pass, in the rolled window layout for the qkv linear and in token order for
CAB's convs; CAB's gated output joins the residual by one ``torch.addcmul``
before the add-norm that adds the attention's output. The OCAB reads its
qkv in the window layout at shift 0, which the add-norm writes as SwinIR's
unshifted layers have it. CAB's convs, GELU, pooling and gate are plain
PyTorch. Parameter names are the npz layout of the benchmark's reference
(``benchmark/reference/hat.py``): ``layers/<i>/blocks/<j>/conv_block/conv1``,
``layers/<i>/overlap_attn/qkv`` and so on, so the family loads through
``models/weights.py`` with ``strict=True``; the bias tables stay f32, as the
kernels read them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.overlap_attention import check_shapes as check_overlap_shapes
from ..ops.cuda.overlap_attention import overlap_attention
from ..ops.cuda.swin_add_norm import add_norm_from_windows, add_norm_to_windows, add_norm_to_windows_and_tokens
from ..ops.cuda.window_attention import window_attention
from . import nn as L
from .swinir import LINEAR_INIT_STD, LayerNorm, Mlp, SwinIR, WindowAttention, _dense_init, linear
from .swinir import check_kernel_shapes as check_swin_kernel_shapes


@dataclass(frozen=True)
class HATConfig:
    """HAT, classical SR (the published ``HAT_SRx2.yml``): 6 RHAGs of 6 HABs
    and an OCAB at width 180 with 6 heads, windows of 16, CAB at a third of
    the width with a gate squeezed 30 times, an overlap ratio of 0.5, MLP
    ratio 2, one conv a residual connection."""

    scale: int = 2
    in_channels: int = 3
    embed_dim: int = 180
    depths: tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    num_heads: tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    window_size: int = 16
    compress_ratio: int = 3
    squeeze_factor: int = 30
    conv_scale: float = 0.01
    overlap_ratio: float = 0.5
    mlp_ratio: float = 2.0
    img_range: float = 1.0
    rgb_mean: tuple[float, float, float] = (0.4488, 0.4371, 0.4040)
    patch_norm: bool = True
    num_feat: int = 64  # the upsampler's width

    @property
    def overlap_window(self) -> int:
        """The OCAB's key window: ``window_size * (1 + overlap_ratio)``."""
        return int(self.overlap_ratio * self.window_size) + self.window_size

    def shuffle_stages(self) -> list[int]:
        """The upsampler's pixel-shuffle factors, as SwinIR's."""
        return [3] if self.scale == 3 else [2] * int(math.log2(self.scale))


def check_kernel_shapes(name: str, cfg: HATConfig) -> None:
    """Raise, naming the family ``name``, unless the HABs' kernels take their
    windows, heads and widths (``models.swinir.check_kernel_shapes``: the
    add-norm, the window attention, the MLP) and the overlap attention
    kernel its windows, heads and head dim
    (``ops/cuda/overlap_attention.py:check_shapes``)."""
    check_swin_kernel_shapes(name, cfg)
    try:
        for heads in cfg.num_heads:
            check_overlap_shapes(cfg.window_size, cfg.overlap_window, heads, cfg.embed_dim)
    except ValueError as error:
        raise ValueError(f"model family {name!r} gives the overlap attention kernel windows of {cfg.window_size} "
                         f"against {cfg.overlap_window} with {cfg.embed_dim} channels over {cfg.num_heads} heads, "
                         f"which it does not take: {error}") from error


def _table_init(table: nn.Parameter, gen: torch.Generator) -> None:
    with torch.no_grad():
        table.copy_(torch.randn(table.shape, generator=gen) * LINEAR_INIT_STD)


class CAB(nn.Module):
    """The channel-attention block: u = conv2(GELU(conv1(y))), gated per
    image and channel by sigmoid(ca_up(ReLU(ca_down(mean_HW(u)))))."""

    def __init__(self, dim: int, compress_ratio: int, squeeze_factor: int):
        super().__init__()
        self.conv1 = L.Conv(dim, dim // compress_ratio)
        self.conv2 = L.Conv(dim // compress_ratio, dim)
        self.ca_down = L.Conv(dim, dim // squeeze_factor, kernel=1)
        self.ca_up = L.Conv(dim // squeeze_factor, dim, kernel=1)

    def forward(self, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """y [B, H, W, C] -> (u [B, H, W, C], the gate [B, C] in f32); the
        mean is over the whole of each image (each tile on the tiled path),
        summed in f32, and the gate's 1 x 1 convs are f32 products."""
        u = self.conv2(F.gelu(self.conv1(y)))
        z = u.mean(dim=(1, 2), dtype=torch.float32)
        z = F.relu(F.linear(z, self.ca_down.w.flatten(1).float(), self.ca_down.b.float()))
        return u, torch.sigmoid(F.linear(z, self.ca_up.w.flatten(1).float(), self.ca_up.b.float()))


class HAB(nn.Module):
    """Hybrid attention block: x' = x + WA(roll(y)) + conv_scale * CAB(y)
    with y = LN1(x), then x'' = x' + MLP(LN2(x'))."""

    def __init__(self, dim: int, heads: int, window: int, shift: int, cfg: HATConfig):
        super().__init__()
        self.window, self.shift, self.conv_scale = window, shift, cfg.conv_scale
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.conv_block = CAB(dim, cfg.compress_ratio, cfg.squeeze_factor)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio))

    def forward(self, x: torch.Tensor, a: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """(x, a) [B, H, W, C] (``a`` None: the input is ``x``) -> (x', m),
        the output's two terms."""
        _, h, w, _ = x.shape
        s, ws = self.shift, self.window
        x, y, y_image = add_norm_to_windows_and_tokens(x, a, *self.norm1.affine(x.dtype), self.norm1.eps, s, ws)
        o = window_attention(linear(self.attn.qkv, y), self.attn.relative_position_bias_table, self.attn.heads, s,
                             (h // ws, w // ws))
        u, gate = self.conv_block(y_image)
        x = torch.addcmul(x, u, (self.conv_scale * gate).to(u.dtype)[:, None, None, :])
        x, y = add_norm_from_windows(x, linear(self.attn.proj, o), *self.norm2.affine(x.dtype), self.norm2.eps, s, ws)
        return x, self.mlp(y)

    def init_(self, gen: torch.Generator) -> None:
        for layer in (self.attn.qkv, self.attn.proj, self.mlp.fc1, self.mlp.fc2):
            _dense_init(layer, gen)
        _table_init(self.attn.relative_position_bias_table, gen)


class OCAB(nn.Module):
    """Overlapping cross-attention block: x' = x + proj(OCA(qkv(LN1(x)))),
    each 16 x 16 window's queries against the 24 x 24 window's keys and
    values around it, then x'' = x' + MLP(LN2(x'))."""

    def __init__(self, dim: int, heads: int, window: int, overlap: int, mlp_ratio: float):
        super().__init__()
        self.heads, self.window, self.overlap = heads, window, overlap
        self.norm1 = LayerNorm(dim)
        self.qkv = L.Dense(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((window + overlap - 1) ** 2, heads))
        self.proj = L.Dense(dim, dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, a: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        _, h, w, _ = x.shape
        ws = self.window
        x, y = add_norm_to_windows(x, a, *self.norm1.affine(x.dtype), self.norm1.eps, 0, ws)
        o = overlap_attention(linear(self.qkv, y), self.relative_position_bias_table, self.heads, (h // ws, w // ws),
                              ws, self.overlap)
        x, y = add_norm_from_windows(x, linear(self.proj, o), *self.norm2.affine(x.dtype), self.norm2.eps, 0, ws)
        return x, self.mlp(y)

    def init_(self, gen: torch.Generator) -> None:
        for layer in (self.qkv, self.proj, self.mlp.fc1, self.mlp.fc2):
            _dense_init(layer, gen)
        _table_init(self.relative_position_bias_table, gen)


class RHAG(nn.Module):
    """Residual hybrid attention group: HABs (plain and shifted windows in
    turn), an OCAB, then a 3 x 3 conv, on the group's residual."""

    def __init__(self, dim: int, depth: int, heads: int, cfg: HATConfig):
        super().__init__()
        ws = cfg.window_size
        self.blocks = nn.ModuleList(HAB(dim, heads, ws, 0 if i % 2 == 0 else ws // 2, cfg) for i in range(depth))
        self.overlap_attn = OCAB(dim, heads, ws, cfg.overlap_window, cfg.mlp_ratio)
        self.conv = L.Conv(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, m = x, None
        for block in self.blocks:
            y, m = block(y, m)
        y, m = self.overlap_attn(y, m)
        return self.conv(y + m) + x


class HAT(SwinIR):
    """[N,H,W,3] in [0,1] -> [N,H*scale,W*scale,3] f32, SwinIR's network
    with RHAGs for its residual groups."""

    blocks = (HAB, OCAB)

    def __init__(self, config: HATConfig = HATConfig()):
        super().__init__(config)

    def groups(self, c: HATConfig) -> nn.ModuleList:
        return nn.ModuleList(RHAG(c.embed_dim, depth, heads, c) for depth, heads in zip(c.depths, c.num_heads))
