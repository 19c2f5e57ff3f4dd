"""W-fold serving layout: the UNet and SRNet with width pairs folded into
channels.

Counterpart of image_restoration_platform_tpu/models/folded.py. Adjacent
width columns fold into channels, X'[n,h,w',2c+p] = X[n,h,2w'+p,c], which
doubles every level's channel count and halves its width. Every 3x3
convolution becomes exactly a 3x3 convolution on the folded layout with a
half-zero kernel (the tap tables ``_FOLD_S1`` / ``_FOLD_S2``), a 1x1 a
block-diagonal one; biases, GroupNorm and FiLM parameters repeat per pair.
The interleaved order 2c+p keeps GroupNorm groups contiguous, so the port's
``ResBlock``, ``GroupNorm`` and ``Film`` run unchanged on folded tensors
with the folded parameters. The result is the unfolded forward's, up to the
order of the sums.

Three places leave the layout: the bottleneck attention unfolds, runs
``Attention`` (the flash attention kernel on a card, at the unfolded
forward's ``[N, heads, T, D]``) and folds back; the decoder's nearest x2
upsample never unfolds but rides inside four phase convolutions
(``_fold_upconv``, ``upconv2d_folded``, ``_res_block_up``); the output head
unfolds before its pixel shuffle.

Weights fold once, at load: ``fold_state`` / ``fold_state_srnet`` map a
port state dict (OIHW kernels, models/weights.py ``params_from_jax``) to the
folded one, which ``FoldedUNet`` / ``FoldedSRNet`` load with
``strict=True``. Their ``forward`` has the unfolded modules' signature, so
``models.diffusion.restore`` and the serving programs take them unchanged.
The engine serves the SR families folded under ``ServingConfig.fold_w_sr``
and the restore UNets under ``fold_w`` (config.py, serve/engine.py).

Derivation of the kernel maps (1-D, W axis; H is untouched). Stride 1, SAME:
O[w] = sum_kx X[w+kx-1] W[kx]. The folded output phase p_o at folded column
w' is O[2w'+p_o], which reads X[2w'+p_o+kx-1] = folded column w'+jx-1,
phase p_in: the (p_o, kx) -> (jx, p_in) table ``_FOLD_S1``. Stride 2 (SAME
on even sizes pads (0, 1)): O[w] = sum_kx X[2w+kx]; the folded read lands in
columns 2w'+jx, again a window-3 stride-2 (0, 1)-padded conv (``_FOLD_S2``).
Each (jx, p_in, p_o) slot takes at most one original tap; the other half of
the folded kernel stays zero.
"""

from __future__ import annotations

import torch
from torch import nn

from . import nn as L
from .srnet import SRBlock, SRNetConfig, residual_limit
from .swinir import SwinIRConfig
from .unet import Level, ResBlock, UNetConfig, embedding

# (p_out, kx_orig) -> (kx_folded, p_in); stride-1 SAME (pad 1_1)
_FOLD_S1 = {
    (0, 0): (0, 1),
    (0, 1): (1, 0),
    (0, 2): (1, 1),
    (1, 0): (1, 0),
    (1, 1): (1, 1),
    (1, 2): (2, 0),
}
# stride-2, pad 0_1 (what SAME gives on even sizes, kernel 3)
_FOLD_S2 = {
    (0, 0): (0, 0),
    (0, 1): (0, 1),
    (0, 2): (1, 0),
    (1, 0): (1, 0),
    (1, 1): (1, 1),
    (1, 2): (2, 0),
}


def fold_w(x: torch.Tensor) -> torch.Tensor:
    """[N,H,W,C] -> [N,H,W/2,2C]; folded channel index is 2c + (w % 2)."""
    n, h, w, c = x.shape
    if w % 2:
        raise ValueError(f"fold_w needs an even width, got {w}")
    return x.reshape(n, h, w // 2, 2, c).transpose(3, 4).reshape(n, h, w // 2, 2 * c)


def unfold_w(x: torch.Tensor) -> torch.Tensor:
    """Inverse of fold_w: [N,H,W',2C] -> [N,H,2W',C]."""
    n, h, w2, c2 = x.shape
    c = c2 // 2
    return x.reshape(n, h, w2, c, 2).transpose(3, 4).reshape(n, h, 2 * w2, c)


# ------------------------------------------------------------ weight maps
#
# Port layouts: conv kernels OIHW [co, ci, kh, kw], dense [in, out].


def _fold_conv3(w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """[Co,Ci,kh,3] -> [2Co,2Ci,kh,3] implementing the same conv on folds."""
    co, ci, kh, kw = w.shape
    if kw != 3:
        raise ValueError(f"a 3-wide kernel, got {kw}")
    table = _FOLD_S1 if stride == 1 else _FOLD_S2
    wf = w.new_zeros((2 * co, 2 * ci, kh, 3))
    for (po, kx), (jx, pin) in table.items():
        wf[po::2, pin::2, :, jx] = w[:, :, :, kx]
    return wf


def _fold_conv1(w: torch.Tensor) -> torch.Tensor:
    """1x1 conv: phases don't mix -> block-diagonal over (p_in == p_out)."""
    co, ci, kh, kw = w.shape
    if (kh, kw) != (1, 1):
        raise ValueError(f"a 1x1 kernel, got {(kh, kw)}")
    wf = w.new_zeros((2 * co, 2 * ci, 1, 1))
    for p in (0, 1):
        wf[p::2, p::2] = w
    return wf


def _fold_conv(w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    return _fold_conv1(w) if w.shape[-1] == 1 else _fold_conv3(w, stride)


def _fold_gn(v: torch.Tensor) -> torch.Tensor:
    """A per-channel vector (GroupNorm scale or bias, conv bias): the
    interleaved repeat keeps group spans contiguous, folded group g covering
    {2c+p : c in original group g}."""
    return v.repeat_interleave(2, dim=-1)


def _fold_film(v: torch.Tensor) -> torch.Tensor:
    """FiLM's dense kernel [in, 2C] or bias [2C] packs [gamma | beta] on the
    output axis: repeat within each half."""
    ch = v.shape[-1] // 2
    return torch.cat([_fold_gn(v[..., :ch]), _fold_gn(v[..., ch:])], dim=-1)


def _fold_res_block(state: dict, prefix: str) -> dict:
    """The folded entries of one ``ResBlock`` under ``prefix``."""
    out = {}
    for key, v in state.items():
        if not key.startswith(prefix):
            continue
        layer = key[len(prefix):].split(".")[0]
        if layer == "film":
            out[key] = _fold_film(v)
        elif v.dim() == 4:
            out[key] = _fold_conv(v)
        else:  # conv biases, GroupNorm scale and bias
            out[key] = _fold_gn(v)
    return out


def _assert_gn_foldable(state: dict, groups: int) -> None:
    """Folded GroupNorm equals the unfolded one only when doubling the
    channel count leaves the group count alone (gn_groups(2C) ==
    gn_groups(C)): then each folded group is exactly the interleaved fold of
    an original group. Every shipped config satisfies this; one that did not
    would diverge silently, so refuse it."""
    for key, v in state.items():
        if key.endswith(".scale") and v.dim() == 1:
            c = v.shape[0]
            if L.gn_groups(2 * c, groups) != L.gn_groups(c, groups):
                raise ValueError(
                    f"GroupNorm {key} over {c} channels is not fold-safe with norm_groups={groups}: "
                    f"folded group count {L.gn_groups(2 * c, groups)} != {L.gn_groups(c, groups)}"
                )


def fold_state(state: dict, config: UNetConfig) -> dict:
    """A ``RestorationUNet`` state dict -> its ``FoldedUNet`` equivalent
    (the reference's ``fold_params``)."""
    _assert_gn_foldable(state, config.norm_groups)
    out = {}
    for key, v in state.items():
        if key.startswith(("cond_mlp1.", "cond_mlp2.", "mid.attn.")):
            out[key] = v  # the embedding MLP; attention runs unfolded
        elif _block_prefix(key):
            continue  # below, per block
        elif v.dim() == 4:
            out[key] = _fold_conv(v, stride=2 if key.endswith(".down.w") else 1)
        else:  # stem/head/down/up biases, head_norm
            out[key] = _fold_gn(v)
    for prefix in sorted({_block_prefix(k) for k in state if _block_prefix(k)}):
        out.update(_fold_res_block(state, prefix))
    for i in range(1, len(config.channel_mults)):
        # every dec level after the first re-enters at half resolution; its
        # first block consumes up2(h) ++ skip. The fused upsample's phase
        # kernels come from the REAL x-part weights (the fold of
        # up-then-conv is not the up of the folded conv)
        b0 = f"dec.{i}.blocks.0."
        w1 = state[b0 + "conv1.w"]
        ci_x = w1.shape[1] - w1.shape[0]
        out[f"dec.{i}.up0.conv1_up"] = _fold_upconv(w1[:, :ci_x])
        out[f"dec.{i}.up0.skip_up"] = _fold_upconv(state[b0 + "skip.w"][:, :ci_x])
    return out


def _block_prefix(key: str) -> str | None:
    """'enc.0.blocks.1.' for a key of that ResBlock ('mid.block1.' in the
    bottleneck), else None."""
    parts = key.split(".")
    if len(parts) > 3 and parts[2] == "blocks":
        return ".".join(parts[:4]) + "."
    if parts[0] == "mid" and parts[1] in ("block1", "block2"):
        return f"mid.{parts[1]}."
    return None


def fold_state_srnet(state: dict) -> dict:
    """An ``SRNet`` state dict -> its ``FoldedSRNet`` equivalent: a pure
    stride-1 conv chain, so every kernel folds and every bias repeats."""
    return {k: _fold_conv(v) if v.dim() == 4 else _fold_gn(v) for k, v in state.items()}


# --------------------------------------------------- fold-preserving upsample
#
# The decoder's nearest-up2 -> conv composition, expressed WITHOUT leaving
# the folded layout:
#
#   * conv(nearest_up2(x)) is linear and shift-equivariant with period 2, so
#     the composite splits into 2x2 output phases (H phase g, folded-W phase
#     f), each a plain stride-1 conv on the folded input; interleaving the
#     four phase outputs back merges rows and columns, never channels.
#
#   * 1-D (W axis; taps w[-1..1], u = nearest_up2(x)):
#       y[2p]   = w[-1]x[p-1] + (w[0]+w[1])x[p]
#       y[2p+1] = (w[-1]+w[0])x[p] + w[1]x[p+1]
#     With x itself folded and the output folded column p = 2q+f at phase
#     e, each (f, e) slot reads at most two folded columns: the _UPW3
#     table. The H axis is the same algebra without the phase split
#     (_UPH3). SAME zero padding maps correctly on both axes.
#
#   * GroupNorm and SiLU commute exactly with nearest duplication (each
#     group's values repeat 4 times), so the decoder block's norm1 -> silu
#     runs at the pre-upsample resolution.

# H axis, output row phase g: (dy_index, [original ky taps summed])
_UPH3 = {0: ((0, (0,)), (1, (1, 2))), 1: ((1, (0, 1)), (2, (2,)))}
# W axis, folded-output-column phase f: (dx_index, p_in, e_out, [kx taps])
_UPW3 = {
    0: ((0, 1, 0, (0,)), (1, 0, 0, (1, 2)), (1, 0, 1, (0, 1)), (1, 1, 1, (2,))),
    1: ((1, 0, 0, (0,)), (1, 1, 0, (1, 2)), (1, 1, 1, (0, 1)), (2, 0, 1, (2,))),
}


def _fold_upconv(w: torch.Tensor) -> torch.Tensor:
    """Real decoder kernel [Co,Ci,kh,kw] (3x3 or 1x1) -> phase kernels
    [2,2,2Co,2Ci,kh,kw] such that applying them per (g, f) phase and
    interleaving equals fold(conv(nearest_up2(unfold(x))))."""
    co, ci, kh, kw = w.shape
    if (kh, kw) == (1, 1):
        h_taps = {g: ((0, (0,)),) for g in (0, 1)}
        w_taps = {f: ((0, f, 0, (0,)), (0, f, 1, (0,))) for f in (0, 1)}
    elif (kh, kw) == (3, 3):
        h_taps, w_taps = _UPH3, _UPW3
    else:
        raise ValueError(f"a 3x3 or 1x1 kernel, got {(kh, kw)}")
    out = w.new_zeros((2, 2, 2 * co, 2 * ci, kh, kw))
    for g in (0, 1):
        for f in (0, 1):
            for dy, kys in h_taps[g]:
                for dx, pin, e, kxs in w_taps[f]:
                    acc = sum(w[:, :, ky, kx] for ky in kys for kx in kxs)
                    out[g, f, e::2, pin::2, dy, dx] += acc
    return out


def _phase_conv(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME conv of NHWC ``x`` with the OIHW kernel ``k``, no bias."""
    return L._conv_nchw(x, k, 1)


def upconv2d_folded(kernels: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """fold(conv(nearest_up2(unfold(x)))) as four stride-1 folded convs.

    ``kernels`` [2,2,2Co,2Ci,kh,kw] from _fold_upconv; x [N,H,W',2Ci] folded
    -> [N,2H,2W',2Co] folded. No bias (callers add it once)."""
    n, h, wf, _ = x.shape
    rows = []
    for g in (0, 1):
        o0 = _phase_conv(x, kernels[g, 0])
        o1 = _phase_conv(x, kernels[g, 1])
        co2 = o0.shape[-1]
        rows.append(torch.stack([o0, o1], dim=3).reshape(n, h, 2 * wf, co2))
    return torch.stack(rows, dim=2).reshape(n, 2 * h, 2 * wf, rows[0].shape[-1])


def _upsample_nearest_folded(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsample mapping folded -> folded: unfold W, duplicate
    rows, then the interleaved channel duplicate IS the W-fold of column
    duplication. Kept for the tests; the decoder uses the phase convs."""
    u = unfold_w(x)
    return u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=-1)


def _res_block_up(block: ResBlock, up0: "PhaseKernels", x_lo: torch.Tensor, cat: torch.Tensor,
                  emb: torch.Tensor, groups: int) -> torch.Tensor:
    """``block(upsample_nearest(x_lo), emb, groups, cat=cat)`` on folded
    tensors with the nearest upsample fused into the convolutions: x_lo stays
    at the pre-upsample resolution through the norm and activation and
    reaches the level's resolution only through the phase convs.

    GroupNorm over [up2(x_lo), cat]: duplication keeps per-channel moments,
    so x's sums weigh 4x against cat's grid count."""
    n = x_lo.shape[0]
    cx, cc = x_lo.shape[-1], cat.shape[-1]
    ctot = cx + cc
    g = L.gn_groups(ctot, groups)
    per = ctot // g
    cnt = cat.shape[1] * cat.shape[2] * per
    (s1x, s2x), (s1c, s2c) = L.gn_moments(x_lo), L.gn_moments(cat)
    s1 = torch.cat([4.0 * s1x, s1c], dim=-1)
    s2 = torch.cat([4.0 * s2x, s2c], dim=-1)
    scale, bias = L._folded_affine(block.norm1.scale, block.norm1.bias, *L._group_moments(s1, s2, g, cnt, 1e-5))
    na = L.gn_affine_silu(x_lo, scale[:, :cx], bias[:, :cx])
    nb = L.gn_affine_silu(cat, scale[:, cx:], bias[:, cx:])

    h1 = upconv2d_folded(up0.conv1_up, na)
    h1 = h1 + block.conv1.part(nb, cx)
    h1 = block.norm2.film_silu(h1, block.conv1.full_bias(), block.film.gamma_beta(emb, h1.dtype), groups)
    h1 = block.conv2(h1)

    sp = upconv2d_folded(up0.skip_up, x_lo)
    sp = sp + block.skip.part(cat, cx)
    sp = block.skip.add_bias(sp)
    return sp + h1


# ----------------------------------------------------------------- modules


class PhaseKernels(nn.Module):
    """The fused-upsample phase kernels of a decoder level's first block:
    ``conv1_up`` [2,2,co,ci,3,3] and ``skip_up`` [2,2,co,ci,1,1] (folded
    widths), applied in the compute type."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1_up = nn.Parameter(torch.zeros(2, 2, out_ch, in_ch, 3, 3))
        self.skip_up = nn.Parameter(torch.zeros(2, 2, out_ch, in_ch, 1, 1))

    def compute_params(self):
        return (self.conv1_up, self.skip_up)


class _FoldedMid(nn.Module):
    def __init__(self, ch: int, emb_dim: int):
        super().__init__()
        self.block1 = ResBlock(2 * ch, 2 * ch, emb_dim)
        self.attn = L.Attention(ch)  # runs unfolded
        self.block2 = ResBlock(2 * ch, 2 * ch, emb_dim)


class FoldedUNet(nn.Module):
    """``RestorationUNet`` on the folded layout, weights from ``fold_state``:
    every activation between the stem and the head is [N,H,W/2,2C]."""

    folded = True

    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        c = self.config = config
        ch = [2 * c.base_channels * m for m in c.channel_mults]  # folded widths
        s2 = c.input_scale * c.input_scale
        self.cond_mlp1 = L.Dense(c.cond_dim + (c.emb_dim if c.time_conditioned else 0), c.emb_dim)
        self.cond_mlp2 = L.Dense(c.emb_dim, c.emb_dim)
        self.stem = L.Conv(2 * c.in_channels * s2, ch[0])

        enc, in_ch = [], ch[0]
        for level, out_ch in enumerate(ch):
            blocks = []
            for _ in range(c.blocks_per_level):
                blocks.append(ResBlock(in_ch, out_ch, c.emb_dim))
                in_ch = out_ch
            enc.append(Level(blocks, down=level < len(ch) - 1, ch=out_ch))
        self.enc = nn.ModuleList(enc)
        self.mid = _FoldedMid(in_ch // 2, c.emb_dim)

        dec = []
        for i, level in enumerate(reversed(range(len(ch)))):
            out_ch = ch[level]
            blocks = [
                ResBlock(in_ch + out_ch if j == 0 else out_ch, out_ch, c.emb_dim)
                for j in range(c.blocks_per_level)
            ]
            lv = Level(blocks, up=level > 0, ch=out_ch)
            if i > 0:
                lv.up0 = PhaseKernels(in_ch, out_ch)
            in_ch = out_ch
            dec.append(lv)
        self.dec = nn.ModuleList(dec)

        self.head_norm = L.GroupNorm(ch[0])
        self.head = L.Conv(ch[0], 2 * c.out_channels * s2)

    def forward(
        self, x: torch.Tensor, cond: torch.Tensor, t: torch.Tensor | None = None, s2d_io: bool = False
    ) -> torch.Tensor:
        """``RestorationUNet.forward`` on the folded weights: x [N,H,W,in]
        in [0,1], cond [N,cond_dim], t [N] (time-conditioned configs) ->
        restored, in x's layout and type. The folded layout has no
        space-to-depth IO."""
        c = self.config
        if s2d_io:
            raise ValueError("the folded UNet has no s2d_io: the engine turns it off for folded families")
        dtype = x.dtype
        emb = embedding(self, x, cond, t)
        x_in = L.space_to_depth(x, c.input_scale) if c.input_scale > 1 else x
        # each of the (levels-1) stride-2 convs halves the folded width and
        # _FOLD_S2 assumes the pre-stride width is even, so the network
        # input's width must carry 2^levels worth of factors of two
        if x_in.shape[2] % (2 ** len(c.channel_mults)):
            raise ValueError(
                f"the folded UNet needs an input width (after space-to-depth) divisible by "
                f"{2 ** len(c.channel_mults)}, got {x_in.shape[2]}"
            )
        h = self.stem(fold_w(x_in))

        skips = []
        for level in self.enc:
            for block in level.blocks:
                h = block(h, emb, c.norm_groups)
            skips.append(h)
            if hasattr(level, "down"):
                # SAME on the (even) folded width pads (0, 1): _FOLD_S2's layout
                h = level.down(h, stride=2)

        h = self.mid.block1(h, emb, c.norm_groups)
        if h.shape[1] * h.shape[2] * 2 <= c.max_attn_tokens:
            h = fold_w(self.mid.attn(unfold_w(h), c.attn_heads))
        h = self.mid.block2(h, emb, c.norm_groups)

        for i, level in enumerate(self.dec):
            skip = skips[len(skips) - 1 - i]
            j0 = 0
            if h.shape[1] != skip.shape[1]:
                # the nearest-up2 fused into the phase convs: no unfold
                h = _res_block_up(level.blocks[0], level.up0, h, skip, emb, c.norm_groups)
                j0 = 1
            for j in range(j0, len(level.blocks)):
                h = level.blocks[j](h, emb, c.norm_groups, cat=skip if j == 0 else None)
            if hasattr(level, "up"):
                h = level.up(h)

        h = self.head_norm.silu(h, c.norm_groups)
        residual = unfold_w(self.head(h))
        if c.input_scale > 1:
            residual = L.pixel_shuffle(residual, c.input_scale)
        base = x if x.shape[-1] == c.out_channels else x[..., : c.out_channels]
        if c.residual_shrink > 0.0:
            r = residual.float()
            residual = torch.sign(r) * torch.clamp(r.abs() - c.residual_shrink, min=0.0)
        return base + residual.to(dtype)


class FoldedSRNet(nn.Module):
    """``SRNet`` on the folded layout, weights from ``fold_state_srnet``: the
    ideal fold case (a stride-1 conv chain with SiLU and residual adds), its
    only boundaries the input's fold and the head's unfold."""

    folded = True

    def __init__(self, config: SRNetConfig = SRNetConfig()):
        super().__init__()
        c = self.config = config
        ch = 2 * c.channels
        self.stem = L.Conv(2 * c.in_channels, ch)
        self.blocks = nn.ModuleList(SRBlock(ch) for _ in range(c.num_blocks))
        self.pre_up = L.Conv(ch, ch)
        self.up = L.Conv(ch, 2 * c.in_channels * c.scale * c.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``SRNet.forward`` on the folded weights: [N,H,W,3] in [0,1] ->
        [N,H*scale,W*scale,3], f32 when the limiter runs."""
        c = self.config
        h = self.stem(fold_w(x))
        feat = h
        for block in self.blocks:
            feat = block(feat)
        feat = self.pre_up(feat) + h
        up = L.pixel_shuffle(unfold_w(self.up(feat)), c.scale)
        return residual_limit(x, up + L.upsample_nearest(x, c.scale), c)


def is_folded(model) -> bool:
    """Whether ``model`` (or each of a list of replicas) is a folded module."""
    if isinstance(model, (list, tuple)):
        return all(is_folded(m) for m in model)
    return getattr(model, "folded", False)


def folded_model(config, state: dict) -> nn.Module:
    """The folded module of a family's config (``UNetConfig``, a diffusion
    config's ``unet``, or ``SRNetConfig``) with ``state``, the unfolded
    module's state dict, folded into it. SwinIR has no folded layout: its
    window attention works on the unfolded token grid."""
    if isinstance(config, SwinIRConfig):
        raise ValueError("the W-fold has no folded layout of SwinIR (SwinIRConfig): serve it unfolded")
    if isinstance(config, SRNetConfig):
        model, folded_state = FoldedSRNet(config), fold_state_srnet(state)
    else:
        cfg = getattr(config, "unet", config)
        model, folded_state = FoldedUNet(cfg), fold_state(state, cfg)
    model.load_state_dict(folded_state, strict=True)
    return model
