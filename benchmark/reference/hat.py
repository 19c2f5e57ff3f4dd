"""The plain float32 reference of HAT, the Hybrid Attention Transformer
(Chen et al., "Activating More Pixels in Image Super-Resolution
Transformer", CVPR 2023, arXiv:2205.04437), classical SR with the
pixel-shuffle upsampler, written after the published model
(github.com/XPixelGroup/HAT, ``hat/archs/hat_arch.py``): reflect-pad to a
multiple of the window, the RGB mean shift, ``conv_first``, the patch
embedding's LayerNorm, residual hybrid attention groups (RHAGs), the final
LayerNorm, ``conv_after_body`` and the long skip, ``conv_before_upsample``
with LeakyReLU, conv + pixel-shuffle stages, ``conv_last``, the mean added
back and the crop.

An RHAG is hybrid attention blocks (HABs), one overlapping cross-attention
block (OCAB) and a 3 x 3 conv on the group's residual. A HAB adds to its
input the (shifted) window self-attention of its first LayerNorm's output
and ``conv_scale`` times the channel-attention block (CAB: 3 x 3 conv to
``embed_dim / compress_ratio``, GELU, 3 x 3 conv back, and a sigmoid gate
from the tile's mean through two 1 x 1 convs) of the same output, then an
MLP on a second residual. An OCAB takes q from each window and k and v from
the larger overlapping window around it, cut by ``F.unfold`` with zero
padding, with a relative-position bias read at the published
``calculate_rpi_oca`` index as written: its negative entries wrap, as
PyTorch's indexing wraps them. Every attention is an explicit product, bias,
mask and softmax. Activations are NHWC; nothing here imports the program.

A configuration names this module with ``"reference": "hat"``
(``benchmark/spec.py:load_reference`` has the contract it keeps). Its
architecture keys are the published ones (``embed_dim``, ``depths``,
``num_heads``, ``window_size``, ``compress_ratio``, ``squeeze_factor``,
``conv_scale``, ``overlap_ratio``, ``mlp_ratio``, ``img_range``,
``rgb_mean``, ``patch_norm``, ``num_feat``) with the tiled surface's
(``scale``, ``in_channels``, ``tile``, ...).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.flops import conv_flops, sr_tiles
from benchmark.reference.models import Precision, conv
from benchmark.reference.swinir import (
    LINEAR_STD,
    attention_mask,
    pixel_shuffle,
    relative_position_index,
    shuffle_stages,
    window_partition,
    window_reverse,
)


def overlap_window(arch: dict) -> int:
    """The OCAB's key window: ``window_size * (1 + overlap_ratio)``."""
    ws = arch["window_size"]
    return int(arch["overlap_ratio"] * ws) + ws


def overlap_position_index(ws: int, ows: int) -> torch.Tensor:
    """The published ``calculate_rpi_oca``: [ws^2, ows^2], row of the OCAB's
    bias table for query token i of a window and key token j of its
    overlapping window. Entries below 0 are left as they come: indexing the
    table wraps them."""
    coords_ori = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij")).flatten(1)
    coords_ext = torch.stack(torch.meshgrid(torch.arange(ows), torch.arange(ows), indexing="ij")).flatten(1)
    rel = (coords_ext[:, None, :] - coords_ori[:, :, None]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - ows + 1
    rel[:, :, 1] += ws - ows + 1
    rel[:, :, 0] *= ws + ows - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=16)
def _on_device(build, args: tuple, device: str) -> torch.Tensor:
    """``build(*args)`` copied to ``device`` once a run: the bias indexes and
    the shifted windows' mask are the same in every block and every chunk,
    and building the mask on the host and copying it for each block would
    stall the device at every shifted block."""
    return build(*args).to(device)


def _layer_norm(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}/scale"], p[f"{name}/bias"], 1e-5)


def _dense(x, p, name, prec):
    return torch.matmul(prec.q(x), prec.q(p[f"{name}/w"])) + p[f"{name}/b"]


def _mlp(x, p, name, prec):
    return _dense(F.gelu(_dense(x, p, f"{name}/fc1", prec)), p, f"{name}/fc2", prec)


def _cab(y, p, name, prec):
    """The channel-attention block on y [B, H, W, C]; its gate is the mean
    over the whole of each image (on the tiled path each tile is one)."""
    u = conv(F.gelu(conv(y, p[f"{name}/conv1/w"], p[f"{name}/conv1/b"], prec)), p[f"{name}/conv2/w"],
             p[f"{name}/conv2/b"], prec)
    z = F.relu(conv(u.mean(dim=(1, 2), keepdim=True), p[f"{name}/ca_down/w"], p[f"{name}/ca_down/b"], prec))
    return u * torch.sigmoid(conv(z, p[f"{name}/ca_up/w"], p[f"{name}/ca_up/b"], prec))


def _attend(q, k, v, bias, prec, mask=None):
    """softmax(q k^T / sqrt(D) + bias + mask) v of [n, heads, t, D] q and
    [n, heads, s, D] k, v: bias [heads, t, s], and the shifted windows'
    mask [nW, t, t] of the windows of each image, batch-major."""
    attn = torch.matmul(prec.q(q), prec.q(k).transpose(-2, -1))
    attn.mul_(q.shape[-1] ** -0.5).add_(bias[None])
    if mask is not None:
        n, heads, t, s = attn.shape
        attn.view(n // mask.shape[0], mask.shape[0], heads, t, s).add_(mask[None, :, None])
    return torch.matmul(prec.q(torch.softmax(attn, dim=-1)), prec.q(v))


def _hab(x, p, name, heads, ws, shift, arch, prec):
    b, h, w, c = x.shape
    y = _layer_norm(x, p, f"{name}/norm1")
    conv_x = _cab(y, p, f"{name}/conv_block", prec)
    if shift:
        y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
    win = window_partition(y, ws)
    bn, n, _ = win.shape
    q, k, v = _dense(win, p, f"{name}/attn/qkv", prec).reshape(bn, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    table = p[f"{name}/attn/relative_position_bias_table"]
    bias = table[_on_device(relative_position_index, (ws,), str(x.device)).view(-1)].view(n, n, -1).permute(2, 0, 1)
    mask = _on_device(attention_mask, (h, w, ws, shift), str(x.device)) if shift else None
    o = _attend(q, k, v, bias, prec, mask).transpose(1, 2).reshape(bn, n, c)
    y = window_reverse(_dense(o, p, f"{name}/attn/proj", prec), ws, b, h, w)
    if shift:
        y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
    x = x + y + conv_x * arch["conv_scale"]
    return x + _mlp(_layer_norm(x, p, f"{name}/norm2"), p, f"{name}/mlp", prec)


def _ocab(x, p, name, heads, ws, ows, prec):
    b, h, w, c = x.shape
    d = c // heads
    qkv = _dense(_layer_norm(x, p, f"{name}/norm1"), p, f"{name}/qkv", prec)
    q = window_partition(qkv[..., :c], ws)  # [b * nW, ws^2, c]
    kv = F.unfold(qkv[..., c:].permute(0, 3, 1, 2), kernel_size=ows, stride=ws, padding=(ows - ws) // 2)
    kv = kv.view(b, 2, c, ows * ows, -1).permute(1, 0, 4, 3, 2).reshape(2, -1, ows * ows, c)  # the published rearrange
    bn = q.shape[0]
    q = q.reshape(bn, ws * ws, heads, d).transpose(1, 2)
    k, v = (t.reshape(bn, ows * ows, heads, d).transpose(1, 2) for t in kv)
    table = p[f"{name}/relative_position_bias_table"]
    index = _on_device(overlap_position_index, (ws, ows), str(x.device))
    bias = table[index.view(-1)].view(ws * ws, ows * ows, -1).permute(2, 0, 1)
    o = _attend(q, k, v, bias, prec).transpose(1, 2).reshape(bn, ws * ws, c)
    x = x + _dense(window_reverse(o, ws, b, h, w), p, f"{name}/proj", prec)
    return x + _mlp(_layer_norm(x, p, f"{name}/norm2"), p, f"{name}/mlp", prec)


def network(p: dict, arch: dict, x: torch.Tensor, prec: Precision = Precision()) -> torch.Tensor:
    """x [N,h,w,3] in [0,1] -> [N,h*s,w*s,3]."""
    n, h, w, _ = x.shape
    ws, s = arch["window_size"], arch["scale"]
    x = prec.q(x)
    ph, pw = (-h) % ws, (-w) % ws
    if ph or pw:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="reflect").permute(0, 2, 3, 1)
    mean = torch.tensor(arch["rgb_mean"], dtype=torch.float32, device=x.device)
    x = (x - mean) * arch["img_range"]
    feat = conv(x, p["conv_first/w"], p["conv_first/b"], prec)
    y = _layer_norm(feat, p, "patch_norm") if arch["patch_norm"] else feat
    for i, (depth, heads) in enumerate(zip(arch["depths"], arch["num_heads"])):
        r = y
        for j in range(depth):
            y = _hab(y, p, f"layers/{i}/blocks/{j}", heads, ws, 0 if j % 2 == 0 else ws // 2, arch, prec)
        y = _ocab(y, p, f"layers/{i}/overlap_attn", heads, ws, overlap_window(arch), prec)
        y = conv(y, p[f"layers/{i}/conv/w"], p[f"layers/{i}/conv/b"], prec) + r
    y = _layer_norm(y, p, "norm")
    feat = conv(y, p["conv_after_body/w"], p["conv_after_body/b"], prec) + feat
    y = F.leaky_relu(conv(feat, p["conv_before_upsample/w"], p["conv_before_upsample/b"], prec), 0.01)
    for i, r in enumerate(shuffle_stages(s)):
        y = pixel_shuffle(conv(y, p[f"upsample/{i}/w"], p[f"upsample/{i}/b"], prec), r)
    out = conv(y, p["conv_last/w"], p["conv_last/b"], prec) / arch["img_range"] + mean
    return out[:, : h * s, : w * s]


def _padded(arch: dict, tile: int) -> int:
    ws = arch["window_size"]
    return -(-tile // ws) * ws


def _widths(arch: dict) -> tuple[int, int, int, int]:
    """(C, the MLP's hidden width, CAB's width, the gate's squeezed width)."""
    c = arch["embed_dim"]
    return c, int(c * arch["mlp_ratio"]), c // arch["compress_ratio"], c // arch["squeeze_factor"]


def tile_flops(arch: dict, tile: int) -> int:
    """Operations of the network over one ``tile``-square input tile (padded
    to the window): the convs (CAB's and its gate's 1 x 1 convs included),
    and per token of each HAB and OCAB its four linears and its attention's
    two products (over ``window_size^2`` keys in a HAB, the overlapping
    window's in an OCAB)."""
    t = _padded(arch, tile)
    c, hidden, mid, squeezed = _widths(arch)
    nf, cin = arch["num_feat"], arch["in_channels"]
    tokens = t * t
    linears = 2 * tokens * (3 * c * c + c * c + 2 * c * hidden)
    cab = conv_flops(t, t, c, mid) + conv_flops(t, t, mid, c) + 2 * conv_flops(1, 1, c, squeezed, 1)
    hab = linears + 4 * tokens * arch["window_size"] ** 2 * c + cab
    ocab = linears + 4 * tokens * overlap_window(arch) ** 2 * c
    total = conv_flops(t, t, cin, c) + sum(depth * hab + ocab for depth in arch["depths"])
    total += (len(arch["depths"]) + 1) * conv_flops(t, t, c, c) + conv_flops(t, t, c, nf)
    side = t
    for r in shuffle_stages(arch["scale"]):
        total += conv_flops(side, side, nf, r * r * nf)
        side *= r
    return total + conv_flops(side, side, nf, cin)


def attention_bytes(arch: dict, canvas: int) -> int:
    """The HABs' window attention's minimal traffic over a tiled canvas (the
    formula of ``benchmark/reference/swinir.py``): q, k and v read once and o
    written once, in bf16, for every window of every tile in every HAB, and
    each HAB's f32 bias table read once."""
    t = _padded(arch, arch["tile"])
    tokens = sr_tiles(arch, canvas) * t * t
    span = (2 * arch["window_size"] - 1) ** 2
    return sum(depth * (4 * tokens * arch["embed_dim"] * 2 + 4 * span * heads)
               for depth, heads in zip(arch["depths"], arch["num_heads"]))


def init(arch: dict, seed: int) -> dict:
    """Float32 arrays from ``seed`` in the npz layout ('/'-joined names,
    HWIO conv kernels, 1 x 1 ones too, dense kernels [in, out], bias tables
    [(2w-1)^2, heads] and the OCAB's [(w + ow - 1)^2, heads]): SwinIR's draw
    (benchmark/reference/swinir.py:init), PyTorch's default uniform for
    every conv, a normal of std 0.02 for linears and tables."""
    rng = np.random.default_rng(seed)
    c, hidden, mid, squeezed = _widths(arch)
    nf, cin, ws = arch["num_feat"], arch["in_channels"], arch["window_size"]
    ows = overlap_window(arch)
    out: dict[str, np.ndarray] = {}

    def conv_(name, ci, co, k=3):
        bound = 1.0 / math.sqrt(ci * k * k)
        out[f"{name}/w"] = rng.uniform(-bound, bound, (k, k, ci, co))
        out[f"{name}/b"] = rng.uniform(-bound, bound, (co,))

    def dense_(name, ci, co):
        out[f"{name}/w"] = np.clip(rng.normal(0.0, LINEAR_STD, (ci, co)), -2.0, 2.0)
        out[f"{name}/b"] = np.zeros(co)

    def table_(name, rows, heads):
        out[name] = np.clip(rng.normal(0.0, LINEAR_STD, (rows, heads)), -2.0, 2.0)

    def norm_(name):
        out[f"{name}/scale"] = np.ones(c)
        out[f"{name}/bias"] = np.zeros(c)

    def mlp_(name):
        dense_(f"{name}/fc1", c, hidden)
        dense_(f"{name}/fc2", hidden, c)

    conv_("conv_first", cin, c)
    if arch["patch_norm"]:
        norm_("patch_norm")
    for i, (depth, heads) in enumerate(zip(arch["depths"], arch["num_heads"])):
        for j in range(depth):
            name = f"layers/{i}/blocks/{j}"
            norm_(f"{name}/norm1")
            dense_(f"{name}/attn/qkv", c, 3 * c)
            table_(f"{name}/attn/relative_position_bias_table", (2 * ws - 1) ** 2, heads)
            dense_(f"{name}/attn/proj", c, c)
            conv_(f"{name}/conv_block/conv1", c, mid)
            conv_(f"{name}/conv_block/conv2", mid, c)
            conv_(f"{name}/conv_block/ca_down", c, squeezed, 1)
            conv_(f"{name}/conv_block/ca_up", squeezed, c, 1)
            norm_(f"{name}/norm2")
            mlp_(f"{name}/mlp")
        name = f"layers/{i}/overlap_attn"
        norm_(f"{name}/norm1")
        dense_(f"{name}/qkv", c, 3 * c)
        table_(f"{name}/relative_position_bias_table", (ws + ows - 1) ** 2, heads)
        dense_(f"{name}/proj", c, c)
        norm_(f"{name}/norm2")
        mlp_(f"{name}/mlp")
        conv_(f"layers/{i}/conv", c, c)
    norm_("norm")
    conv_("conv_after_body", c, c)
    conv_("conv_before_upsample", c, nf)
    for i, r in enumerate(shuffle_stages(arch["scale"])):
        conv_(f"upsample/{i}", nf, r * r * nf)
    conv_("conv_last", nf, cin)
    return {k: v.astype(np.float32) for k, v in out.items()}
