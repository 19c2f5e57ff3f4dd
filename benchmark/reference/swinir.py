"""The plain float32 reference of SwinIR (Liang et al., "SwinIR: Image
Restoration Using Swin Transformer", arXiv:2108.10257), classical SR with the
pixel-shuffle upsampler, written after the published model
(github.com/JingyunLiang/SwinIR, ``models/network_swinir.py``): reflect-pad
to a multiple of the window, the RGB mean shift, ``conv_first``, the patch
embedding's LayerNorm, residual Swin transformer blocks (Swin layers that
alternate plain and shifted window attention, each block ending in a 3 x 3
conv on its residual), the final LayerNorm, ``conv_after_body`` and the long
skip, ``conv_before_upsample`` with LeakyReLU, conv + pixel-shuffle stages,
``conv_last``, the mean added back and the crop. The window attention is an
explicit product, bias, mask and softmax; the shifted layers' mask is built
as the published ``calculate_mask`` builds it, from slices of an image of
region ids. Activations are NHWC; nothing here imports the program.

A configuration names this module with ``"reference": "swinir"``
(``benchmark/spec.py:load_reference`` has the contract it keeps). Its
architecture keys are the published ones (``embed_dim``, ``depths``,
``num_heads``, ``window_size``, ``mlp_ratio``, ``img_range``, ``rgb_mean``,
``patch_norm``, ``num_feat``) with the tiled surface's (``scale``,
``in_channels``, ``tile``, ...).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.flops import conv_flops, sr_tiles
from benchmark.reference.models import Precision, conv

# the draw of ``init``: the convs take PyTorch's default (uniform with bound
# 1 / sqrt(fan_in), weights and biases), which keeps the output inside
# [0, 1] on the cell's uploads with a spread of a quarter to four fifths of
# the input's (PERF.md section 4), so no conv is scaled; linears and the
# bias tables take SwinIR's _init_weights: a normal of std 0.02 truncated at
# +-2 (absolute, so in effect untruncated), zero biases; LayerNorms 1 and 0
LINEAR_STD = 0.02


def shuffle_stages(scale: int) -> list[int]:
    """The published upsampler's pixel-shuffle factors."""
    return [3] if scale == 3 else [2] * int(math.log2(scale))


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """``nn.PixelShuffle`` on NHWC: channel c * r^2 + i * r + j of a pixel
    goes to sub-pixel (i, j) of channel c."""
    n, h, w, c = x.shape
    co = c // (r * r)
    return x.reshape(n, h, w, co, r, r).permute(0, 1, 4, 2, 5, 3).reshape(n, h * r, w * r, co)


def _layer_norm(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}/scale"], p[f"{name}/bias"], 1e-5)


def _dense(x, p, name, prec):
    return torch.matmul(prec.q(x), prec.q(p[f"{name}/w"])) + p[f"{name}/b"]


def window_partition(x, ws):
    b, h, w, c = x.shape
    return x.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows, ws, b, h, w):
    c = windows.shape[-1]
    return windows.view(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def relative_position_index(ws: int) -> torch.Tensor:
    """The published index of the bias table: [ws^2, ws^2]."""
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def attention_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    """The published ``calculate_mask``: [nW, ws^2, ws^2], -100 between
    tokens of different regions of the rolled image, 0 elsewhere."""
    img_mask = torch.zeros((1, h, w, 1))
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, ws).view(-1, ws * ws)
    mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def _swin_layer(x, p, name, heads, ws, shift, prec):
    b, h, w, c = x.shape
    y = _layer_norm(x, p, f"{name}/norm1")
    if shift:
        y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
    win = window_partition(y, ws)
    bn, n, _ = win.shape
    qkv = _dense(win, p, f"{name}/attn/qkv", prec).reshape(bn, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = torch.matmul(prec.q(q), prec.q(k).transpose(-2, -1)) * (c // heads) ** -0.5
    table = p[f"{name}/attn/relative_position_bias_table"]
    attn = attn + table[relative_position_index(ws).to(x.device).view(-1)].view(n, n, -1).permute(2, 0, 1)[None]
    if shift:
        mask = attention_mask(h, w, ws, shift).to(x.device)
        nw = mask.shape[0]
        attn = (attn.view(bn // nw, nw, heads, n, n) + mask[None, :, None]).view(bn, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    o = torch.matmul(prec.q(attn), prec.q(v)).transpose(1, 2).reshape(bn, n, c)
    y = window_reverse(_dense(o, p, f"{name}/attn/proj", prec), ws, b, h, w)
    if shift:
        y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
    x = x + y
    hidden = F.gelu(_dense(_layer_norm(x, p, f"{name}/norm2"), p, f"{name}/mlp/fc1", prec))
    return x + _dense(hidden, p, f"{name}/mlp/fc2", prec)


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
            y = _swin_layer(y, p, f"layers/{i}/blocks/{j}", heads, ws, 0 if j % 2 == 0 else ws // 2, prec)
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


def tile_flops(arch: dict, tile: int) -> int:
    """Operations of the network over one ``tile``-square input tile (padded
    to the window): the convs, and per token of each Swin layer its four
    linears and the window attention's two products."""
    t = _padded(arch, tile)
    c, nf, cin = arch["embed_dim"], arch["num_feat"], arch["in_channels"]
    hidden = int(c * arch["mlp_ratio"])
    tokens = t * t
    per_layer = 2 * tokens * (3 * c * c + c * c + 2 * c * hidden) + 4 * tokens * arch["window_size"] ** 2 * c
    total = conv_flops(t, t, cin, c) + sum(arch["depths"]) * per_layer
    total += (len(arch["depths"]) + 1) * conv_flops(t, t, c, c) + conv_flops(t, t, c, nf)
    side = t
    for r in shuffle_stages(arch["scale"]):
        total += conv_flops(side, side, nf, r * r * nf)
        side *= r
    return total + conv_flops(side, side, nf, cin)


def attention_bytes(arch: dict, canvas: int) -> int:
    """The window attention's minimal traffic over a tiled canvas: q, k and
    v read once and o written once, in bf16, for every window of every tile
    in every Swin layer, and each layer's f32 bias table read once."""
    t = _padded(arch, arch["tile"])
    tokens = sr_tiles(arch, canvas) * t * t
    span = (2 * arch["window_size"] - 1) ** 2
    return sum(depth * (4 * tokens * arch["embed_dim"] * 2 + 4 * span * heads)
               for depth, heads in zip(arch["depths"], arch["num_heads"]))


def init(arch: dict, seed: int) -> dict:
    """Float32 arrays from ``seed`` in the npz layout ('/'-joined names,
    HWIO conv kernels, dense kernels [in, out], bias tables [(2w-1)^2, heads])."""
    rng = np.random.default_rng(seed)
    c, nf, cin, ws = arch["embed_dim"], arch["num_feat"], arch["in_channels"], arch["window_size"]
    hidden = int(c * arch["mlp_ratio"])
    out: dict[str, np.ndarray] = {}

    def conv_(name, ci, co):
        bound = 1.0 / math.sqrt(ci * 9)
        out[f"{name}/w"] = rng.uniform(-bound, bound, (3, 3, ci, co))
        out[f"{name}/b"] = rng.uniform(-bound, bound, (co,))

    def dense_(name, ci, co):
        out[f"{name}/w"] = np.clip(rng.normal(0.0, LINEAR_STD, (ci, co)), -2.0, 2.0)
        out[f"{name}/b"] = np.zeros(co)

    def norm_(name):
        out[f"{name}/scale"] = np.ones(c)
        out[f"{name}/bias"] = np.zeros(c)

    conv_("conv_first", cin, c)
    if arch["patch_norm"]:
        norm_("patch_norm")
    for i, (depth, heads) in enumerate(zip(arch["depths"], arch["num_heads"])):
        for j in range(depth):
            name = f"layers/{i}/blocks/{j}"
            norm_(f"{name}/norm1")
            dense_(f"{name}/attn/qkv", c, 3 * c)
            out[f"{name}/attn/relative_position_bias_table"] = np.clip(
                rng.normal(0.0, LINEAR_STD, ((2 * ws - 1) ** 2, heads)), -2.0, 2.0)
            dense_(f"{name}/attn/proj", c, c)
            norm_(f"{name}/norm2")
            dense_(f"{name}/mlp/fc1", c, hidden)
            dense_(f"{name}/mlp/fc2", hidden, c)
        conv_(f"layers/{i}/conv", c, c)
    norm_("norm")
    conv_("conv_after_body", c, c)
    conv_("conv_before_upsample", c, nf)
    for i, r in enumerate(shuffle_stages(arch["scale"])):
        conv_(f"upsample/{i}", nf, r * r * nf)
    conv_("conv_last", nf, cin)
    return {k: v.astype(np.float32) for k, v in out.items()}
