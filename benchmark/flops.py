"""The benchmark's own count of the work a served image needs, from a
configuration's architecture keys alone: floating-point operations of the
canonical network (2 per multiply-add) and the bytes of kernels' minimal
traffic (each input read once, each output written once).

A folded, fused or otherwise rearranged program reads the same work: the
counts come from the architecture, never from the program.
"""

from __future__ import annotations


def _conv(h: int, w: int, cin: int, cout: int, k: int = 3) -> int:
    return 2 * h * w * cin * cout * k * k


def tile_starts(size: int, tile: int, stride: int) -> list[int]:
    if size <= tile:
        return [0]
    return list(dict.fromkeys(list(range(0, size - tile, stride)) + [size - tile]))


def sr_tiles(arch: dict, canvas: int) -> int:
    return len(tile_starts(canvas, arch["tile"], arch["tile"] - arch["overlap"])) ** 2


def srnet_flops_tile(arch: dict, tile: int) -> int:
    c, s = arch["channels"], arch["scale"]
    total = _conv(tile, tile, arch["in_channels"], c)
    total += arch["num_blocks"] * 2 * _conv(tile, tile, c, c)
    total += _conv(tile, tile, c, c)
    total += _conv(tile, tile, c, arch["in_channels"] * s * s)
    return total


def sr_flops(arch: dict, canvas: int) -> int:
    """Operations of one tiled upscale of a ``canvas``-square canvas: SRNet
    over each of its input tiles (the limiter and blend are not counted)."""
    return sr_tiles(arch, canvas) * srnet_flops_tile(arch, arch["tile"])


def blend_bytes(arch: dict, canvas: int) -> int:
    """The windowed overlap-add's minimal traffic: every f32 output tile
    read once and the f32 output canvas written once."""
    out_tile = arch["tile"] * arch["scale"]
    c = arch["in_channels"]
    return 4 * c * (sr_tiles(arch, canvas) * out_tile * out_tile + (canvas * arch["scale"]) ** 2)


def image_flops(cfg: dict, canvas: int) -> int:
    """Operations of one served image of configuration ``cfg`` on a
    ``canvas``-square canvas."""
    if cfg["surface"] == "sr_tiled":
        return sr_flops(cfg["arch"], canvas)
    raise ValueError(f"no operation count for surface {cfg['surface']!r}")
