"""The benchmark's own count of the work a served image needs, from a
configuration's architecture keys alone: floating-point operations of the
canonical network (2 per multiply-add; each network's own count is its
reference module's ``tile_flops``) and the bytes of kernels' minimal
traffic (each input read once, each output written once).

A folded, fused or otherwise rearranged program reads the same work: the
counts come from the architecture, never from the program.
"""

from __future__ import annotations


def conv_flops(h: int, w: int, cin: int, cout: int, k: int = 3) -> int:
    """Operations of a SAME ``k`` x ``k`` convolution over an ``h`` x ``w``
    map, stride 1."""
    return 2 * h * w * cin * cout * k * k


def tile_starts(size: int, tile: int, stride: int) -> list[int]:
    if size <= tile:
        return [0]
    return list(dict.fromkeys(list(range(0, size - tile, stride)) + [size - tile]))


def sr_tiles(arch: dict, canvas: int) -> int:
    return len(tile_starts(canvas, arch["tile"], arch["tile"] - arch["overlap"])) ** 2


def blend_bytes(arch: dict, canvas: int) -> int:
    """The windowed overlap-add's minimal traffic: every f32 output tile
    read once and the f32 output canvas written once."""
    out_tile = arch["tile"] * arch["scale"]
    c = arch["in_channels"]
    return 4 * c * (sr_tiles(arch, canvas) * out_tile * out_tile + (canvas * arch["scale"]) ** 2)


def image_flops(cfg: dict, canvas: int, reference=None) -> int:
    """Operations of one served image of configuration ``cfg`` on a
    ``canvas``-square canvas. On the tiled SR surface: the network over each
    of the canvas's input tiles, by the ``tile_flops`` of the configuration's
    reference module (``reference``; by default the module its
    ``"reference"`` names in this benchmark). The blend is not counted."""
    if cfg["surface"] == "sr_tiled":
        if reference is None:
            from benchmark import spec

            reference = spec.load_reference(cfg["reference"])
        arch = cfg["arch"]
        return sr_tiles(arch, canvas) * reference.tile_flops(arch, arch["tile"])
    raise ValueError(f"no operation count for surface {cfg['surface']!r}")
