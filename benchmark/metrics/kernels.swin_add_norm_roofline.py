"""kernels.swin_add_norm_roofline (layer: kernels; device trace): the Swin
layer's add-norm kernel's minimal bytes in the profiled steps at the card's
bandwidth, over the device time of the kernel's operations in those steps,
in %.

The bytes are counted here from the architecture's keys, over the tokens of
the canvas's tiles (not a padded chunk): each bf16 tensor of the residual
stream read once and written once, per launch form, and the LayerNorm's
affine (2 x C bf16) a launch. A Swin layer launches it twice: before the
attention (x and the previous layer's MLP output read, their sum and its
normalised copy written; the first layer of each residual block has no
operand and reads x and writes the copy alone) and after it (x and the proj
output read, the sum and its normalised copy written).

No reading where the window's program counter
``kernels.launches.swin_add_norm`` differs from two launches a Swin layer
and chunk of tiles in each of the window's tiled calls: a program that
skipped layers would otherwise read as fast, and a program without the
counter (one that predates the kernel) reads nothing."""

import math

from benchmark import flops
from benchmark.readers import roofline

KERNELS = ("swin_add_norm_kernel",)
COUNTER = "kernels.launches.swin_add_norm"


def add_norm_bytes(arch: dict, canvas: int) -> int:
    """The kernel's minimal traffic over a tiled ``canvas``, every Swin
    layer of every residual block, in bf16."""
    ws = arch["window_size"]
    side = -(-arch["tile"] // ws) * ws
    stream = flops.sr_tiles(arch, canvas) * side * side * arch["embed_dim"] * 2  # one tensor of the stream
    affine = 2 * arch["embed_dim"] * 2
    return sum((2 + 4 * (depth - 1) + 4 * depth) * stream + 2 * depth * affine for depth in arch["depths"])


def expected_launches(run) -> int:
    """Two launches a Swin layer and chunk of ``tile_batch`` tiles, in each
    tiled call the window counted (``sr_tiled_calls.<canvas>``)."""
    arch = run.config["arch"]
    total = 0
    for key, calls in run.counters.items():
        if key.startswith("sr_tiled_calls."):
            chunks = math.ceil(flops.sr_tiles(arch, int(key.rsplit(".", 1)[1])) / arch["tile_batch"])
            total += int(calls) * 2 * sum(arch["depths"]) * chunks
    return total


def read(run):
    launched = run.counters.get(COUNTER)
    if not launched or launched != expected_launches(run):
        return None
    arch = run.config["arch"]
    return roofline(run, KERNELS, lambda st: add_norm_bytes(arch, st.canvas))
