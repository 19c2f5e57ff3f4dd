"""kernels.swin_mlp_roofline (layer: kernels; device trace): the Swin
layer's MLP kernel's least time in the profiled steps over the device time
of the kernel's operations in those steps, in %.

The least time of a step is the larger of two, counted here from the
architecture's keys over the tokens of the canvas's tiles (not a padded
chunk): the MLP's canonical operations, fc1 and fc2, 4 x tokens x C x hidden
a Swin layer, at the card's bf16 peak; and its minimal bytes, the tokens
read and m written once in bf16 a Swin layer, and both weights and biases
in bf16 once a launch, at the card's memory rate.

No reading where the window's program counter ``kernels.launches.swin_mlp``
differs from one launch a Swin layer and chunk of tiles in each of the
window's tiled calls: a program that skipped layers would otherwise read as
fast, and a program without the counter (one that predates the kernel)
reads nothing."""

import math

from benchmark import flops
from benchmark.readers import steps

KERNELS = ("swin_mlp_kernel",)
COUNTER = "kernels.launches.swin_mlp"


def _widths(arch: dict) -> tuple[int, int]:
    return arch["embed_dim"], int(arch["embed_dim"] * arch["mlp_ratio"])


def _tokens(arch: dict, canvas: int) -> int:
    ws = arch["window_size"]
    side = -(-arch["tile"] // ws) * ws
    return flops.sr_tiles(arch, canvas) * side * side


def _chunks(arch: dict, canvas: int) -> int:
    return math.ceil(flops.sr_tiles(arch, canvas) / arch["tile_batch"])


def mlp_flops(arch: dict, canvas: int) -> int:
    """fc1 and fc2 of every Swin layer over a tiled ``canvas``."""
    c, hidden = _widths(arch)
    return sum(arch["depths"]) * 4 * _tokens(arch, canvas) * c * hidden


def mlp_bytes(arch: dict, canvas: int) -> int:
    """The kernel's minimal traffic over a tiled ``canvas``, every Swin
    layer, in bf16: the tokens in and m out, and the weights a launch."""
    c, hidden = _widths(arch)
    weights = (2 * c * hidden + hidden + c) * 2
    return sum(arch["depths"]) * (2 * _tokens(arch, canvas) * c * 2 + _chunks(arch, canvas) * weights)


def expected_launches(run) -> int:
    """One launch a Swin layer and chunk of ``tile_batch`` tiles, in each
    tiled call the window counted (``sr_tiled_calls.<canvas>``)."""
    arch = run.config["arch"]
    return sum(int(calls) * sum(arch["depths"]) * _chunks(arch, int(key.rsplit(".", 1)[1]))
               for key, calls in run.counters.items() if key.startswith("sr_tiled_calls."))


def read(run):
    launched = run.counters.get(COUNTER)
    if not launched or launched != expected_launches(run):
        return None
    s = steps(run)
    if s is None:
        return None
    ns = sum(st.device_ns(k) for st in s for k in KERNELS)
    if ns == 0:
        return None
    arch = run.config["arch"]
    least = sum(max(mlp_flops(arch, st.canvas) / run.peaks["bf16_flops"],
                    mlp_bytes(arch, st.canvas) / run.peaks["hbm_bytes_per_s"]) for st in s)
    return 100.0 * least / (ns * 1e-9)
