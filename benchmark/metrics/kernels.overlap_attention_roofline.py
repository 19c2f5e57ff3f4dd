"""kernels.overlap_attention_roofline (layer: kernels; device trace): HAT's
overlap attention kernel's least time in the profiled steps over the device
time of the kernel's operations in those steps, in %.

The least time of a step is the larger of two, counted here from the
architecture's keys over the tokens of the canvas's tiles (not a padded
chunk): the OCABs' canonical operations, QK^T and PV, 4 x tokens x
overlap window^2 x C an OCAB (the key window is ``window_size x (1 +
overlap_ratio)`` square), at the card's bf16 peak; and their minimal
bytes, q, k and v read once and o written once in bf16 an OCAB, and its f32
bias table, at the card's memory rate.

No reading where the window's program counter
``kernels.launches.overlap_attention`` differs from one launch an OCAB (one
a residual group) and chunk of tiles in each of the window's tiled calls: a
program that skipped blocks would otherwise read as fast, and a program
without the counter (one that predates the kernel) reads nothing."""

import math

from benchmark import flops
from benchmark.readers import steps

KERNELS = ("overlap_attention_kernel",)
COUNTER = "kernels.launches.overlap_attention"


def _tokens(arch: dict, canvas: int) -> int:
    ws = arch["window_size"]
    side = -(-arch["tile"] // ws) * ws
    return flops.sr_tiles(arch, canvas) * side * side


def _overlap(arch: dict) -> int:
    ws = arch["window_size"]
    return int(arch["overlap_ratio"] * ws) + ws


def overlap_flops(arch: dict, canvas: int) -> int:
    """QK^T and PV of every OCAB over a tiled ``canvas``."""
    return len(arch["depths"]) * 4 * _tokens(arch, canvas) * _overlap(arch) ** 2 * arch["embed_dim"]


def overlap_bytes(arch: dict, canvas: int) -> int:
    """The kernel's minimal traffic over a tiled ``canvas``, every OCAB: q,
    k, v in and o out in bf16, and the f32 bias table."""
    span = (arch["window_size"] + _overlap(arch) - 1) ** 2
    return sum(4 * _tokens(arch, canvas) * arch["embed_dim"] * 2 + 4 * span * heads for heads in arch["num_heads"])


def expected_launches(run) -> int:
    """One launch a residual group and chunk of ``tile_batch`` tiles, in
    each tiled call the window counted (``sr_tiled_calls.<canvas>``)."""
    arch = run.config["arch"]
    total = 0
    for key, calls in run.counters.items():
        if key.startswith("sr_tiled_calls."):
            chunks = math.ceil(flops.sr_tiles(arch, int(key.rsplit(".", 1)[1])) / arch["tile_batch"])
            total += int(calls) * len(arch["depths"]) * chunks
    return total


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
    least = sum(max(overlap_flops(arch, st.canvas) / run.peaks["bf16_flops"],
                    overlap_bytes(arch, st.canvas) / run.peaks["hbm_bytes_per_s"]) for st in s)
    return 100.0 * least / (ns * 1e-9)
