"""kernels.window_attention_roofline (layer: kernels; device trace): the
window attention's minimal bytes in the profiled steps (the configuration's
reference module's ``attention_bytes``: q, k and v read once and o written
once, in bf16, for every window of every tile in every Swin layer, and each
layer's bias table) at the card's bandwidth, over the device time of the
kernel's operations in those steps, in %.

No reading where the window's program counter
``kernels.launches.window_attention`` differs from one launch a Swin layer
and chunk of tiles in each of the window's tiled calls: a program that
skipped layers would otherwise read as fast, and a program without the
counter (one that predates it) reads nothing."""

import math

from benchmark import flops
from benchmark.readers import roofline

KERNELS = ("window_attention_kernel",)
COUNTER = "kernels.launches.window_attention"


def expected_launches(run) -> int:
    """One launch a Swin layer and chunk of ``tile_batch`` tiles, in each
    tiled call the window counted (``sr_tiled_calls.<canvas>``)."""
    arch = run.config["arch"]
    total = 0
    for key, calls in run.counters.items():
        if key.startswith("sr_tiled_calls."):
            chunks = math.ceil(flops.sr_tiles(arch, int(key.rsplit(".", 1)[1])) / arch["tile_batch"])
            total += int(calls) * sum(arch["depths"]) * chunks
    return total


def read(run):
    attention_bytes = getattr(run.cell.reference, "attention_bytes", None)
    launched = run.counters.get(COUNTER)
    if attention_bytes is None or not launched or launched != expected_launches(run):
        return None
    arch = run.config["arch"]
    return roofline(run, KERNELS, lambda st: attention_bytes(arch, st.canvas))
