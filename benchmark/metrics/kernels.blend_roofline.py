"""kernels.blend_roofline (layer: kernels; device trace): the windowed
overlap-add's bytes (every f32 output tile read once, the f32 output canvas
written once) at the card's bandwidth, over the blend kernel's device
time, in %."""

from benchmark import flops
from benchmark.readers import roofline

KERNELS = ("blend_tiles_kernel",)


def read(run):
    arch = run.config["arch"]
    return roofline(run, KERNELS, lambda st: flops.blend_bytes(arch, st.canvas))
