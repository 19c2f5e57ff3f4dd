"""model.step_mfu (layer: model; device trace): the canonical operations of
the images served in the profiled steps (benchmark/flops.py, from the
configuration's architecture) over those steps' device time, as a share of
the card's bf16 peak, in %."""

from benchmark.readers import step_mfu


def read(run):
    return step_mfu(run)
