"""engine.step_ms (layer: engine; device trace): device ms per engine step,
the operations launched inside each step's label in the profiled seconds."""

from benchmark.readers import step_ms


def read(run):
    return step_ms(run)
