"""restorator.host_ms (layer: restorator; program span): the mean ms a job
spends in serve/restorator.py outside what it waits for (the batcher's
submit, or the engine's tiled call): decode, letterbox, prompt, crop, the
JPEG encode."""

from benchmark.readers import self_ms


def read(run):
    return self_ms(run, "restore", "wait")
