"""engine.queue_ms (layer: engine; program span): the mean ms a tiled SR
call waits for the engine's run lock, from the program's ``engine.queue``
spans under each ``sr_tiled`` ``engine.call``."""

from benchmark.program_spans import queue_ms


def read(run):
    return queue_ms(run)
