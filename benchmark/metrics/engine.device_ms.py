"""engine.device_ms (layer: engine; program counter): the card's ms per
tiled SR call from the program's CUDA events (its start, to the end of its
fetch): the window's delta of ``engine.device_s.sr_tiled`` over that of
``sr_tiled_calls.*``."""

from benchmark.program_spans import per_call_ms


def read(run):
    return per_call_ms(run, "engine.device_s.sr_tiled")
