"""engine.fetch_ms (layer: engine; program counter): the card's ms per tiled
SR call in the fetch, the one device-to-host copy of the packed output
(CUDA events after the pack and after the copy): the window's delta of
``engine.fetch_s.sr_tiled`` over that of ``sr_tiled_calls.*``."""

from benchmark.program_spans import per_call_ms


def read(run):
    return per_call_ms(run, "engine.fetch_s.sr_tiled")
