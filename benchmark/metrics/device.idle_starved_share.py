"""device.idle_starved_share (layer: device; device trace): the share of the
profiled window, in %, in which no operation runs on the card and no
``engine.call`` span of the program is open on any thread: idle caused by
the host's job work, as against idle inside the engine's own calls."""

from benchmark.program_spans import idle_starved_share


def read(run):
    return idle_starved_share(run)
