"""device.idle_share (layer: device; device trace): the share of the
profiled window in which no operation ran on the card, in %."""

from benchmark.readers import idle_share


def read(run):
    return idle_share(run)
