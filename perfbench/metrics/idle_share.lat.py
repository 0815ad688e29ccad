"""Share of the traced window in which the card ran nothing, in the latency cell (layer: device)."""
from perfbench import readers


def read(run):
    return readers.idle_share(run)
