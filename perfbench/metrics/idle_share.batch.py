"""Share of the traced window in which the card ran nothing, in the throughput cells (layer: device)."""
from perfbench import readers


def read(run):
    return readers.idle_share(run)
