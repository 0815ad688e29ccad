"""Model FLOPs of the requests finished in the window over its length, as a share of the bf16 peak, in the throughput cells (layer: model step)."""
from perfbench import readers


def read(run):
    return readers.mfu(run)
