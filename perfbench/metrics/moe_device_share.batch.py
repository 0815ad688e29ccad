"""Device time of the work launched inside the MoE layer's calls, as a share of the window's device time, in the MoE throughput cell (layer: MoE)."""
from perfbench import readers


def read(run):
    return readers.span_share(run, "moe")
