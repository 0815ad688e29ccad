"""The decode attention calls' bound (the live cache's bytes) over the device time of the work they launched (layer: kernels)."""
from perfbench import readers


def read(run):
    return readers.attention_roofline(run, "attention.decode")
