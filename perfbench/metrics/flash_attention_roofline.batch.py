"""The prefill attention calls' bound over the device time of the work they launched, in the throughput cells (layer: kernels)."""
from perfbench import readers


def read(run):
    return readers.attention_roofline(run, "attention")
