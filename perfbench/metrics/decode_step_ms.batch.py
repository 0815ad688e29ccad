"""Mean host time of a decode step of the engine, in the throughput cells (layer: engine)."""
from perfbench import readers


def read(run):
    return readers.decode_step_ms(run)
