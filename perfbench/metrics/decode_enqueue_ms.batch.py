"""Mean host time enqueuing a decode step's ops, from the program's spans, in the throughput cells (layer: engine)."""
from perfbench import spans


def read(run):
    return spans.step_ms(run, "repro.decode")
