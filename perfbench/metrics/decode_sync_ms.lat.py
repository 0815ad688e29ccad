"""Mean wait of a decode step for its token on the card, from the program's spans, in the latency cell (layer: engine)."""
from perfbench import spans


def read(run):
    return spans.step_ms(run, "repro.decode.sync")
