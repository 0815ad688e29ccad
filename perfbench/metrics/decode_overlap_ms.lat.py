"""Mean time a decode step's host enqueue overlaps the other replica's enqueues, from the program's spans, in the latency cell (layer: engine)."""
from perfbench import spans


def read(run):
    return spans.decode_overlap_ms(run)
