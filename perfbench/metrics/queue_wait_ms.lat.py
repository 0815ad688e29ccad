"""Mean wait of a started copy in its replica's queue, from the program's spans, in the latency cell (layer: service)."""
from perfbench import spans


def read(run):
    return spans.queue_wait_ms(run)
