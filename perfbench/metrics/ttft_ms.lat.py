"""Mean time from a request's submit to its winning copy's first token, from the program's spans, in the latency cell (layer: engine)."""
from perfbench import spans


def read(run):
    return spans.ttft_ms(run)
