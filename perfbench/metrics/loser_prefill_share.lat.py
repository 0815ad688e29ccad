"""Share of the prompt tokens prefilled by copies that lost to their sibling, from the program's counters, in the latency cell (layer: service)."""
from perfbench import spans


def read(run):
    return spans.loser_prefill_share(run)
