"""Mean host time a decode step spent enqueuing its MoE layers, from the program's counters, in the MoE throughput cell (layer: MoE)."""
from perfbench import spans


def read(run):
    return spans.counter_ms(run, "repro.decode", "moe_ns")
