"""Figure 14: in-network replication of the first 8 packets of short flows
at strict low priority, on the k=6 fat-tree simulator.

The per-load rows compare raw FCT percentiles (numpy, on the host); the
closing ``fct_table`` row instead fits the headline load's short-flow
FCTs, before and after replication, into quantile tables (the fit of
``netsim.empirical_fct_dist``, on the loop's own runs) and reads the
tail gain off the fitted tables' ``exceedance``. No engine call: the
slot loop runs on the device as tensor operations, with no kernel of
its own."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.bench.common import Row, timed
from repro_torch.core import distributions, netsim

HEADLINE_LOAD = 0.25  # the paper's headline load


def configs(load: float, smoke: bool = False):
    """(baseline, replicated) ``NetConfig``s of one load."""
    base = netsim.NetConfig(n_flows=200 if smoke else 500, load=load,
                            replicate_first=0, elephant_frac=0.12,
                            elephant_pkts=400, seed=7)
    return base, dataclasses.replace(base, replicate_first=8)


def run(smoke: bool = False, device="cuda") -> list[Row]:
    rows: list[Row] = []
    for load in (HEADLINE_LOAD,) if smoke else (0.1, 0.25, 0.4, 0.6, 0.8):
        def work(cfgs=configs(load, smoke)):
            (f0, _, sh0, _), (f1, _, sh1, _) = (
                netsim.flow_completion_times(c, device=device) for c in cfgs)
            return f0[sh0], f1[sh1], f0[~sh0], f1[~sh1]

        (a, b, ea, eb), us = timed(work)
        mean_gain = (a.mean() - b.mean()) / a.mean() * 100
        p90_gain = (np.percentile(a, 90) - np.percentile(b, 90)) / \
            max(np.percentile(a, 90), 1) * 100
        p99_gain = (np.percentile(a, 99) - np.percentile(b, 99)) / \
            max(np.percentile(a, 99), 1) * 100
        eleph = (ea.mean() - eb.mean()) / ea.mean() * 100
        rows.append((f"fig14/load={load:g}", us,
                     f"short_mean_gain={mean_gain:.1f}%;"
                     f"p90_gain={p90_gain:.1f}%;p99_gain={p99_gain:.1f}%;"
                     f"elephant_delta={eleph:.2f}%"))
        if load == HEADLINE_LOAD:
            short_fcts = (a, b)

    # quantile-table tails at the headline load: P[FCT > p99_baseline]
    # before/after replication, read off the fitted EmpiricalDists
    (d0, d1), us = timed(lambda: tuple(
        distributions.empirical(f, n_quantiles=256, name="netsim_fct[short]")
        for f in short_fcts))
    x99 = float(np.quantile(np.asarray(d0.table, np.float64) * d0.scale, 0.99))
    rows.append(("fig14/fct_table", us,
                 f"knots={len(d0.table)};mean_slots={d0.scale:.1f};"
                 f"rep_mean_slots={d1.scale:.1f};"
                 f"exceed_p99_base={d0.exceedance(x99):.4f};"
                 f"exceed_p99_rep={d1.exceedance(x99):.4f}"))
    return rows
