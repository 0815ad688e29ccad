"""Figures 15-17: replicated DNS as engine coordinates. Each replication
level k=1..10 is fitted once into a unit-mean quantile-table
``EmpiricalDist`` (``dns.empirical_k_dists`` — the fit of the min over
the top-k ranked servers, preserving the shared-component correlation),
and ALL TEN ride ONE heterogeneous ``queueing.run`` mixed grid as
single-variant scenarios (``ks=(1,)`` — the replication min is already
baked into each fit, so "k" is purely the ``dist_id`` coordinate).

Tail-fraction reductions (Fig 15) read straight off the fitted quantile
tables via ``EmpiricalDist.exceedance``; mean / p99 reductions vs k
(Fig 16) come from the engine summaries x each fit's ``.scale``;
marginal cost-effectiveness vs the 16 ms/KB benchmark (Fig 17) from the
fitted means."""
from __future__ import annotations

import numpy as np

from repro_torch.bench.common import Row, timed
from repro_torch.core import analytic, dns, queueing, scenario as scn_mod
from repro_torch.core.scenario import Scenario
from repro_torch.kernels import dispatch

KS = tuple(range(1, 11))


def _n_samples(smoke: bool) -> int:
    return 20_000 if smoke else 400_000


def compute(smoke: bool = False, kernel: str = "auto", device="cuda",
            mesh=None):
    """({"fits": one EmpiricalDist per k, "summaries": the run's
    summaries}, microseconds of fits and run)."""
    pop = dns.DNSPopulation()

    def work():
        fits = dns.empirical_k_dists(6, pop, KS, n_samples=_n_samples(smoke),
                                     device=device)
        # one mixed grid, ten systems: scenario k's cells route to fit k
        # via dist_id; rho ~ 0 approximates the paper's open-loop
        # (elastic-resource) measurement.
        scns = tuple(Scenario(dists=f, ks=(1,)) for f in fits)
        cfg = queueing.SimConfig(n_servers=10,
                                 n_arrivals=4_000 if smoke else 40_000)
        s = queueing.run(7, scns, (0.05,), cfg, n_seeds=1, mesh=mesh,
                         kernel=kernel, device=device)
        return {"fits": fits, "summaries": s}

    return timed(work)


def run(smoke: bool = False, kernel: str = "auto", device="cuda",
        mesh=None) -> list[Row]:
    rows: list[Row] = []
    pop = dns.DNSPopulation()
    resolved = dispatch.resolve(kernel, device)
    mesh_shape = mesh.shape if mesh is not None else None
    n = _n_samples(smoke)
    out, us = compute(smoke, kernel, device, mesh)
    fits, s = out["fits"], out["summaries"]
    means = [float(s["mean"][0, 0, i]) * fits[i].scale
             for i in range(len(KS))]  # ms, one per k: variant i == fit i
    p99s = [float(s["p99"][0, 0, i]) * fits[i].scale for i in range(len(KS))]

    def tail_ratio(i: int, cutoff_ms: float) -> str:
        # When the replicated fit has NO sampled mass above the cutoff,
        # the true ratio is unbounded; report a lower bound at the fit's
        # resolution (one sample in n) instead of an epsilon artifact.
        num, den = fits[0].exceedance(cutoff_ms), fits[i].exceedance(cutoff_ms)
        if den < 1.0 / n:
            return f">={num * n:.0f}x"
        return f"{num / den:.1f}x"

    for k in (2, 5, 10):
        i = k - 1
        mean_red = (means[0] - means[i]) / means[0] * 100
        p99_red = (p99s[0] - p99s[i]) / p99s[0] * 100
        rows.append((f"fig15/k={k}", us / 10,
                     f"frac500_reduction={tail_ratio(i, 500.0)};"
                     f"frac1500_reduction={tail_ratio(i, 1500.0)};"
                     f"mean_reduction={mean_red:.0f}%;"
                     f"p99_reduction={p99_red:.0f}%",
                     mesh_shape, scn_mod.provenance(Scenario(dists=fits[i],
                                                       ks=(1,))),
                     resolved))
    # fig17: marginal savings straight off the fitted per-k means (each
    # fit's scale IS its mean in ms)
    marg = dns.marginal_savings_ms_per_kb(
        np.asarray([f.scale for f in fits]), pop)
    total_kb = 9 * pop.query_bytes / 1024.0
    abs_ms_per_kb = (fits[0].scale - fits[-1].scale) / total_kb
    rows.append(("fig17/marginal", us / 10,
                 f"k2_ms_per_kb={float(marg[0]):.0f};"
                 f"k10_ms_per_kb={float(marg[-1]):.1f};"
                 f"absolute_k10={abs_ms_per_kb:.1f};"
                 f"benchmark={analytic.BENEFIT_THRESHOLD_MS_PER_KB}"))
    return rows
