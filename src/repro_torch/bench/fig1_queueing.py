"""Figure 1: response time vs load, deterministic + Pareto(2.1) service,
k=1 vs k=2. Validates the thresholding effect and tail-dominant gains.

Both k values and all loads run in one fused ``queueing.sweep`` call per
distribution; percentiles come from the engine's streaming histogram
sketch (binned inside ``cell_update`` on the card)."""
from __future__ import annotations

from repro_torch.bench.common import Row, timed
from repro_torch.core import distributions as dists
from repro_torch.core import queueing, scenario as scn_mod
from repro_torch.kernels import dispatch

CFG = queueing.SimConfig(n_servers=20, n_arrivals=80_000)
LOADS = (0.1, 0.2, 0.3, 0.4, 0.45)
DISTS = (dists.deterministic(), dists.pareto(2.1))


def compute(smoke: bool = False, kernel: str = "auto", device="cuda"):
    """({dist name: sweep summaries}, {dist name: microseconds})."""
    cfg = queueing.SimConfig(n_servers=20, n_arrivals=4_000) if smoke else CFG
    outs, us = {}, {}
    for dist in DISTS:
        outs[dist.name], us[dist.name] = timed(
            lambda d=dist: queueing.sweep(0, d, LOADS, cfg, ks=(1, 2),
                                          n_seeds=1, kernel=kernel,
                                          device=device))
    return outs, us


def run(smoke: bool = False, kernel: str = "auto", device="cuda") -> list[Row]:
    rows: list[Row] = []
    resolved = dispatch.resolve(kernel, device)
    outs, us_by = compute(smoke, kernel, device)
    for dist in DISTS:
        out, us = outs[dist.name], us_by[dist.name]
        prov = scn_mod.provenance(
            scn_mod.Scenario.paper_default(dist, ks=(1, 2)))
        for i, rho in enumerate(LOADS):
            m1 = float(out["mean"][0, i, 0])
            m2 = float(out["mean"][0, i, 1])
            rows.append((f"fig1/{dist.name}/rho={rho:.2f}", us / 10,
                         f"mean_k1={m1:.3f};mean_k2={m2:.3f};"
                         f"gain={(m1 - m2) / m1 * 100:.1f}%",
                         None, prov, resolved))
        # paper: "reducing the 99.9th percentile by 5x under Pareto"
        t1 = float(out["p99.9"][0, 1, 0])
        t2 = float(out["p99.9"][0, 1, 1])
        rows.append((f"fig1/{dist.name}/p999@0.2", us / 10,
                     f"p999_k1={t1:.2f};p999_k2={t2:.2f};"
                     f"ratio={t1 / t2:.2f}x", None, prov, resolved))
    return rows
