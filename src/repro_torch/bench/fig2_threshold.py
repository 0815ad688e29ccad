"""Figure 2: threshold load vs variance for Pareto / Weibull / two-point
families. Paper: thresholds rise with variance, bounded in (~0.26, 0.5).

All 15 families run through ONE fused sweep-engine call
(``threshold_grid_batch`` stacks them along the engine's seed axis)."""
from __future__ import annotations

from repro_torch.bench.common import Row, timed
from repro_torch.core import distributions as dists
from repro_torch.core import queueing, scenario as scn_mod, threshold
from repro_torch.kernels import dispatch

CFG = queueing.SimConfig(n_servers=20, n_arrivals=50_000)

FAMILIES = {
    "pareto": [(a, dists.pareto(a)) for a in (6.0, 3.0, 2.5, 2.2, 2.05)],
    "weibull": [(k, dists.weibull(k)) for k in (2.0, 1.0, 0.7, 0.5, 0.4)],
    "two_point": [(p, dists.two_point(p))
                  for p in (0.1, 0.5, 0.8, 0.95, 0.99)],
}
ENTRIES = [(fam, x, dist) for fam, fam_entries in FAMILIES.items()
           for x, dist in fam_entries]


def compute(smoke: bool = False, kernel: str = "auto", device="cuda"):
    """(one threshold per entry of ``ENTRIES``, microseconds)."""
    cfg = queueing.SimConfig(n_servers=20, n_arrivals=4_000) if smoke else CFG
    return timed(lambda: threshold.threshold_grid_batch(
        1, [dist for _, _, dist in ENTRIES], cfg, n_seeds=2, kernel=kernel,
        device=device))


def run(smoke: bool = False, kernel: str = "auto", device="cuda") -> list[Row]:
    resolved = dispatch.resolve(kernel, device)
    ths, us = compute(smoke, kernel, device)
    prov = scn_mod.provenance(scn_mod.Scenario.paper_default(
        tuple(dist for _, _, dist in ENTRIES), ks=(1, 2)))
    rows: list[Row] = []
    for (fam, x, dist), t in zip(ENTRIES, ths):
        var = "inf" if dist.variance is None else f"{dist.variance:.2f}"
        rows.append((f"fig2/{fam}/x={x:g}", us / len(ENTRIES),
                     f"threshold={t:.3f};variance={var}",
                     None, prov, resolved))
    return rows
