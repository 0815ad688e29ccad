"""Figure 4: client-side overhead vs threshold load. Paper: overhead shrinks
the threshold; overhead ~ mean service kills the mean benefit entirely;
variable distributions are more forgiving.

All three distributions share one fused engine call per overhead level
(``threshold_grid_batch``)."""
from __future__ import annotations

from repro_torch.bench.common import Row, timed
from repro_torch.core import analytic
from repro_torch.core import distributions as dists
from repro_torch.core import queueing, scenario as scn_mod, threshold
from repro_torch.kernels import dispatch

DISTS = (dists.deterministic(), dists.exponential(), dists.pareto(2.1))


def _overheads(smoke: bool):
    return (0.0, 0.3) if smoke else (0.0, 0.05, 0.15, 0.3, 0.6, 1.0)


def compute(smoke: bool = False, kernel: str = "auto", device="cuda"):
    """({overhead: thresholds of ``DISTS``}, {overhead: microseconds})."""
    n_arrivals = 4_000 if smoke else 40_000
    ths, us = {}, {}
    for c in _overheads(smoke):
        cfg = queueing.SimConfig(n_servers=20, n_arrivals=n_arrivals,
                                 client_overhead=c)
        ths[c], us[c] = timed(lambda cf=cfg: threshold.threshold_grid_batch(
            3, list(DISTS), cf, n_seeds=2, kernel=kernel, device=device))
    return ths, us


def run(smoke: bool = False, kernel: str = "auto", device="cuda") -> list[Row]:
    resolved = dispatch.resolve(kernel, device)
    ths, us = compute(smoke, kernel, device)
    rows: list[Row] = []
    for c in _overheads(smoke):
        prov = scn_mod.provenance(scn_mod.Scenario.paper_default(
            DISTS, ks=(1, 2), client_overhead=c))
        for dist, t in zip(DISTS, ths[c]):
            extra = ""
            if dist.name == "exponential":
                expect = analytic.exponential_threshold(overhead=c)
                extra = f";closed_form={expect:.3f}"
            rows.append((f"fig4/{dist.name}/c={c:g}", us[c] / len(DISTS),
                         f"threshold={t:.3f}{extra}", None, prov, resolved))
    return rows
