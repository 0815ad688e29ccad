"""Figure 3: thresholds of random unit-mean discrete service distributions
(uniform-simplex and Dirichlet(0.1) sampling). Paper: min observed threshold
stays above the deterministic ~0.26.

Each (support, sampler) cell draws 8 random distributions (probabilities
from numpy seeds ``100 * support + i``) and estimates all 8 thresholds in
ONE fused engine call via ``threshold_grid_batch``."""
from __future__ import annotations

import numpy as np

from repro_torch.bench.common import Row, timed
from repro_torch.core import distributions as dists
from repro_torch.core import queueing, scenario as scn_mod, threshold
from repro_torch.kernels import dispatch

CFG = queueing.SimConfig(n_servers=20, n_arrivals=40_000)
SAMPLERS = ((None, "uniform"), (0.1, "dirichlet0.1"))


def _cells(smoke: bool):
    """(support, Dirichlet alpha, label, draws) of each row."""
    return [(support, alpha, label, 3 if smoke else 8)
            for support in ((2, 10) if smoke else (2, 10, 100))
            for alpha, label in SAMPLERS]


def _batch(support: int, alpha, n_draws: int):
    return tuple(dists.random_discrete(support * 100 + i, support,
                                       dirichlet_alpha=alpha)
                 for i in range(n_draws))


def compute(smoke: bool = False, kernel: str = "auto", device="cuda"):
    """({(support, label): thresholds}, {(support, label): microseconds})."""
    cfg = queueing.SimConfig(n_servers=20, n_arrivals=4_000) if smoke else CFG
    rhos = np.linspace(0.1, 0.495, 14, dtype=np.float32)
    ths, us = {}, {}
    for support, alpha, label, n_draws in _cells(smoke):
        def work(support=support, alpha=alpha, n_draws=n_draws):
            return threshold.threshold_grid_batch(
                support * 100, _batch(support, alpha, n_draws), cfg,
                rhos=rhos, n_seeds=1, kernel=kernel, device=device)

        ths[support, label], us[support, label] = timed(work)
    return ths, us


def run(smoke: bool = False, kernel: str = "auto", device="cuda") -> list[Row]:
    resolved = dispatch.resolve(kernel, device)
    ths, us = compute(smoke, kernel, device)
    return [(f"fig3/N={support}/{label}", us[support, label],
             f"min={min(ths[support, label]):.3f};"
             f"max={max(ths[support, label]):.3f}", None,
             scn_mod.provenance(scn_mod.Scenario.paper_default(
                 _batch(support, alpha, n_draws), ks=(1, 2))), resolved)
            for support, alpha, label, n_draws in _cells(smoke)]
