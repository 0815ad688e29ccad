"""Threshold-load estimation (paper §2.1), for ANY scenario.

The threshold load is "the largest utilization below which replication always
helps mean response time". The paper's results: 1/3 for exponential service
(Theorem 1), ~25.82% for deterministic service (conjectured global worst
case), approaching 50% for sufficiently heavy-tailed service.

Every estimator takes EITHER a bare ``ServiceDist`` — estimated under the
paper's model, with ``client_overhead``/``warmup_frac`` read from the
``SimConfig`` — or a ``repro_torch.core.scenario.Scenario`` whose policy /
service model / mix / overhead define the comparison; its ``ks`` are
overridden to ``(1, k)``. All of them drive ``queueing.run`` (batched over
seeds x loads x k, so one call serves a whole load grid) and take its
``chunk_size``, ``mesh``, ``kernel`` and ``device`` knobs. ``mesh=None``
is NOT "no mesh": it defers to ``run``'s ambient resolution
(``repro_torch.launch.mesh.resolve_mesh`` — a ``use_sweep_mesh`` context
or the default of a multi-process run), so the estimators run sharded
without mesh plumbing of their own, with the unsharded bits:

  * ``threshold_bisect`` — SPECULATIVE bisection on the sign of the
    CRN-paired gain mean_k1(rho) - mean_k(rho): each engine call
    evaluates the midpoint AND both possible next midpoints, so two
    levels resolve per call.
  * ``threshold_grid`` — ONE sweep over the whole load grid + crossing
    interpolation.
  * ``threshold_grid_batch`` — many distributions in ONE engine call
    (stacked along the seed axis); the Figure 2/3 path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.queueing import SimConfig, run
from repro_torch.core.scenario import Policy, Scenario


def _paired_gain(mean: torch.Tensor) -> np.ndarray:
    """(S, B, 2) sweep means -> (B,) seed-averaged CRN-paired gain."""
    return (mean[:, :, 0] - mean[:, :, 1]).mean(dim=0).cpu().numpy()


def _as_scenario(dist_or_scenario, cfg: SimConfig, k: int) -> Scenario:
    """Normalize an estimator's target to a ``Scenario`` at ks=(1, k).
    Multi-``dists`` scenarios are rejected (use ``threshold_grid_batch``)."""
    if isinstance(dist_or_scenario, Scenario):
        if dist_or_scenario.n_dists > 1:
            raise ValueError(
                "this estimator takes a single-dist Scenario (got "
                f"{dist_or_scenario.n_dists} dists); use "
                "threshold_grid_batch for multi-dist scenarios")
        return dataclasses.replace(dist_or_scenario, ks=(1, int(k)))
    return Scenario.paper_default(dist_or_scenario, ks=(1, int(k)),
                                  client_overhead=cfg.client_overhead,
                                  warmup_frac=cfg.warmup_frac)


def scenario_gain(seed: int, dist_or_scenario, rhos, cfg: SimConfig, *,
                  k: int = 2, n_seeds: int = 2,
                  chunk_size: int | None = None, mesh=None,
                  kernel: str = "auto", device="cuda") -> np.ndarray:
    """(B,) seed-averaged CRN-paired gain mean_k1(rho) - mean_k(rho) under
    the scenario's policy / service model (positive = replication helps).

    A SEQUENCE of single-dist Scenarios compares many SYSTEMS in one
    mixed-grid engine call: the paired columns interleave on the variant
    axis and the result is ``(B, n_scenarios)``."""
    kw = dict(n_seeds=n_seeds, percentiles=(), chunk_size=chunk_size,
              mesh=mesh, kernel=kernel, device=device)
    if (not isinstance(dist_or_scenario, Scenario)
            and isinstance(dist_or_scenario, (list, tuple))
            and all(isinstance(s, Scenario) for s in dist_or_scenario)):
        scns = tuple(_as_scenario(s, cfg, k) for s in dist_or_scenario)
        m = run(seed, scns, rhos, cfg, **kw)["mean"]  # (S, B, 2 * n)
        return (m[:, :, 0::2] - m[:, :, 1::2]).mean(dim=0).cpu().numpy()
    scn = _as_scenario(dist_or_scenario, cfg, k)
    return _paired_gain(run(seed, scn, rhos, cfg, **kw)["mean"])


def threshold_bisect(seed: int, dist_or_scenario, cfg: SimConfig, *,
                     k: int = 2, lo: float = 0.02, hi: float = 0.499,
                     iters: int = 10, n_seeds: int = 3,
                     chunk_size: int | None = None, mesh=None,
                     kernel: str = "auto", device="cuda") -> float:
    """Speculative bisection on the CRN-paired replication gain.

    Assumes the gain changes sign once on [lo, hi]. Returns the estimated
    crossing point; ``hi`` if replication helps on the whole interval.
    Each engine call evaluates the midpoint plus the two candidate next
    midpoints (the quarter points): the midpoint's sign picks the
    surviving half, whose quarter point resolves a second level. ``iters``
    counts bisection LEVELS; an odd last level probes its midpoint alone.
    Call ``i`` draws from its own run seed, derived from ``seed``.
    """
    scn = _as_scenario(dist_or_scenario, cfg, k)
    kw = dict(n_seeds=n_seeds, percentiles=(), chunk_size=chunk_size,
              mesh=mesh, kernel=kernel, device=device)
    seeds = [int(s) for s in np.random.SeedSequence(seed).generate_state(
        iters + 1, np.uint32)]
    bracket = run(seeds[-1], scn, [lo, hi], cfg, **kw)
    g_lo, g_hi = (float(g) for g in _paired_gain(bracket["mean"]))
    if g_hi > 0.0:
        return hi
    if g_lo < 0.0:
        return lo
    a, b = lo, hi
    level = call = 0
    while level < iters:
        mid = 0.5 * (a + b)
        if level + 1 < iters:
            probes = [0.5 * (a + mid), mid, 0.5 * (mid + b)]
            out = run(seeds[call], scn, probes, cfg, **kw)
            g_q_lo, g_mid, g_q_hi = (float(g)
                                     for g in _paired_gain(out["mean"]))
            if g_mid > 0.0:
                a, g_next, nxt = mid, g_q_hi, probes[2]
            else:
                b, g_next, nxt = mid, g_q_lo, probes[0]
            if g_next > 0.0:
                a = nxt
            else:
                b = nxt
            level += 2
        else:
            out = run(seeds[call], scn, [mid], cfg, **kw)
            if float(_paired_gain(out["mean"])[0]) > 0.0:
                a = mid
            else:
                b = mid
            level += 1
        call += 1
    return 0.5 * (a + b)


def policy_table(seed: int, dist_or_scenario, cfg: SimConfig, *,
                 rhos=None, ks: tuple[int, ...] = (1, 2),
                 delays: tuple[float, ...] = (0.0, 0.5, 1.0, 2.0),
                 percentile: float = 99.0, n_seeds: int = 2,
                 chunk_size: int | None = None, mesh=None,
                 kernel: str = "auto", device="cuda") -> dict:
    """Precompute a (rho x k x hedge-delay) policy table in ONE mixed-grid
    ``queueing.run`` sweep — what an adaptive serving controller reads.

    ``k=1`` is the bare no-replication baseline, and each ``k > 1`` fans
    out over ``delays`` as ``HEDGE_AFTER_DELAY`` variants (``delay=0`` is
    the paper's immediate ``REPLICATE_ALL``). Returns numpy arrays:
    ``rhos`` (B,), ``k`` (V,), ``delay`` (V,), ``tail`` (B, V)
    seed-averaged p``percentile``, ``mean`` (B, V), and ``percentile``."""
    rhos = (np.linspace(0.05, 0.75, 8, dtype=np.float32) if rhos is None
            else np.asarray(rhos, dtype=np.float32))
    base = _as_scenario(dist_or_scenario, cfg, 2)
    scns, entries = [], []
    for k in ks:
        k = int(k)
        if k < 1:
            raise ValueError(f"policy_table ks must be >= 1, got {k}")
        if k == 1:
            scns.append(dataclasses.replace(
                base, ks=(1,), policy=Policy.REPLICATE_ALL, delay=0.0))
            entries.append((1, 0.0))
        else:
            for d in delays:
                scns.append(dataclasses.replace(
                    base, ks=(k,), policy=Policy.HEDGE_AFTER_DELAY,
                    delay=float(d)))
                entries.append((k, float(d)))
    out = run(seed, scns, rhos, cfg, n_seeds=n_seeds,
              percentiles=(float(percentile),), chunk_size=chunk_size,
              mesh=mesh, kernel=kernel, device=device)
    tail = out[f"p{float(percentile):g}"].mean(dim=0).cpu().numpy()
    mean = out["mean"].mean(dim=0).cpu().numpy()
    return {"rhos": rhos.astype(np.float64),
            "k": np.asarray([e[0] for e in entries], dtype=np.int64),
            "delay": np.asarray([e[1] for e in entries], dtype=np.float64),
            "tail": tail.astype(np.float64),
            "mean": mean.astype(np.float64),
            "percentile": float(percentile)}


def crossing_load(rhos, g) -> float:
    """Threshold load from a sampled gain curve: linear interpolation of
    the first sign change of ``g(rho)`` (``rhos[-1]`` if replication helps
    everywhere sampled, ``rhos[0]`` if it never helps)."""
    rhos = np.asarray(rhos, dtype=np.float64)
    g = np.asarray(g, dtype=np.float64)
    neg = np.nonzero(g < 0.0)[0]
    if neg.size == 0:
        return float(rhos[-1])
    i = int(neg[0])
    if i == 0:
        return float(rhos[0])
    x0, x1, y0, y1 = rhos[i - 1], rhos[i], g[i - 1], g[i]
    return float(x0 + (x1 - x0) * y0 / (y0 - y1))


def default_rhos() -> np.ndarray:
    """The estimators' default load grid: 24 loads on [0.05, 0.495]."""
    return np.linspace(0.05, 0.495, 24, dtype=np.float32)


def threshold_grid(seed: int, dist_or_scenario, cfg: SimConfig, *,
                   k: int = 2, rhos=None, n_seeds: int = 2,
                   chunk_size: int | None = None, mesh=None,
                   kernel: str = "auto", device="cuda") -> float:
    """ONE sweep over the load grid + crossing interpolation."""
    rhos = default_rhos() if rhos is None else np.asarray(rhos, np.float32)
    g = scenario_gain(seed, dist_or_scenario, rhos, cfg, k=k,
                      n_seeds=n_seeds, chunk_size=chunk_size, mesh=mesh,
                      kernel=kernel, device=device)
    return crossing_load(rhos, g)


def threshold_grid_batch(seed: int, dists_or_scenario, cfg: SimConfig, *,
                         k: int = 2, rhos=None, n_seeds: int = 2,
                         chunk_size: int | None = None, mesh=None,
                         kernel: str = "auto",
                         device="cuda") -> list[float]:
    """Thresholds for MANY distributions from a single engine call
    (distributions stack along the engine's seed axis and share its
    arrival streams). Accepts a list of distributions (paper model) or
    one multi-``dists`` ``Scenario``; returns one threshold per dist."""
    rhos = default_rhos() if rhos is None else np.asarray(rhos, np.float32)
    if isinstance(dists_or_scenario, Scenario):
        scn = dataclasses.replace(dists_or_scenario, ks=(1, int(k)))
    else:
        dist_tuple = tuple(dists_or_scenario)
        scn = dataclasses.replace(_as_scenario(dist_tuple[0], cfg, k),
                                  dists=dist_tuple)
    m = run(seed, scn, rhos, cfg, n_seeds=n_seeds, percentiles=(),
            chunk_size=chunk_size, mesh=mesh, kernel=kernel,
            device=device)["mean"]
    if m.ndim == 3:
        m = m[None]                                  # (D, S, B, 2)
    g = (m[..., 0] - m[..., 1]).mean(dim=1).cpu().numpy()  # (D, B)
    return [crossing_load(rhos, g[d]) for d in range(g.shape[0])]
