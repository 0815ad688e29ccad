"""End-to-end hedged serving: open-loop trace replay, adaptive vs static.

Three rows:

  * ``serving/policy_table`` — the ONE mixed-grid ``queueing.run``
    sweep (``threshold.policy_table``, ``cell_update`` on the card) that
    precomputes the (rho x k x hedge-delay) operating surface the online
    controller interpolates.
  * ``serving/adaptive_vs_static`` — a seeded diurnal trace (night /
    morning / peak / night) replayed open loop through the virtual
    service twin, once per static k in {1, 2} and once with the
    ``AdaptiveController``; per-segment p99/p999 plus the acceptance
    booleans (adaptive no worse than the best static k at EVERY
    segment, strictly better on at least one) land in the row's
    provenance dict. All three runs share the trace and the (request,
    copy)-indexed service draws — paired comparisons (CRN).
  * ``serving/batched_live`` — a short wall-clock replay through the
    real ``BatchedHedgedService`` (threads, pooled transfer buffers,
    group dispatcher) with streaming ``Telemetry``.

Open-loop replay: arrivals never wait for completions, so the replay
sees the queueing regimes a closed loop (submit, wait, repeat) cannot.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.common import Row, timed
from repro_torch.core import distributions as dists
from repro_torch.core import queueing, threshold
from repro_torch.kernels import dispatch
from repro_torch.serving import replay
from repro_torch.serving.controller import AdaptiveController, PolicyTable
from repro_torch.serving.engine import SimulatedEngine
from repro_torch.serving.metrics import Telemetry
from repro_torch.serving.service import BatchedHedgedService

N_REPLICAS = 8
# the diurnal day, in offered load: night / morning / peak / night.
# Morning sits at 0.30 — inside the band where the TABLE's winner is a
# DELAYED hedge, a policy neither static k can express, so the
# adaptive run beats both statics there structurally.
SEGMENTS = (0.15, 0.30, 0.75, 0.15)
# service law: the paper's Fig 2(c) two-point family — 0.5 w.p. p,
# 5.5 w.p. 1-p (unit mean). Heavy enough that DELAYED hedging is the
# structural winner at mid load (hedge only the stragglers).
SERVICE_P = 0.9
SERVICE_HI = (1.0 - 0.5 * SERVICE_P) / (1.0 - SERVICE_P)
# relative slack on the per-segment no-worse booleans: the replay and
# the table share physics but not randomness, and p99 reads from
# log-histogram buckets (~0.5% wide); 5% absorbs both without masking
# a real regression (wrong-k penalties are 2-10x, not 5%)
REL_TOL = 1.05

TABLE_RHOS = (0.05, 0.15, 0.25, 0.35, 0.45, 0.55, 0.65, 0.8)
TABLE_DELAYS = (0.0, 0.5, 1.0, 2.0)   # 0.0 = the paper's immediate k=2
TABLE_ARRIVALS = 40_000
N_VIRTUAL = 1_000_000                 # adaptive_vs_static, full size
N_LIVE = 400                          # batched_live, full size


def two_point_sampler(rng, shape):
    """Numpy twin of ``dists.two_point(SERVICE_P)`` for the replay."""
    return np.where(rng.random(shape) < SERVICE_P, 0.5, SERVICE_HI)


def policy_table_sweep(smoke: bool, seed: int = 0, kernel: str = "auto",
                       device="cuda") -> dict:
    """The mixed-grid engine sweep behind the controller's table."""
    cfg = queueing.SimConfig(n_servers=N_REPLICAS,
                             n_arrivals=3_000 if smoke else TABLE_ARRIVALS)
    return threshold.policy_table(
        seed, dists.two_point(SERVICE_P), cfg, rhos=list(TABLE_RHOS),
        ks=(1, 2), delays=TABLE_DELAYS, percentile=99.0, n_seeds=2,
        kernel=kernel, device=device)


def build_policy_table(smoke: bool, seed: int = 0, kernel: str = "auto",
                       device="cuda") -> tuple[PolicyTable, float]:
    """One mixed-grid engine sweep -> PolicyTable (timed)."""
    d, us = timed(lambda: policy_table_sweep(smoke, seed, kernel, device))
    return PolicyTable.from_sweep(d), us


def _segment_p99s(res: replay.ReplayResult) -> np.ndarray:
    return np.asarray([res.tails(segment=s)[1]
                       for s in range(res.trace.n_segments)])


def adaptive_vs_static(table: PolicyTable, n_requests: int,
                       seed: int = 0) -> dict:
    """Replay the diurnal trace once per policy; paired by CRN."""
    trace = replay.diurnal_trace(n_requests, rhos=SEGMENTS,
                                 n_replicas=N_REPLICAS, seed=seed)
    static = {}
    for k in (1, 2):
        static[k] = replay.replay_virtual(trace, static_k=k, seed=seed + 1,
                                          svc_sampler=two_point_sampler)
    ctl = AdaptiveController(table, N_REPLICAS, mean_service_s=1.0,
                             window_s=40.0, hysteresis=0.1,
                             decision_stride=16, initial_rho=SEGMENTS[0])
    adaptive = replay.replay_virtual(trace, controller=ctl, seed=seed + 1,
                                     svc_sampler=two_point_sampler)

    p99 = {f"k{k}": _segment_p99s(r) for k, r in static.items()}
    p99["adaptive"] = _segment_p99s(adaptive)
    best_static = np.minimum(p99["k1"], p99["k2"])
    no_worse = bool(np.all(p99["adaptive"] <= REL_TOL * best_static))
    strictly_better = bool(np.any(p99["adaptive"] < best_static))
    return {
        "n_requests": int(n_requests),
        "segments": adaptive.segment_tails(),
        "static_segments": {f"k{k}": r.segment_tails()
                            for k, r in static.items()},
        "p99_per_segment": {k: [float(x) for x in v]
                            for k, v in p99.items()},
        "rel_tol": REL_TOL,
        "adaptive_no_worse": no_worse,
        "adaptive_strictly_better": strictly_better,
        "controller": ctl.provenance(),
        "replay": adaptive.provenance(),
    }


def _sampler(seed: int):
    rng = np.random.default_rng(seed)

    def sample():
        # ~4 ms typical, 60 ms tail 15% of the time (cache miss / GC)
        if rng.random() < 0.15:
            return 0.06
        return 0.004 * (0.5 + rng.random())

    return sample


def batched_live(n_requests: int, seed: int = 3) -> dict:
    """Wall-clock smoke of the real batched service on a Poisson trace
    compressed to ~10 ms mean service."""
    mean_s = 0.0124  # mean of _sampler's mixture
    trace = replay.poisson_trace(n_requests, rho=0.2, n_replicas=4,
                                 mean_service_s=mean_s, seed=seed)
    engines = [SimulatedEngine(_sampler(seed + i), name=f"s{i}")
               for i in range(4)]
    svc = BatchedHedgedService(engines, batch_sizes=(1, 4), max_seq=8,
                               k=2, telemetry=Telemetry(window_s=0.25),
                               seed=seed)
    try:
        replay.replay_live(svc, trace, max_new_tokens=2)
    finally:
        svc.shutdown()
    return svc.telemetry.provenance()


def run(smoke: bool = False, kernel: str = "auto",
        device="cuda") -> list[Row]:
    rows: list[Row] = []
    resolved = dispatch.resolve(kernel, device)
    table, table_us = build_policy_table(smoke, kernel=kernel,
                                         device=device)
    lo, hi = table.best(0.1), table.best(0.75)
    rows.append((
        "serving/policy_table", table_us,
        f"grid={len(table.rhos)}x{table.n_variants};"
        f"best@0.10=k{table.k[lo]}d{table.delay[lo]:g};"
        f"best@0.75=k{table.k[hi]}d{table.delay[hi]:g}",
        None, table.to_json(), resolved))

    n_requests = 20_000 if smoke else N_VIRTUAL
    cmp, cmp_us = timed(lambda: adaptive_vs_static(table, n_requests))
    rows.append((
        "serving/adaptive_vs_static", cmp_us / n_requests,
        f"n={n_requests};"
        f"no_worse={cmp['adaptive_no_worse']};"
        f"strictly_better={cmp['adaptive_strictly_better']};"
        f"adaptive_p99=" + "/".join(
            f"{x:.2f}" for x in cmp["p99_per_segment"]["adaptive"]),
        None, cmp))

    n_live = 60 if smoke else N_LIVE
    live, live_us = timed(lambda: batched_live(n_live))
    rows.append((
        "serving/batched_live", live_us / n_live,
        f"n={n_live};completions={live['completions']};"
        f"hedged={live['hedged']};p99_ms={live['p99'] * 1e3:.1f}",
        None, live))
    return rows
