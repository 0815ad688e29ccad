"""Online replication control from precomputed engine sweeps.

The port of ``repro.serving.controller``: the table comes from the port's
``repro_torch.core.threshold.policy_table`` (``cell_update`` on the card)
and the load signal from its ``core.hedging.LoadTracker``.

Closed-loop serving — design note
---------------------------------

The paper's help/hurt boundary moves with load (§2.1: the threshold
load) and with the service distribution, so a FIXED replication factor
is wrong somewhere on any diurnal load curve. Shah et al. and Joshi et
al. (PAPERS.md) sharpen this: the right policy must be chosen from the
measured operating point. This module closes that loop: the sweep
engine *precomputes* the whole operating surface offline, and a pure-
numpy controller *interpolates* it online.

Policy-table contract
    ``threshold.policy_table`` runs ONE mixed-grid ``queueing.run``
    sweep over a (rho x k x hedge-delay) grid: variant 0 is the bare
    k=1 baseline, the rest are ``HEDGE_AFTER_DELAY`` at each candidate
    delay (delay 0 degenerates bit-identically to the paper's immediate
    replicate-all). Every column shares the engine's CRN draws, so the
    per-rho ranking is a paired comparison. ``PolicyTable`` wraps the
    resulting numpy arrays; ``predict_tail(rho)`` linearly interpolates
    each variant's tail column between grid loads (clamped at the grid
    edges), and ``best(rho)`` is the argmin variant. Everything at
    serve time is numpy on ~(B x V) arrays — there is NO device work
    on the request hot path; the engine ran once, offline, in the sweep.

    Units: the engine's clock is mean service times. The controller
    converts with the replicas' measured/known mean service seconds:
    offered load rho = arrival_rate * mean_service_s / n_replicas, and
    a table delay d becomes ``d * mean_service_s`` seconds of hedge
    timer.

Window semantics
    The load estimate is FEED-FORWARD: offered load comes from a
    sliding window of arrival timestamps (``LoadTracker.arrival_rate``,
    amortized O(1)), which the controller's own hedging cannot inflate
    — duplicating requests changes utilization, not the arrival
    process. Utilization still matters as a capacity guard: a stalled
    or lost replica shrinks effective capacity without changing
    arrivals, so the estimate is

        rho_hat = max(offered_load, busy_fraction / k_eff)

    where ``k_eff`` is the windowed copies-per-request actually
    dispatched (``LoadTracker.copies_per_request``) and the busy
    fraction is SAMPLED AT ARRIVALS and averaged over the decision
    stride — by PASTA an unbiased time average, where a single
    instantaneous snapshot of a small pool (say 6 of 8 replicas busy
    in a Poisson burst at light load) is noisy enough to flip the
    policy on its own. Dividing by k_eff
    removes the controller's own replication from the busy signal —
    without it, hedging at mid load would read as high load, step k
    down, read low again, and flap. With it, the busy term only
    dominates when capacity is genuinely impaired (the chaos segment in
    ``repro_torch.examples.serve_hedged``: a stalled replica pins a worker, busy
    rises, k steps down).

Hysteresis semantics
    ``decide`` switches from the current variant to the table argmin
    only when the predicted tail improves by at least ``hysteresis``
    (relative): near-ties — where sweep noise, sketch resolution and
    estimator jitter live — never cause flapping, while a genuine
    regime change (the diurnal peak) clears the margin in one decision.
    Decisions are taken every ``decision_stride`` arrivals, so decision
    cost amortizes to a deque append per request.

CRN seeding of the replay
    The trace replay (``repro_torch.serving.replay``) that exercises this
    controller is deterministic end to end: arrival traces, per-request
    service draws and replica picks are all pre-drawn from
    ``np.random.default_rng`` children of one seed, and a request's
    draws are indexed by (request id, copy index) — NOT by dispatch
    order. Adaptive and static runs over the same trace therefore see
    identical service times for the same (request, copy), the serving
    twin of the engine's common-random-numbers contract, which makes
    adaptive-vs-static tail comparisons paired and the same-seed replay
    bit-reproducible.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Mapping

import numpy as np

from repro_torch.core.hedging import LoadTracker


class PolicyTable:
    """Pure-numpy view of a ``threshold.policy_table`` sweep."""

    def __init__(self, rhos, k, delay, tail, mean=None,
                 percentile: float = 99.0):
        self.rhos = np.asarray(rhos, dtype=np.float64)
        self.k = np.asarray(k, dtype=np.int64)
        self.delay = np.asarray(delay, dtype=np.float64)
        self.tail = np.asarray(tail, dtype=np.float64)
        self.mean = (np.asarray(mean, dtype=np.float64)
                     if mean is not None else None)
        self.percentile = float(percentile)
        b, v = self.tail.shape
        if (self.rhos.shape != (b,) or self.k.shape != (v,)
                or self.delay.shape != (v,)):
            raise ValueError(
                f"inconsistent table shapes: rhos {self.rhos.shape}, "
                f"k {self.k.shape}, delay {self.delay.shape}, "
                f"tail {self.tail.shape}")
        if b < 1 or np.any(np.diff(self.rhos) <= 0):
            raise ValueError("policy-table rhos must be increasing")

    @classmethod
    def from_sweep(cls, table: Mapping) -> "PolicyTable":
        """Wrap the dict returned by ``threshold.policy_table``."""
        return cls(table["rhos"], table["k"], table["delay"],
                   table["tail"], table.get("mean"),
                   table.get("percentile", 99.0))

    @property
    def n_variants(self) -> int:
        return self.tail.shape[1]

    def entry(self, v: int) -> tuple[int, float]:
        """(k, delay-in-service-units) of variant ``v``."""
        return int(self.k[v]), float(self.delay[v])

    def predict_tail(self, rho: float) -> np.ndarray:
        """(V,) predicted tail at ``rho``: per-variant linear
        interpolation between grid loads, clamped at the edges."""
        rho = float(np.clip(rho, self.rhos[0], self.rhos[-1]))
        i = int(np.searchsorted(self.rhos, rho, side="right")) - 1
        i = min(max(i, 0), len(self.rhos) - 2) if len(self.rhos) > 1 else 0
        if len(self.rhos) == 1:
            return self.tail[0].copy()
        x0, x1 = self.rhos[i], self.rhos[i + 1]
        w = (rho - x0) / (x1 - x0)
        return (1.0 - w) * self.tail[i] + w * self.tail[i + 1]

    def best(self, rho: float) -> int:
        return int(np.argmin(self.predict_tail(rho)))

    def to_json(self) -> dict:
        return {"rhos": self.rhos.tolist(), "k": self.k.tolist(),
                "delay": self.delay.tolist(), "tail": self.tail.tolist(),
                "percentile": self.percentile}


@dataclasses.dataclass
class Decision:
    t: float
    rho_hat: float
    variant: int
    k: int
    delay: float          # engine units (mean service times)
    switched: bool


class AdaptiveController:
    """Set (k, hedge delay) live from a ``PolicyTable`` and a measured
    operating point. Thread-safe; serve-time cost is a deque append per
    arrival plus one small numpy interpolation per ``decision_stride``
    arrivals. See the module design note for the load-estimate and
    hysteresis semantics."""

    def __init__(self, table: PolicyTable, n_replicas: int,
                 mean_service_s: float = 1.0, *,
                 tracker: LoadTracker | None = None,
                 window_s: float | None = None,
                 hysteresis: float = 0.15,
                 decision_stride: int = 32,
                 initial_rho: float = 0.0):
        if not 0.0 <= float(hysteresis) < 1.0:
            raise ValueError(f"hysteresis must be in [0, 1), "
                             f"got {hysteresis}")
        self.table = table
        self.n_replicas = int(n_replicas)
        self.mean_service_s = float(mean_service_s)
        if window_s is None:
            # ~100 mean service times: long enough to average Poisson
            # noise, short enough to track a diurnal segment change
            # within a few hundred arrivals.
            window_s = 100.0 * self.mean_service_s
        self.tracker = tracker or LoadTracker(n_replicas,
                                              window_s=float(window_s))
        self.hysteresis = float(hysteresis)
        self.decision_stride = max(int(decision_stride), 1)
        self._lock = threading.Lock()
        self._since_decision = 0
        self._busy_sum = 0.0
        self._busy_n = 0
        self._variant = table.best(float(initial_rho))
        self.history: list[Decision] = []
        self.switches = 0
        self.decisions = 0

    # ------------------------------------------------------------------
    @property
    def current_variant(self) -> int:
        with self._lock:
            return self._variant

    def current(self) -> tuple[int, float]:
        """(k, hedge_delay_SECONDS) of the current operating point."""
        k, d = self.table.entry(self.current_variant)
        return min(k, self.n_replicas), d * self.mean_service_s

    def load_estimate(self, t: float | None = None,
                      busy_fraction: float | None = None) -> float:
        """rho_hat = max(offered load, busy / k_eff) — see design note.
        ``busy_fraction`` defaults to the stride-averaged arrival
        samples (unbiased time average by PASTA); a single snapshot of
        an 8-replica pool is far too noisy to switch policies on."""
        offered = (self.tracker.arrival_rate(t) * self.mean_service_s
                   / max(self.n_replicas, 1))
        if busy_fraction is None:
            with self._lock:
                if self._busy_n:
                    busy_fraction = self._busy_sum / self._busy_n
                    self._busy_sum = 0.0
                    self._busy_n = 0
            if busy_fraction is None:
                busy_fraction = self.tracker.utilization()
        k_eff = self.tracker.copies_per_request(t)
        return max(offered, float(busy_fraction) / k_eff)

    def on_arrival(self, t: float | None = None,
                   busy_fraction: float | None = None) -> tuple[int, float]:
        """Hot-path entry: note the arrival, sample the busy fraction,
        re-decide every ``decision_stride`` arrivals, return
        (k, hedge_delay_s)."""
        self.tracker.note_arrival(t)
        if busy_fraction is None:
            busy_fraction = self.tracker.utilization()
        with self._lock:
            self._busy_sum += float(busy_fraction)
            self._busy_n += 1
            self._since_decision += 1
            due = self._since_decision >= self.decision_stride
            if due:
                self._since_decision = 0
        if due:
            self.decide(t)
        return self.current()

    def note_dispatch(self, n_copies: int, t: float | None = None) -> None:
        self.tracker.note_copies(n_copies, t)

    def decide(self, t: float | None = None,
               busy_fraction: float | None = None) -> tuple[int, float]:
        """Force a decision now (normally driven by ``on_arrival``)."""
        rho_hat = self.load_estimate(t, busy_fraction)
        pred = self.table.predict_tail(rho_hat)
        with self._lock:
            cur = self._variant
            cand = int(np.argmin(pred))
            switched = (cand != cur and
                        pred[cand] < (1.0 - self.hysteresis) * pred[cur])
            if switched:
                self._variant = cand
                self.switches += 1
            self.decisions += 1
            k, d = self.table.entry(self._variant)
            self.history.append(Decision(
                t=float(t) if t is not None else float("nan"),
                rho_hat=float(rho_hat), variant=self._variant,
                k=k, delay=d, switched=switched))
        return self.current()

    def provenance(self) -> dict:
        with self._lock:
            ks = [h.k for h in self.history]
            return {"decisions": self.decisions,
                    "switches": self.switches,
                    "variant": self._variant,
                    "k_min": min(ks) if ks else None,
                    "k_max": max(ks) if ks else None,
                    "hysteresis": self.hysteresis,
                    "window_s": self.tracker.window_s,
                    "percentile": self.table.percentile}
