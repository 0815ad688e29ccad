"""Open-loop trace replay for the hedged serving stack.

The port of ``repro.serving.replay``: ``replay_virtual`` is the same
numpy event simulation, so on the same trace and seed it gives the JAX
module's results bit for bit.

A closed-loop driver (submit, wait, submit...) can never see the
queueing regime the paper's threshold load is ABOUT: its arrival rate
collapses to match service capacity, so overload shows up as client
slowness instead of queue growth. This module drives the serving policy
open loop — arrivals come from a pregenerated TRACE and never wait for
completions:

  * trace generators: ``poisson_trace`` (stationary), ``mmpp_trace``
    (two-state Markov-modulated bursts), ``diurnal_trace`` (piecewise
    load curve). All seeded and deterministic.
  * ``replay_virtual``: a discrete-event twin of
    ``BatchedHedgedService`` on a VIRTUAL clock — per-replica FIFO
    queues, k-fold dispatch with optional hedge delay, shed
    watermark, first-completion wins. No
    threads and no sleeping, so a million-request diurnal day replays
    in seconds and the run is bit-reproducible: service draws and
    replica picks are pre-drawn indexed by (request, copy) — the CRN
    contract that makes adaptive vs static comparisons paired (see the
    design note in ``repro_torch.serving.controller``).
  * ``replay_live``: paces the same trace onto a real
    ``BatchedHedgedService`` (threads, wall clock) for end-to-end
    smoke runs.

Model gap, documented: by default every issued copy is served to
completion at a single priority level — the engine's (and paper's)
model, so the controller's policy table and the replay agree on the
physics; ``cancel_queued=True`` / ``dup_low_priority=True`` opt into
the live service's loser-cancellation and §2.4 low-priority-duplicate
behaviors instead. The replay does not model token-level work or
transfer buffers; it is the queueing view of the service, one level
above ``queueing.run``'s single-queue view.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import time
from typing import Sequence

import numpy as np

from repro_torch.serving.metrics import TailSketch, _PCT_KEYS, _PCTS


@dataclasses.dataclass
class Trace:
    """An arrival trace: sorted times (seconds), per-request segment id,
    per-segment target offered load."""

    t: np.ndarray             # (N,) arrival times, non-decreasing
    segment: np.ndarray       # (N,) int segment index
    rho: np.ndarray           # (S,) per-segment offered load
    n_replicas: int
    mean_service_s: float
    kind: str = "trace"

    @property
    def n(self) -> int:
        return int(self.t.shape[0])

    @property
    def n_segments(self) -> int:
        return int(self.rho.shape[0])


def poisson_trace(n: int, rho: float, n_replicas: int,
                  mean_service_s: float = 1.0, seed: int = 0) -> Trace:
    """Stationary Poisson arrivals at offered load ``rho``."""
    rng = np.random.default_rng(seed)
    rate = float(rho) * n_replicas / mean_service_s
    t = np.cumsum(rng.exponential(1.0 / rate, size=n))
    return Trace(t=t, segment=np.zeros(n, dtype=np.int64),
                 rho=np.asarray([float(rho)]), n_replicas=int(n_replicas),
                 mean_service_s=float(mean_service_s), kind="poisson")


def mmpp_trace(n: int, rho_lo: float, rho_hi: float, n_replicas: int,
               mean_service_s: float = 1.0, sojourn_s: float = 50.0,
               seed: int = 0) -> Trace:
    """Two-state Markov-modulated Poisson process: the trace alternates
    between a calm state (``rho_lo``) and a burst state (``rho_hi``),
    with exponential sojourns of mean ``sojourn_s`` seconds. Segment id
    is the state (0=calm, 1=burst)."""
    rng = np.random.default_rng(seed)
    rates = (float(rho_lo) * n_replicas / mean_service_s,
             float(rho_hi) * n_replicas / mean_service_s)
    ts, segs = [], []
    t0, state = 0.0, 0
    remaining = n
    while remaining > 0:
        dur = rng.exponential(sojourn_s)
        # arrivals inside this sojourn
        gaps = rng.exponential(1.0 / rates[state],
                               size=max(int(rates[state] * dur * 1.5) + 8,
                                        8))
        tt = t0 + np.cumsum(gaps)
        tt = tt[tt < t0 + dur][:remaining]
        ts.append(tt)
        segs.append(np.full(tt.shape[0], state, dtype=np.int64))
        remaining -= tt.shape[0]
        t0 += dur
        state ^= 1
    t = np.concatenate(ts)
    return Trace(t=t, segment=np.concatenate(segs),
                 rho=np.asarray([float(rho_lo), float(rho_hi)]),
                 n_replicas=int(n_replicas),
                 mean_service_s=float(mean_service_s), kind="mmpp")


def diurnal_trace(n: int, rhos: Sequence[float] = (0.15, 0.45, 0.75, 0.15),
                  n_replicas: int = 8, mean_service_s: float = 1.0,
                  seed: int = 0) -> Trace:
    """Piecewise-stationary load curve — the paper's day: night (deep
    below threshold), morning (near the crossing), peak (well above),
    night again. Requests split evenly across segments; each segment is
    Poisson at its own rho."""
    rng = np.random.default_rng(seed)
    rhos = np.asarray([float(r) for r in rhos])
    per = np.full(len(rhos), n // len(rhos), dtype=np.int64)
    per[:n - int(per.sum())] += 1
    ts, segs = [], []
    t0 = 0.0
    for s, (rho, m) in enumerate(zip(rhos, per)):
        rate = rho * n_replicas / mean_service_s
        tt = t0 + np.cumsum(rng.exponential(1.0 / rate, size=int(m)))
        ts.append(tt)
        segs.append(np.full(int(m), s, dtype=np.int64))
        t0 = tt[-1] if m else t0
    return Trace(t=np.concatenate(ts), segment=np.concatenate(segs),
                 rho=rhos, n_replicas=int(n_replicas),
                 mean_service_s=float(mean_service_s), kind="diurnal")


@dataclasses.dataclass
class ReplayResult:
    """Per-request outcome arrays of one replay (all shape (N,))."""

    trace: Trace
    latency: np.ndarray       # first-completion latency, seconds
    k_planned: np.ndarray     # replication factor chosen at dispatch
    hedged: np.ndarray        # bool: duplicates actually issued
    shed: np.ndarray          # bool: duplicates shed by the watermark
    cancelled_queued: int     # queued loser copies never started
    loser_service: float      # seconds of redundant service burned
    controller: object = None

    def tails(self, segment: int | None = None,
              qs: Sequence[float] = _PCTS) -> np.ndarray:
        lat = (self.latency if segment is None
               else self.latency[self.trace.segment == segment])
        sk = TailSketch()
        sk.fold(lat)
        return sk.quantiles(qs)

    def segment_tails(self) -> list[dict]:
        rows = []
        for s in range(self.trace.n_segments):
            mask = self.trace.segment == s
            if not mask.any():
                continue
            qs = self.tails(segment=s)
            rows.append({"segment": s, "rho": float(self.trace.rho[s]),
                         "count": int(mask.sum()),
                         "hedged_frac": float(self.hedged[mask].mean()),
                         "k_mean": float(self.k_planned[mask].mean()),
                         **{k: float(v) for k, v in zip(_PCT_KEYS, qs)}})
        return rows

    def provenance(self) -> dict:
        qs = self.tails()
        out = {"n": self.trace.n, "kind": self.trace.kind,
               "hedged": int(self.hedged.sum()),
               "shed": int(self.shed.sum()),
               "cancelled_queued": int(self.cancelled_queued),
               "loser_service_s": float(self.loser_service),
               **{k: float(v) for k, v in zip(_PCT_KEYS, qs)}}
        if self.controller is not None:
            out["controller"] = self.controller.provenance()
        return out


_COMPLETE, _HEDGE = 0, 1


def replay_virtual(trace: Trace, *, controller=None, static_k: int = 1,
                   static_delay_s: float = 0.0, shed_watermark: float = 1.0,
                   seed: int = 0, k_max: int = 2,
                   svc_sampler=None,
                   cancel_queued: bool = False,
                   dup_low_priority: bool = False) -> ReplayResult:
    """Discrete-event replay of the hedged service on a virtual clock.

    ``controller`` (an ``AdaptiveController``) is consulted per arrival
    with the virtual time and instantaneous busy fraction; without one,
    the static (k, delay) knobs apply. Service times are drawn up front
    as an (N, k_max) table indexed by (request, copy) — identical
    draws for every policy over the same (trace, seed), so results are
    paired and bit-reproducible. ``svc_sampler(rng, shape)`` overrides
    the service distribution (default: exponential at the trace's mean
    service time); pass the numpy twin of whatever ``ServiceDist`` the
    policy table was swept with so the controller's predictions and
    the replay agree on the service law.

    The DEFAULT queueing model is the engine's (and the paper's): every
    issued copy is served to completion at one priority level — the
    model ``threshold.policy_table`` sweeps, so the controller's table
    predictions and the replay physics agree. The service's two
    mitigations are opt-in knobs: ``cancel_queued`` drops queued losers
    when their request completes, ``dup_low_priority`` queues
    duplicates behind all primaries (§2.4). Turning them on reproduces
    ``BatchedHedgedService``'s behavior and softens the high-load
    penalty of replication — useful for measuring exactly how much
    those mitigations buy.
    """
    n_rep = trace.n_replicas
    N = trace.n
    if controller is not None:
        k_max = max(k_max, int(np.max(controller.table.k)))
    k_max = min(max(int(k_max), int(static_k), 1), n_rep)
    rng = np.random.default_rng(seed)
    if svc_sampler is None:
        svc = rng.exponential(trace.mean_service_s, size=(N, k_max))
    else:
        svc = np.asarray(svc_sampler(rng, (N, k_max)), dtype=np.float64)
    upick = rng.random(size=(N, k_max))

    t_arr = trace.t
    lat = np.full(N, np.nan)
    k_planned = np.ones(N, dtype=np.int64)
    hedged = np.zeros(N, dtype=bool)
    shed = np.zeros(N, dtype=bool)
    done = np.zeros(N, dtype=bool)
    pending_hedge_k = {}          # rid -> k for a parked delayed hedge
    cancelled_queued = 0
    loser_service = 0.0           # duplicate service seconds STARTED

    # per-replica state: two-level FIFO (duplicates never delay
    # primaries), one running copy each
    hi = [collections.deque() for _ in range(n_rep)]
    lo = [collections.deque() for _ in range(n_rep)]
    running = [None] * n_rep      # rid of the running copy, or None
    busy = 0

    events: list = []             # (t, seq, kind, a, b)
    seq = 0

    def start_or_queue(r: int, rid: int, c: int, low: bool) -> None:
        nonlocal busy, seq, loser_service
        if running[r] is None:
            running[r] = rid
            busy += 1
            if c > 0:
                loser_service += svc[rid, c]
            seq += 1
            heapq.heappush(events,
                           (now + svc[rid, c], seq, _COMPLETE, r, rid))
        else:
            (lo if low else hi)[r].append((rid, c))

    def dispatch(rid: int, c: int, used: list, low: bool) -> None:
        cand = [r for r in range(n_rep) if r not in used] or \
            list(range(n_rep))
        r = cand[int(upick[rid, c] * len(cand))]
        used.append(r)
        start_or_queue(r, rid, c, low and dup_low_priority)

    used_by: dict[int, list] = {}
    ai = 0
    now = 0.0
    while ai < N or events:
        ta = t_arr[ai] if ai < N else np.inf
        if events and events[0][0] <= ta:
            now, _, kind, a, b = heapq.heappop(events)
            if kind == _COMPLETE:
                r, rid = a, b
                if not done[rid]:
                    done[rid] = True
                    lat[rid] = now - t_arr[rid]
                    used_by.pop(rid, None)
                    pending_hedge_k.pop(rid, None)
                # else: a loser ran to completion (no tied cancellation)
                # free the server, start the next live copy
                running[r] = None
                busy -= 1
                for q in (hi[r], lo[r]):
                    while q:
                        nrid, nc = q.popleft()
                        if cancel_queued and done[nrid]:
                            cancelled_queued += 1
                            continue
                        running[r] = nrid
                        busy += 1
                        if nc > 0:
                            loser_service += svc[nrid, nc]
                        seq += 1
                        heapq.heappush(events, (now + svc[nrid, nc], seq,
                                                _COMPLETE, r, nrid))
                        break
                    if running[r] is not None:
                        break
            else:  # _HEDGE
                rid = a
                k = pending_hedge_k.pop(rid, None)
                if k is None or done[rid]:
                    continue  # completed first: the delay saved the work
                hedged[rid] = True
                u = used_by.get(rid, [])
                for c in range(1, k):
                    dispatch(rid, c, u, low=True)
        else:
            rid = ai
            ai += 1
            now = ta
            if controller is not None:
                k, delay_s = controller.on_arrival(now,
                                                   busy_fraction=busy
                                                   / n_rep)
            else:
                k, delay_s = int(static_k), float(static_delay_s)
            k = min(max(k, 1), n_rep)
            if k > 1 and busy / n_rep >= shed_watermark:
                k = 1
                shed[rid] = True
            k_planned[rid] = k
            if controller is not None:
                controller.note_dispatch(k, now)
            u = used_by.setdefault(rid, [])
            dispatch(rid, 0, u, low=False)
            if k > 1:
                if delay_s <= 0.0:
                    hedged[rid] = True
                    for c in range(1, k):
                        dispatch(rid, c, u, low=True)
                else:
                    pending_hedge_k[rid] = k
                    seq += 1
                    heapq.heappush(events, (now + delay_s, seq, _HEDGE,
                                            rid, 0))

    return ReplayResult(trace=trace, latency=lat, k_planned=k_planned,
                        hedged=hedged, shed=shed,
                        cancelled_queued=cancelled_queued,
                        loser_service=loser_service, controller=controller)


def replay_live(service, trace: Trace, *, max_new_tokens: int = 2,
                time_scale: float = 1.0, prompt_len: int = 4,
                timeout_s: float = 60.0, vocab: int = 1000) -> list:
    """Pace ``trace`` onto a real ``BatchedHedgedService`` in wall time
    (compressed by ``time_scale``): submit each request at its trace
    time, never waiting for completions (open loop), then wait for all
    of them at the end. Returns the completed ``Request`` objects.
    Prompts are drawn from token ids below ``vocab`` (the JAX module's
    1000 by default, which a smoke model's vocabulary may not reach)."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, vocab, size=(trace.n, prompt_len),
                           endpoint=False).astype(np.int32)
    t0 = time.monotonic()
    reqs = []
    for i in range(trace.n):
        due = t0 + trace.t[i] * time_scale
        pause = due - time.monotonic()
        if pause > 0:
            time.sleep(pause)
        reqs.append(service.submit(prompts[i],
                                   max_new_tokens=max_new_tokens))
    deadline = time.monotonic() + timeout_s
    for r in reqs:
        if not r.done_event.wait(timeout=max(deadline - time.monotonic(),
                                             0.01)):
            raise TimeoutError(f"request {r.rid} unfinished in replay")
    return reqs
