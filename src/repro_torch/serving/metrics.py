"""Streaming serving telemetry on the engine's histogram geometry.

The port of ``repro.serving.metrics``, on the port's own sketch geometry
(``repro_torch.kernels.hist_sketch.ops``). It stays on the host: serving
telemetry is folded per request, and the JAX package folds it in numpy
too.

The serving layer needs tail percentiles over millions of requests
without keeping millions of floats sorted. ``TailSketch`` is a pure-
NUMPY mirror of the engine's ``hist_sketch`` geometry — the SAME
``HIST_LO`` / ``HIST_HI`` bounds, the same ``DEFAULT_BINS`` log-spaced
buckets, the same geometric-midpoint quantile read-out — so a latency
recorded by the live service and a response time summarized by
``queueing.run`` land in the same bucket grid and are directly
comparable (relative error <= half a log-bin width, ~0.5% at the
default 2048 bins over 8 decades). Nothing here launches device work:
the request hot path folds latencies with ``np.bincount``.

``Telemetry`` is the per-request record store the batched service
feeds: arrival / dispatch / first-completion / cancel timestamps plus
hedge and shed counts per request, folded as they complete into
windowed ``TailSketch``es (one sketch per ``window_s`` of arrival
time). ``json_rows()`` exports the windowed p50/p99/p999 trajectory as
JSON-ready provenance rows — the benchmark artifact's raw material.

Beneath those records hang the per-copy spans of the request's trace
(``RequestTrace``, ``CopySpan``, ``Span``), on the same request id, all
stamped on ``time.perf_counter()``'s clock and kept in memory: each copy's
wait in its replica's queue (``repro.queue``), its run (``repro.copy``),
and inside the engine each step split into the host's enqueue of its ops
(``repro.prefill``, ``repro.decode``) and the wait for its token
(``repro.prefill.sync``, ``repro.decode.sync``); the MoE layers' share of a
step's enqueue is the step's counter ``moe_ns``. The worker running a copy
makes its span current on its thread (``repro_torch.tracing``); the engine
and the model write to it, and do nothing on a thread without one. While a
``torch.profiler`` session records, each span on one thread also enters a
``record_function`` of its name, and each MoE call one named ``repro.moe``.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Iterable

import numpy as np

from repro_torch import tracing

# One geometry for engine sweeps and serving telemetry: these constants
# are owned by the hist_sketch kernel package.
from repro_torch.kernels.hist_sketch.ops import DEFAULT_BINS, HIST_HI, HIST_LO


class TailSketch:
    """Log-histogram percentile sketch (numpy twin of
    ``repro_torch.kernels.hist_sketch``).

    ``fold`` accepts scalars or arrays; values outside [lo, hi] clamp to
    the edge bins exactly as the kernel's ``bin_indices`` does.
    """

    def __init__(self, n_bins: int = DEFAULT_BINS, lo: float = HIST_LO,
                 hi: float = HIST_HI):
        if n_bins < 2 or not 0.0 < lo < hi:
            raise ValueError(f"bad sketch geometry ({n_bins=}, {lo=}, {hi=})")
        self.n_bins = int(n_bins)
        self.lo, self.hi = float(lo), float(hi)
        self._log_lo = np.log(self.lo)
        self._scale = (self.n_bins - 1) / (np.log(self.hi) - self._log_lo)
        self.counts = np.zeros(self.n_bins, dtype=np.int64)

    def fold(self, values) -> None:
        v = np.atleast_1d(np.asarray(values, dtype=np.float64))
        if v.size == 0:
            return
        if np.any(v <= 0.0) or not np.all(np.isfinite(v)):
            raise ValueError("TailSketch folds positive finite latencies")
        idx = ((np.log(v) - self._log_lo) * self._scale).astype(np.int64)
        np.clip(idx, 0, self.n_bins - 1, out=idx)
        self.counts += np.bincount(idx, minlength=self.n_bins)

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    def merge(self, other: "TailSketch") -> "TailSketch":
        if (other.n_bins, other.lo, other.hi) != (self.n_bins, self.lo,
                                                  self.hi):
            raise ValueError("cannot merge sketches of different geometry")
        self.counts += other.counts
        return self

    def quantile(self, q: float) -> float:
        return float(self.quantiles((q,))[0])

    def quantiles(self, qs: Iterable[float]) -> np.ndarray:
        """Geometric bin midpoints, the same read-out as the engine's
        ``sketch_quantiles`` (first bin where the cdf reaches q% of the
        mass). NaN when the sketch is empty."""
        qs = np.asarray(list(qs), dtype=np.float64)
        cdf = np.cumsum(self.counts)
        total = cdf[-1]
        if total == 0:
            return np.full(qs.shape, np.nan)
        targets = qs / 100.0 * total
        idx = np.searchsorted(cdf, targets, side="left")
        idx = np.minimum(idx, self.n_bins - 1)
        return np.exp(self._log_lo + (idx + 0.5) / self._scale)


@dataclasses.dataclass
class RequestRecord:
    """Per-request telemetry row. Timestamps are whatever clock the
    owner feeds (wall seconds for the live service, virtual seconds in
    trace replay); NaN marks events that have not happened."""

    rid: int
    t_arrival: float
    t_dispatch: float = float("nan")
    t_first_done: float = float("nan")
    t_cancel: float = float("nan")
    k_planned: int = 1
    hedged: bool = False
    shed: bool = False
    copies_started: int = 0
    copies_cancelled: int = 0
    completed_by: str = ""

    @property
    def latency(self) -> float:
        return self.t_first_done - self.t_arrival


_PCTS = (50.0, 99.0, 99.9)
_PCT_KEYS = ("p50", "p99", "p999")


class Telemetry:
    """Streaming per-request metrics for a serving run.

    Thread-safe. Completed latencies fold into one overall ``TailSketch``
    plus one sketch per ``window_s`` of ARRIVAL time (windowing by
    arrival keeps a window's population independent of how long its
    requests took — the open-loop view). ``json_rows()`` emits the
    windowed p50/p99/p999 trajectory; ``provenance()`` the run-level
    summary dict benchmarks attach to their JSON rows.
    """

    def __init__(self, window_s: float = 10.0, n_bins: int = DEFAULT_BINS,
                 lo: float = HIST_LO, hi: float = HIST_HI):
        self.window_s = float(window_s)
        self._geometry = (int(n_bins), float(lo), float(hi))
        self._lock = threading.Lock()
        self._records: dict[int, RequestRecord] = {}
        self._done: list[RequestRecord] = []
        self.overall = TailSketch(n_bins, lo, hi)
        self._windows: dict[int, TailSketch] = {}
        self._t0: float | None = None
        self.counters = {"arrivals": 0, "completions": 0, "hedged": 0,
                         "shed": 0, "cancelled_copies": 0, "timeouts": 0,
                         "failures": 0}

    # ------------------------------------------------------------------
    def note_arrival(self, rid: int, t: float, k_planned: int = 1) -> None:
        with self._lock:
            if self._t0 is None:
                self._t0 = t
            self._records[rid] = RequestRecord(rid=rid, t_arrival=t,
                                               k_planned=k_planned)
            self.counters["arrivals"] += 1

    def note_dispatch(self, rid: int, t: float, k_planned: int,
                      shed: bool = False) -> None:
        with self._lock:
            r = self._records.get(rid)
            if r is None:
                return
            r.t_dispatch = t
            r.k_planned = int(k_planned)
            r.copies_started += 1
            if shed and not r.shed:
                r.shed = True
                self.counters["shed"] += 1

    def note_hedge(self, rid: int, n_copies: int = 1) -> None:
        with self._lock:
            r = self._records.get(rid)
            if r is None:
                return
            r.copies_started += int(n_copies)
            if not r.hedged:
                r.hedged = True
                self.counters["hedged"] += 1

    def note_completion(self, rid: int, t: float,
                        completed_by: str = "") -> None:
        with self._lock:
            r = self._records.pop(rid, None)
            if r is None:
                return
            r.t_first_done = t
            r.completed_by = completed_by
            self._done.append(r)
            self.counters["completions"] += 1
            lat = r.latency
            if lat > 0.0 and np.isfinite(lat):
                self.overall.fold(lat)
                w = int((r.t_arrival - self._t0) // self.window_s)
                sk = self._windows.get(w)
                if sk is None:
                    sk = self._windows[w] = TailSketch(*self._geometry)
                sk.fold(lat)

    def note_cancel(self, rid: int, t: float, n_copies: int = 1,
                    timeout: bool = False) -> None:
        """Record loser cancellations. O(1): only LIVE records are
        annotated, so for a completing request this must be called
        BEFORE ``note_completion`` (the service does) — once a record
        is folded into the sketches it is immutable, and scanning the
        done list for it would serialize the completion path behind an
        O(n) walk."""
        with self._lock:
            r = self._records.get(rid)
            if r is not None:
                r.t_cancel = t
                r.copies_cancelled += int(n_copies)
            self.counters["cancelled_copies"] += int(n_copies)
            if timeout:
                self.counters["timeouts"] += 1

    def note_failure(self, rid: int, t: float) -> None:
        """Every copy of ``rid`` errored: there is no completion to
        fold, so drop the live record and count the failure."""
        with self._lock:
            self._records.pop(rid, None)
            self.counters["failures"] += 1

    # ------------------------------------------------------------------
    def records(self) -> list[RequestRecord]:
        with self._lock:
            return list(self._done)

    def latencies(self) -> np.ndarray:
        with self._lock:
            return np.asarray([r.latency for r in self._done])

    def tail(self, q: float) -> float:
        with self._lock:
            return self.overall.quantile(q)

    def json_rows(self) -> list[dict]:
        """One JSON-ready row per arrival window: count + p50/p99/p999
        from that window's sketch — the streaming latency trajectory."""
        with self._lock:
            rows = []
            for w in sorted(self._windows):
                sk = self._windows[w]
                qs = sk.quantiles(_PCTS)
                rows.append({"window": w,
                             "t_start": (self._t0 or 0.0)
                             + w * self.window_s,
                             "count": sk.count,
                             **{k: float(v)
                                for k, v in zip(_PCT_KEYS, qs)}})
            return rows

    def provenance(self) -> dict:
        with self._lock:
            qs = self.overall.quantiles(_PCTS)
            return {**self.counters,
                    "windows": len(self._windows),
                    "window_s": self.window_s,
                    **{k: float(v) for k, v in zip(_PCT_KEYS, qs)}}


# ---------------------------------------------------------------------------
# Per-copy spans of a request's trace
# ---------------------------------------------------------------------------

NAN = float("nan")


class Span:
    """One interval on ``time.perf_counter()``'s clock: its ``name``, the
    ``parent`` span that caused it (None: the request itself), and the
    ``counters`` made inside it. ``end`` is NaN while it is open."""

    __slots__ = ("name", "start", "end", "parent", "counters", "_rf")

    def __init__(self, name: str, start: float, parent: "Span | None" = None):
        self.name = name
        self.start = start
        self.end = NAN
        self.parent = parent
        self.counters: dict[str, int] = {}
        self._rf = None     # its ``record_function``, under a profiler

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def close(self, t: float) -> None:
        self.end = t
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None

    def to_json(self) -> dict:
        return {"name": self.name, "start": _num(self.start),
                "end": _num(self.end),
                "parent": None if self.parent is None else self.parent.name,
                **({"counters": dict(self.counters)} if self.counters
                   else {})}


def _num(x: float) -> float | None:
    return None if math.isnan(x) else x


class CopySpan(Span):
    """One copy of a request on one replica (``repro.copy``), created when
    the copy is queued: its ``queue`` span runs from then until its
    replica's worker takes it up (``begin``) or drops it unstarted
    (``drop``); ``spans`` are the engine's steps in order, each enqueue
    followed by its wait. ``outcome``: ``won``, ``lost`` (started, then
    beaten), ``cancelled`` (never started) or ``failed`` (raised);
    ``prompt_tokens`` prefilled and ``tokens`` computed. The spans opened
    on the worker's thread (the copy's run and its steps) also enter a
    ``record_function`` under a profiler; the queue span, opened on the
    submitter's thread, does not."""

    __slots__ = ("replica", "priority", "outcome", "queue", "spans",
                 "prompt_tokens", "tokens", "t_first_token", "_open",
                 "_sync")

    def __init__(self, replica: str, priority: int, t: float):
        super().__init__("repro.copy", NAN)
        self.replica = replica
        self.priority = priority
        self.outcome = ""
        self.queue = Span("repro.queue", t)
        self.spans: list[Span] = []
        self.prompt_tokens = 0
        self.tokens = 0
        self.t_first_token = NAN
        self._open: Span | None = None   # the step the host is enqueuing
        self._sync: Span | None = None   # the step's wait for its token

    # --- the replica's worker thread ---
    def begin(self) -> None:
        t = time.perf_counter()
        self.queue.close(t)
        self.start = t
        self._rf = tracing.record(self.name)
        tracing.set_current(self)

    def drop(self) -> None:
        self.queue.close(time.perf_counter())
        self.outcome = "cancelled"

    def finish(self, outcome: str) -> None:
        t = time.perf_counter()
        for s in (self._open, self._sync):   # the engine raised in a step
            if s is not None:
                s.close(t)
        self._open = self._sync = None
        self.close(t)
        self.outcome = outcome
        tracing.set_current(tracing.NO_COPY)

    # --- the engine, on the same thread ---
    def _step(self, name: str, t: float) -> Span:
        s = Span(name, t, self)
        s._rf = tracing.record(name)
        self.spans.append(s)
        return s

    def enqueue(self, name: str, prompt_tokens: int = 0) -> None:
        """Open a step: the host enqueues its ops until ``wait``."""
        self._open = self._step(name, time.perf_counter())
        self.prompt_tokens += prompt_tokens

    def wait(self) -> None:
        """Close the step's enqueue, open its wait for the card."""
        t = time.perf_counter()
        s, self._open = self._open, None
        s.close(t)
        self._sync = self._step(s.name + ".sync", t)

    def token(self) -> None:
        """Close the wait: the step's token is on the host."""
        t = time.perf_counter()
        self._sync.close(t)
        self._sync = None
        self.tokens += 1
        if math.isnan(self.t_first_token):
            self.t_first_token = t

    def to_json(self) -> dict:
        return {"replica": self.replica, "priority": self.priority,
                "outcome": self.outcome,
                "prompt_tokens": self.prompt_tokens, "tokens": self.tokens,
                "t_first_token": _num(self.t_first_token),
                "spans": [self.queue.to_json(), Span.to_json(self),
                          *(s.to_json() for s in self.spans)]}


@dataclasses.dataclass(eq=False)
class RequestTrace:
    """A request's trace: its own submit stamp, what the dispatcher decided
    for it (``k`` copies at the ``utilization`` it read, and whether it
    ``shed`` the duplicates), and one ``CopySpan`` per copy queued."""

    rid: int
    t_submit: float
    k: int = 1
    utilization: float = NAN
    shed: bool = False
    copies: list[CopySpan] = dataclasses.field(default_factory=list)

    def add_copy(self, replica: str, priority: int) -> CopySpan:
        c = CopySpan(replica, priority, time.perf_counter())
        self.copies.append(c)
        return c

    def to_json(self) -> dict:
        return {"rid": self.rid, "t_submit": self.t_submit, "k": self.k,
                "utilization": _num(self.utilization), "shed": self.shed,
                "copies": [c.to_json() for c in self.copies]}
