"""Hedged request scheduler — the paper's technique as a serving feature.

A copy of the JAX package's ``repro.serving.scheduler`` on the port's
``core.hedging`` and ``serving.engine``; ``estimate_hedge_delay`` runs
the port's engine (``core.threshold.policy_table``).

Each replica runs a worker thread draining a two-level priority queue
(strict: duplicates never delay primaries — the §2.4 mechanism one layer
up). For every incoming request the scheduler:

  1. asks the ``HedgePolicy`` for k given the ``LoadMeter``'s utilization
     (k=1 above the threshold load — "judicious redundancy", §5);
  2. enqueues the primary at HIGH priority on one replica; the k-1
     duplicates go to distinct other replicas at LOW priority — either
     immediately (``hedge_delay=0``, the paper's model) or only after
     ``hedge_delay`` seconds without a completion (Dean & Barroso's
     hedged requests — the serving analogue of the engine's
     ``HEDGE_AFTER_DELAY`` policy, with the delay chosen from engine
     sweeps via ``estimate_hedge_delay``);
  3. returns the first completion; queued (not yet started) losers are
     cancelled, and optionally running ones too (tied requests, off by
     default to match the paper's no-cancellation model).

Robustness knobs (the fault-masking story):

  * ``retry=RetryPolicy(...)`` switches a request to the NON-redundant
    baseline: one copy, resent with exponential backoff when a deadline
    passes — the strawman ``fig_fault_masking`` compares hedging
    against.
  * ``shed_watermark``: above this instantaneous utilization the
    scheduler sheds duplicates (k -> 1) regardless of the hedge policy
    — graceful degradation so redundancy never tips an overloaded
    system over (§2.1's regime change, enforced at runtime).
  * per-request deadlines (``timeout=``) cancel all outstanding copies
    and raise ``TimeoutError``.
  * ``remove_replica`` requeues the departing worker's pending copies
    on the survivors, so elastic shrink (or a chaos kill) loses no
    queued work.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from typing import Any, Sequence

import numpy as np

from repro_torch.core.hedging import HedgePolicy, LoadMeter, LoadTracker
from repro_torch.serving.engine import Request

PRIORITY_HIGH = 0
PRIORITY_LOW = 1


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Timeout-retry baseline: resend after ``deadline`` seconds,
    multiplying the deadline by ``backoff`` per attempt, at most
    ``max_retries`` resends (the serving twin of the engine's
    ``TIMEOUT_RETRY`` policy code and its capped backoff offsets)."""

    deadline: float
    backoff: float = 2.0
    max_retries: int = 1

    def __post_init__(self):
        if self.deadline <= 0 or self.backoff < 1 or self.max_retries < 0:
            raise ValueError(f"bad RetryPolicy {self}")


class _Copy:
    __slots__ = ("req", "priority", "cancelled", "started")

    def __init__(self, req: Request, priority: int):
        self.req = req
        self.priority = priority
        self.cancelled = False
        self.started = False


class ReplicaWorker:
    """One replica's drain thread. ``scheduler`` is any owner exposing
    ``tied_cancel`` (bool) and ``tracker`` (``LoadTracker`` busy
    accounting, updated as copies start/finish so ``utilization()`` is
    an O(1) read); an owner may additionally define
    ``_on_copy_done(worker, copy, won)`` to observe completions — the
    batched service of the JAX package (``repro.serving.service``, not
    ported yet) finalizes requests there instead of blocking a submitter
    thread per request."""

    def __init__(self, engine, scheduler: "HedgedScheduler", name: str):
        self.engine = engine
        self.scheduler = scheduler
        self.name = name
        self._heap: list = []
        self._counter = itertools.count()
        self._cv = threading.Condition()
        self._stop = False
        self._busy = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"worker-{name}")
        self._thread.start()

    def submit(self, copy: _Copy) -> None:
        with self._cv:
            heapq.heappush(self._heap, (copy.priority, next(self._counter),
                                        copy))
            self._cv.notify()

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._heap) + (1 if self._busy else 0)

    def is_busy(self) -> bool:
        with self._cv:
            return self._busy

    def stop(self) -> list[_Copy]:
        """Idempotent. Returns the drained, never-started queue entries
        so the scheduler can requeue them on surviving replicas."""
        with self._cv:
            pending = [c for _, _, c in self._heap]
            self._heap.clear()
            already = self._stop
            self._stop = True
            self._cv.notify_all()
        if not already and self._thread.is_alive():
            self._thread.join(timeout=5)
        return pending

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._heap and not self._stop:
                    self._cv.wait(timeout=0.1)
                if self._stop:
                    return
                _, _, copy = heapq.heappop(self._heap)
                if copy.cancelled or copy.req.done_event.is_set():
                    continue  # a sibling already finished: drop silently
                copy.started = True
                self._busy = True
            tracker = getattr(self.scheduler, "tracker", None)
            if tracker is not None:
                tracker.incr_busy()
            try:
                out = self.engine.generate(
                    copy.req.tokens, copy.req.max_new_tokens,
                    check_cancel=lambda c=copy: c.cancelled or
                    (self.scheduler.tied_cancel and
                     c.req.done_event.is_set()))
            except Exception:
                out = None  # replica failure: redundancy masks it
            finally:
                with self._cv:
                    self._busy = False
                if tracker is not None:
                    tracker.decr_busy()
            won = False
            if out is not None and not copy.req.done_event.is_set():
                copy.req.out_tokens = list(map(int, out))
                copy.req.completed_by = self.name
                copy.req.done_event.set()
                won = True
            on_done = getattr(self.scheduler, "_on_copy_done", None)
            if on_done is not None:
                on_done(self, copy, won)


class HedgedScheduler:
    def __init__(self, engines: Sequence[Any],
                 policy: HedgePolicy | None = None,
                 meter: LoadMeter | None = None,
                 tied_cancel: bool = False,
                 seed: int = 0,
                 hedge_delay: float = 0.0,
                 retry: RetryPolicy | None = None,
                 shed_watermark: float = 1.0,
                 tracker: LoadTracker | None = None):
        self.policy = policy or HedgePolicy()
        self.meter = meter or LoadMeter(alpha=0.2)
        self.tied_cancel = tied_cancel
        self.rng = np.random.default_rng(seed)
        self.hedge_delay = float(hedge_delay)
        self.retry = retry
        self.shed_watermark = float(shed_watermark)
        # the ONE load signal: workers update it as copies start/finish,
        # and shed decisions + any adaptive controller read the same
        # object (see LoadTracker — utilization() is O(1), not a
        # per-request traversal of every worker's lock)
        engines = list(engines)
        self.tracker = tracker or LoadTracker(len(engines))
        self.tracker.set_capacity(len(engines))
        self._lock = threading.Lock()   # guards the workers list
        self.workers = [ReplicaWorker(e, self, getattr(e, "name", f"r{i}"))
                        for i, e in enumerate(engines)]
        self._rid = itertools.count()
        self._shutdown = False
        self.stats = {"hedged": 0, "total": 0, "duplicate_wins": 0,
                      "cancelled_copies": 0, "retries": 0, "shed": 0,
                      "requeued": 0}

    # ------------------------------------------------------------------
    # elastic replica management: replicas are independent resources, so
    # adding/removing them at runtime needs no resharding or draining —
    # a removed worker's queued copies are requeued on the survivors.
    def add_replica(self, engine: Any) -> None:
        with self._lock:
            self.workers.append(ReplicaWorker(
                engine, self,
                getattr(engine, "name", f"r{len(self.workers)}")))
            self.tracker.set_capacity(len(self.workers))

    def remove_replica(self, name: str) -> bool:
        with self._lock:
            for i, w in enumerate(self.workers):
                if w.name == name:
                    del self.workers[i]
                    victim = w
                    break
            else:
                return False
            survivors = list(self.workers)
            self.tracker.set_capacity(len(survivors))
        for copy in victim.stop():
            if copy.cancelled or copy.req.done_event.is_set():
                continue
            if survivors:
                tgt = survivors[int(self.rng.integers(len(survivors)))]
                tgt.submit(copy)
                self.stats["requeued"] += 1
        return True

    # ------------------------------------------------------------------
    def utilization(self) -> float:
        """Busy copies / replicas — an O(1) read of the shared
        ``LoadTracker`` (workers incr/decr as copies start/finish), not
        a per-request traversal of every worker's condition variable.
        The shed decision below and an adaptive controller subscribed
        to the same tracker therefore see the SAME load signal."""
        return self.tracker.utilization()

    def _dispatch(self, req: Request, priority: int, dispatched: list,
                  exclude: set[str]) -> ReplicaWorker:
        """Enqueue one copy on a random replica (avoiding ``exclude``
        names when possible) and RECORD the (worker, copy) pair — loser
        accounting must never re-index ``self.workers``, which may have
        shrunk by the time the request completes."""
        with self._lock:
            workers = list(self.workers)
        if not workers:
            raise RuntimeError("no replicas")
        cand = [w for w in workers if w.name not in exclude] or workers
        w = cand[int(self.rng.integers(len(cand)))]
        copy = _Copy(req, priority)
        dispatched.append((w, copy))
        w.submit(copy)
        return w

    def submit(self, tokens: np.ndarray, max_new_tokens: int = 16,
               timeout: float = 30.0, hedge_delay: float | None = None,
               retry: RetryPolicy | None = None) -> Request:
        """Blocking submit: dispatch, wait for the first completion (or
        the per-request deadline ``timeout``), account winners/losers.
        ``hedge_delay``/``retry`` default to the scheduler-level knobs;
        passing ``retry`` runs this request as the non-redundant
        timeout-retry baseline instead of hedging."""
        self.meter.update(self.utilization())
        hedge_delay = (self.hedge_delay if hedge_delay is None
                       else float(hedge_delay))
        retry = self.retry if retry is None else retry
        req = Request(rid=next(self._rid), tokens=tokens,
                      max_new_tokens=max_new_tokens,
                      submitted_at=time.monotonic())
        deadline_t = req.submitted_at + timeout
        dispatched: list[tuple[ReplicaWorker, _Copy]] = []
        used: set[str] = set()
        self.stats["total"] += 1

        def remaining() -> float:
            return max(deadline_t - time.monotonic(), 0.0)

        if retry is not None:
            # non-redundant baseline: one outstanding copy, resent with
            # exponential backoff on its deadline
            w = self._dispatch(req, PRIORITY_HIGH, dispatched, used)
            used.add(w.name)
            d = retry.deadline
            for _ in range(retry.max_retries):
                if req.done_event.wait(timeout=min(d, remaining())):
                    break
                if remaining() == 0.0:
                    break
                self.stats["retries"] += 1
                w = self._dispatch(req, PRIORITY_HIGH, dispatched, used)
                used.add(w.name)
                d *= retry.backoff
        else:
            k = self.policy.k_for(self.meter.utilization)
            with self._lock:
                n = len(self.workers)
            k = min(k, n)
            if k > 1 and self.utilization() >= self.shed_watermark:
                k = 1   # graceful degradation: shed duplicates
                self.stats["shed"] += 1
            w = self._dispatch(req, PRIORITY_HIGH, dispatched, used)
            used.add(w.name)
            if k > 1:
                fire = (hedge_delay <= 0.0 or
                        not req.done_event.wait(
                            timeout=min(hedge_delay, remaining())))
                if fire:
                    self.stats["hedged"] += 1
                    for _ in range(k - 1):
                        w = self._dispatch(req, PRIORITY_LOW, dispatched,
                                           used)
                        used.add(w.name)

        if not req.done_event.wait(timeout=remaining()):
            for _, c in dispatched:
                c.cancelled = True
            raise TimeoutError(f"request {req.rid} timed out")
        # cancel the losers; copies never started count as saved work
        for _, c in dispatched:
            if not c.started:
                self.stats["cancelled_copies"] += 1
            c.cancelled = True
        primary_worker, primary_copy = dispatched[0]
        if req.completed_by and primary_copy.started and \
                req.completed_by != primary_worker.name:
            self.stats["duplicate_wins"] += 1
        req.latency = time.monotonic() - req.submitted_at  # type: ignore
        return req

    def shutdown(self) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            workers = list(self.workers)
        for w in workers:
            w.stop()


def estimate_hedge_delay(seed: int, dist, rho: float, cfg,
                         delays: Sequence[float] = (0.0, 0.25, 0.5, 1.0,
                                                    2.0),
                         degradation=None, n_seeds: int = 2,
                         percentile: float = 99.0,
                         device="cuda") -> float:
    """Pick a hedge delay from the ENGINE, ``threshold.scenario_gain``
    style: run one mixed grid of ``HEDGE_AFTER_DELAY`` variants over
    ``delays`` at the measured load and return the delay with the best
    tail — the scheduler's ``hedge_delay`` knob fed by the same sweep
    machinery that calibrates the hedge threshold. Delays are in units
    of mean service time (the engine's clock); the caller scales by the
    replicas' measured mean service seconds.

    A one-row view of the (rho x k x delay) grid that
    ``threshold.policy_table`` sweeps in one mixed-grid ``queueing.run``
    call, on ``device`` (CUDA unless the CPU is asked for)."""
    from repro_torch.core import threshold
    from repro_torch.core.scenario import Scenario

    kw = {} if degradation is None else {"degradation": degradation}
    base = Scenario(dists=dist, ks=(2,), **kw)
    tab = threshold.policy_table(seed, base, cfg, rhos=[float(rho)],
                                 ks=(2,), delays=tuple(delays),
                                 percentile=float(percentile),
                                 n_seeds=n_seeds, device=device)
    return float(tab["delay"][int(np.argmin(tab["tail"][0]))])
