"""Batched hedged serving — fixed-shape entry points, pooled buffers.

The port of ``repro.serving.service``, on the port's ``ReplicaWorker``
owner protocol (``serving.scheduler``); transfer buffers stay numpy, as
in the JAX package.

``HedgedScheduler.submit`` is a BLOCKING call: every in-flight request
pins a submitter thread for its whole lifetime, and every hedge delay
is a thread parked in ``Event.wait``. Fine for tens of concurrent
requests; hopeless for an open-loop trace at thousands in flight. This
module rebuilds the entry path in the batch-service idiom (fixed batch
sizes registered up front, reusable pinned transfer buffers, one
dispatch thread per replica group):

  * ``submit`` / ``submit_batch`` are NON-blocking and O(1): they stamp
    telemetry, copy prompts into a pooled ``TransferBuffer`` (batch
    path), and append to a group inbox. No thread is created per
    request — the paper's k-fold duplication happens on the dispatcher,
    not on k caller threads.
  * one dispatcher thread per REPLICA GROUP drains its inbox, asks the
    ``AdaptiveController`` (or the static knobs) for (k, hedge_delay),
    applies the shed watermark from the shared ``LoadTracker``, and
    enqueues copies on the group's ``ReplicaWorker``s — the same
    two-level priority workers the blocking scheduler uses, reused via
    their owner protocol (``tied_cancel`` / ``tracker`` /
    ``_on_copy_done``).
  * delayed hedges park in ONE timer heap serviced by one timer thread
    for the whole service, not one waiting thread per request; first
    completion finalizes the request from the worker's callback and
    cancels queued losers. Single replica failures are masked by
    surviving copies; a request whose copies ALL error (and with no
    hedge left to fire) is finalized as FAILED — ``result`` raises
    instead of blocking its waiter forever.

Batch sizes are FIXED at construction: ``submit_batch`` picks the
smallest registered size that fits and pads, so buffer shapes (and any
downstream compiled entry points) never vary at serve time — requests
ride pre-allocated memory end to end.
"""
from __future__ import annotations

import collections
import heapq
import itertools
import threading
import time
from typing import Any, Sequence

import numpy as np

from repro_torch.core.hedging import HedgePolicy, LoadTracker
from repro_torch.serving.controller import AdaptiveController
from repro_torch.serving.engine import Request
from repro_torch.serving.metrics import RequestTrace, Telemetry
from repro_torch.serving.scheduler import (PRIORITY_HIGH, PRIORITY_LOW, ReplicaWorker,
                                     _Copy)


class TransferBuffer:
    """One reusable fixed-shape staging buffer: ``(batch_size, max_seq)``
    int32 token block plus per-row lengths. Callers write rows, the
    dispatcher reads them back out; the pool recycles the memory."""

    __slots__ = ("tokens", "lengths", "batch_size", "max_seq", "in_use")

    def __init__(self, batch_size: int, max_seq: int):
        self.batch_size = int(batch_size)
        self.max_seq = int(max_seq)
        self.tokens = np.zeros((self.batch_size, self.max_seq),
                               dtype=np.int32)
        self.lengths = np.zeros(self.batch_size, dtype=np.int32)
        self.in_use = False

    def fill(self, prompts: Sequence[np.ndarray]) -> int:
        n = len(prompts)
        if n > self.batch_size:
            raise ValueError(f"{n} prompts > batch size {self.batch_size}")
        self.lengths[:] = 0
        for i, p in enumerate(prompts):
            p = np.asarray(p, dtype=np.int32).ravel()
            if p.size > self.max_seq:
                raise ValueError(f"prompt length {p.size} > max_seq "
                                 f"{self.max_seq}")
            self.tokens[i, :p.size] = p
            self.lengths[i] = p.size
        return n

    def row(self, i: int) -> np.ndarray:
        return self.tokens[i, :int(self.lengths[i])]


class TransferBufferPool:
    """Fixed set of ``TransferBuffer``s per registered batch size.
    ``acquire`` blocks when every buffer of that size is in flight —
    natural backpressure on the BATCH path only (single-request submits
    never touch the pool)."""

    def __init__(self, batch_sizes: Sequence[int], max_seq: int,
                 buffers_per_size: int = 2):
        if not batch_sizes:
            raise ValueError("need at least one batch size")
        self.batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
        self._free: dict[int, list[TransferBuffer]] = {
            bs: [TransferBuffer(bs, max_seq)
                 for _ in range(int(buffers_per_size))]
            for bs in self.batch_sizes}
        self._cv = threading.Condition()

    def fit(self, n: int) -> int:
        """Smallest registered batch size >= n."""
        for bs in self.batch_sizes:
            if bs >= n:
                return bs
        raise ValueError(f"batch of {n} exceeds largest registered size "
                         f"{self.batch_sizes[-1]}")

    def acquire(self, batch_size: int, timeout: float | None = None
                ) -> TransferBuffer:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            free = self._free[batch_size]
            while not free:
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"no free transfer buffer of size {batch_size}")
                self._cv.wait(timeout=left)
            buf = free.pop()
            buf.in_use = True
            return buf

    def release(self, buf: TransferBuffer) -> None:
        with self._cv:
            buf.in_use = False
            self._free[buf.batch_size].append(buf)
            self._cv.notify_all()


class _Pending:
    """Dispatcher-side state of one in-flight request.

    ``outstanding`` counts reserved copies that have neither won nor
    failed; ``hedge_pending`` marks a delayed hedge parked in the timer
    heap. Together they decide when EVERY avenue to a completion is
    exhausted (all copies failed, no hedge left to fire) so the request
    can be finalized as failed instead of leaking a waiter."""

    __slots__ = ("req", "copies", "used", "k", "hedge_delay", "lock",
                 "finalized", "group", "outstanding", "hedge_pending")

    def __init__(self, req: Request, group: int):
        self.req = req
        self.copies: list[tuple[ReplicaWorker, _Copy]] = []
        self.used: set[str] = set()
        self.k = 1
        self.hedge_delay = 0.0
        self.lock = threading.Lock()
        self.finalized = False
        self.group = group
        self.outstanding = 0
        self.hedge_pending = False


class BatchedHedgedService:
    """Non-blocking hedged service over replica groups.

    ``engines`` is partitioned round-robin into ``n_groups`` groups,
    each owning one dispatch thread and its slice of workers; a
    request's primary and duplicates stay inside one group (the
    paper's "diverse resources" are the group's distinct replicas).
    Replication policy comes from, in precedence order: an
    ``AdaptiveController`` (live (k, delay) from engine sweeps), else
    the static ``k`` / ``hedge_delay_s`` knobs, else a ``HedgePolicy``
    driven by the shared tracker's utilization. ``shed_watermark``
    reads the SAME ``LoadTracker`` the workers update — the O(1)
    signal, identical to what the controller sees. With ``trace`` (the
    default) each request carries a ``RequestTrace``: what the dispatcher
    decided for it and its copies' spans (``serving.metrics``).
    """

    def __init__(self, engines: Sequence[Any], *,
                 batch_sizes: Sequence[int] = (1, 4, 8),
                 max_seq: int = 64,
                 buffers_per_size: int = 2,
                 controller: AdaptiveController | None = None,
                 policy: HedgePolicy | None = None,
                 k: int = 2,
                 hedge_delay_s: float = 0.0,
                 n_groups: int = 1,
                 tracker: LoadTracker | None = None,
                 telemetry: Telemetry | None = None,
                 shed_watermark: float = 1.0,
                 tied_cancel: bool = False,
                 seed: int = 0,
                 trace: bool = True):
        engines = list(engines)
        if not engines:
            raise ValueError("need at least one engine")
        n_groups = max(1, min(int(n_groups), len(engines)))
        self.tied_cancel = bool(tied_cancel)
        self.controller = controller
        self.policy = policy
        self.static_k = int(k)
        self.static_delay = float(hedge_delay_s)
        self.shed_watermark = float(shed_watermark)
        self.trace = bool(trace)
        self.tracker = tracker or (controller.tracker if controller
                                   else LoadTracker(len(engines)))
        self.tracker.set_capacity(len(engines))
        if controller is not None and controller.tracker is not self.tracker:
            raise ValueError("controller must share the service's "
                             "LoadTracker (one load signal)")
        self.telemetry = telemetry or Telemetry()
        self.pool = TransferBufferPool(batch_sizes, max_seq,
                                       buffers_per_size)
        self.rng = np.random.default_rng(seed)
        self._rid = itertools.count()
        self._pending: dict[int, _Pending] = {}
        self._plock = threading.Lock()
        # stats are written from submitter, dispatcher, timer and worker
        # threads — mutate only through _bump (under _plock)
        self.stats = {"total": 0, "hedged": 0, "shed": 0,
                      "duplicate_wins": 0, "cancelled_copies": 0,
                      "batches": 0, "failed": 0}

        # replica groups: round-robin partition, one dispatcher each
        self._groups: list[list[ReplicaWorker]] = [[] for _ in
                                                   range(n_groups)]
        for i, e in enumerate(engines):
            w = ReplicaWorker(e, self, getattr(e, "name", f"r{i}"))
            self._groups[i % n_groups].append(w)
        self._inboxes = [collections.deque() for _ in range(n_groups)]
        self._inbox_cvs = [threading.Condition() for _ in range(n_groups)]
        self._stop = False
        self._dispatchers = [
            threading.Thread(target=self._dispatch_loop, args=(g,),
                             daemon=True, name=f"dispatch-{g}")
            for g in range(n_groups)]
        # one timer thread services every delayed hedge in the service
        self._timer_heap: list[tuple[float, int]] = []
        self._timer_cv = threading.Condition()
        self._timer = threading.Thread(target=self._timer_loop, daemon=True,
                                       name="hedge-timer")
        for t in self._dispatchers:
            t.start()
        self._timer.start()

    def _bump(self, key: str, n: int = 1) -> None:
        if n:
            with self._plock:
                self.stats[key] += n

    # ------------------------------------------------------------------
    # submission: non-blocking, O(1)
    def submit(self, tokens: np.ndarray, max_new_tokens: int = 16
               ) -> Request:
        """Enqueue one request; returns immediately. Wait on
        ``request.done_event`` (or use ``result``) for the output."""
        t = time.monotonic()
        req = Request(rid=next(self._rid),
                      tokens=np.asarray(tokens, dtype=np.int32),
                      max_new_tokens=max_new_tokens, submitted_at=t)
        self._enqueue(req, t)
        return req

    def submit_batch(self, prompts: Sequence[np.ndarray],
                     max_new_tokens: int = 16,
                     timeout: float | None = None) -> list[Request]:
        """Batch entry point: stage ``prompts`` through a pooled
        ``TransferBuffer`` of the smallest fitting registered size,
        enqueue one request per row, release the buffer. Blocks only
        when the pool for that size is exhausted (backpressure)."""
        bs = self.pool.fit(len(prompts))
        buf = self.pool.acquire(bs, timeout=timeout)
        try:
            n = buf.fill(prompts)
            t = time.monotonic()
            reqs = []
            for i in range(n):
                req = Request(rid=next(self._rid),
                              tokens=buf.row(i).copy(),
                              max_new_tokens=max_new_tokens,
                              submitted_at=t)
                reqs.append(req)
            self._bump("batches")
        finally:
            self.pool.release(buf)
        for req in reqs:
            self._enqueue(req, t)
        return reqs

    def result(self, req: Request, timeout: float | None = None
               ) -> list[int]:
        if not req.done_event.wait(timeout=timeout):
            self._cancel_request(req)
            raise TimeoutError(f"request {req.rid} timed out")
        if req.failed:
            raise RuntimeError(f"request {req.rid} failed on every "
                               "replica copy")
        return req.out_tokens

    def _enqueue(self, req: Request, t: float) -> None:
        if self.trace:
            req.trace = RequestTrace(req.rid, time.perf_counter())
        g = req.rid % len(self._groups)
        p = _Pending(req, g)
        with self._plock:
            self.stats["total"] += 1
            self._pending[req.rid] = p
        self.telemetry.note_arrival(req.rid, t)
        if self.controller is not None:
            self.controller.on_arrival(t)
        else:
            self.tracker.note_arrival(t)
        cv = self._inbox_cvs[g]
        with cv:
            self._inboxes[g].append(p)
            cv.notify()

    # ------------------------------------------------------------------
    # dispatch: one thread per replica group
    def _decide(self, u: float) -> tuple[int, float]:
        """(k, hedge delay) at the pool's utilization ``u``."""
        if self.controller is not None:
            k, delay = self.controller.current()
        elif self.policy is not None:
            k, delay = self.policy.k_for(u), self.static_delay
        else:
            k, delay = self.static_k, self.static_delay
        return max(int(k), 1), float(delay)

    def _dispatch_loop(self, g: int) -> None:
        cv, inbox, workers = self._inbox_cvs[g], self._inboxes[g], \
            self._groups[g]
        while True:
            with cv:
                while not inbox and not self._stop:
                    cv.wait(timeout=0.1)
                if self._stop:
                    return
                p = inbox.popleft()
            if p.req.cancelled:
                continue
            u = self.tracker.utilization()
            k, delay = self._decide(u)
            k = min(k, len(workers))
            shed = False
            if k > 1 and self.tracker.utilization() >= self.shed_watermark:
                k, shed = 1, True
                self._bump("shed")
            p.k, p.hedge_delay = k, delay
            if p.req.trace is not None:
                p.req.trace.k, p.req.trace.utilization = k, u
                p.req.trace.shed = shed
            t = time.monotonic()
            self.telemetry.note_dispatch(p.req.rid, t, k, shed=shed)
            if self.controller is not None:
                # planned copies: the hedge may be cancelled by an early
                # completion, but capacity is provisioned for k
                self.controller.note_dispatch(k, t)
            else:
                self.tracker.note_copies(k, t)
            if k > 1 and delay <= 0.0:
                self._bump("hedged")
                self.telemetry.note_hedge(p.req.rid, k - 1)
                # reserve primary + duplicates in ONE lock section: a
                # fast-failing primary must never see outstanding==0
                # while its siblings are still on the way
                self._send_copies(
                    p, workers,
                    [PRIORITY_HIGH] + [PRIORITY_LOW] * (k - 1))
            elif k > 1:
                with p.lock:
                    p.hedge_pending = True
                self._send_copies(p, workers, [PRIORITY_HIGH])
                with self._timer_cv:
                    heapq.heappush(self._timer_heap,
                                   (t + delay, p.req.rid))
                    self._timer_cv.notify()
            else:
                self._send_copies(p, workers, [PRIORITY_HIGH])

    def _reserve_copy(self, p: _Pending, workers: list[ReplicaWorker],
                      priority: int) -> tuple[ReplicaWorker, _Copy]:
        """Pick a replica and register one copy. Caller holds ``p.lock``
        and submits the returned pair after releasing it."""
        cand = [w for w in workers if w.name not in p.used] or workers
        w = cand[int(self.rng.integers(len(cand)))]
        copy = _Copy(p.req, priority)
        p.copies.append((w, copy))
        p.used.add(w.name)
        p.outstanding += 1
        return w, copy

    def _send_copies(self, p: _Pending, workers: list[ReplicaWorker],
                     priorities: Sequence[int]) -> None:
        with p.lock:
            if p.finalized:
                return
            sends = [self._reserve_copy(p, workers, pr)
                     for pr in priorities]
        for w, copy in sends:
            w.submit(copy)

    def _timer_loop(self) -> None:
        while True:
            with self._timer_cv:
                while not self._timer_heap and not self._stop:
                    self._timer_cv.wait(timeout=0.1)
                if self._stop:
                    return
                due, rid = self._timer_heap[0]
                now = time.monotonic()
                if due > now:
                    self._timer_cv.wait(timeout=due - now)
                    continue
                heapq.heappop(self._timer_heap)
            with self._plock:
                p = self._pending.get(rid)
            if p is None:
                continue  # finalized before the hedge fired
            workers = self._groups[p.group]
            sends = []
            with p.lock:
                # clearing the flag and reserving the copies must be one
                # atomic step: with the flag down and nothing reserved, a
                # concurrently failing primary would finalize the request
                p.hedge_pending = False
                fire = not p.finalized and not p.req.done_event.is_set()
                if fire:
                    sends = [self._reserve_copy(p, workers, PRIORITY_LOW)
                             for _ in range(p.k - 1)]
            if not fire:
                continue  # completed before the hedge fired: saved work
            self._bump("hedged")
            self.telemetry.note_hedge(rid, p.k - 1)
            for w, copy in sends:
                w.submit(copy)

    # ------------------------------------------------------------------
    # completion: ReplicaWorker owner protocol
    def _on_copy_done(self, worker: ReplicaWorker, copy: _Copy,
                      won: bool) -> None:
        """Only two callers may finalize a request: its WINNING copy
        (so the latency stamp is the first completion, never a loser
        that drained later), and its LAST failing copy once no sibling
        or parked hedge can still win (so a request whose copies all
        error is surfaced as failed instead of blocking its waiter
        forever)."""
        rid = copy.req.rid
        with self._plock:
            p = self._pending.get(rid)
        if p is None:
            return
        failed = False
        with p.lock:
            if p.finalized:
                return
            if not won:
                if copy.req.done_event.is_set():
                    # loser drained after the winner set the event: the
                    # winner's own callback finalizes — pure no-op here
                    return
                p.outstanding -= 1
                if p.outstanding > 0 or p.hedge_pending:
                    return  # a sibling or a parked hedge may still win
                failed = True
            p.finalized = True
            copies = list(p.copies)
        with self._plock:
            self._pending.pop(rid, None)
        t = time.monotonic()
        cancelled = 0
        for w, c in copies:
            if c is not copy and not c.started:
                cancelled += 1
            c.cancelled = True
        self._bump("cancelled_copies", cancelled)
        if cancelled:
            self.telemetry.note_cancel(rid, t, cancelled)
        if failed:
            copy.req.failed = True
            self._bump("failed")
            self.telemetry.note_failure(rid, t)
            copy.req.done_event.set()  # unblock waiters with the failure
            return
        if copy.req.completed_by != copies[0][0].name \
                and copies[0][1].started:
            self._bump("duplicate_wins")
        copy.req.latency = t - copy.req.submitted_at  # type: ignore
        self.telemetry.note_completion(rid, t, copy.req.completed_by)

    def _cancel_request(self, req: Request) -> None:
        req.cancelled = True
        with self._plock:
            p = self._pending.pop(req.rid, None)
        if p is None:
            return
        with p.lock:
            p.finalized = True
            copies = list(p.copies)
        n = 0
        for _, c in copies:
            c.cancelled = True
            n += 1
        self.telemetry.note_cancel(req.rid, time.monotonic(), n,
                                   timeout=True)

    # ------------------------------------------------------------------
    def utilization(self) -> float:
        return self.tracker.utilization()

    def shutdown(self) -> None:
        self._stop = True
        for cv in self._inbox_cvs:
            with cv:
                cv.notify_all()
        with self._timer_cv:
            self._timer_cv.notify_all()
        for t in self._dispatchers:
            t.join(timeout=5)
        self._timer.join(timeout=5)
        for g in self._groups:
            for w in g:
                w.stop()
