"""Redundant ("hedged") execution — the paper's technique as a runtime.

A copy of the JAX package's ``repro.core.hedging`` (which imports no JAX).

The paper's prescription, operationalized:
  * duplicate a request to k diverse resources and take the first completion
    (``hedged_call``);
  * only duplicate while measured utilization is below the threshold load
    for the measured service distribution (``HedgePolicy`` — §2.1 says that
    threshold is 25-50%, so the default conservative threshold is 0.25 and a
    measured one can be plugged in);
  * optionally issue duplicates at lower priority so they never delay
    primary work (§2.4) — honored by the serving scheduler which passes
    ``priority=LOW`` for copies >= 1;
  * optionally cancel outstanding copies once one completes (beyond-paper:
    Dean & Barroso's "tied requests"; the paper's model serves every copy to
    completion, so cancellation is OFF by default).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Any, Callable, Sequence

PRIORITY_HIGH = 0
PRIORITY_LOW = 1


@dataclasses.dataclass
class HedgeResult:
    value: Any
    winner: int               # index of the replica that completed first
    latency: float            # seconds until first completion
    k: int                    # number of copies actually issued
    losers_cancelled: int = 0


class LoadMeter:
    """EWMA utilization estimate: fraction of busy capacity.

    ``update`` is fed (busy_fraction in [0, 1]) samples by whoever owns the
    resource pool (the serving scheduler reports queue occupancy / busy
    replicas each tick).
    """

    def __init__(self, alpha: float = 0.1, init: float = 0.0):
        self.alpha = float(alpha)
        self._util = float(init)
        self._lock = threading.Lock()

    def update(self, busy_fraction: float) -> None:
        b = min(max(float(busy_fraction), 0.0), 1.0)
        with self._lock:
            self._util = (1.0 - self.alpha) * self._util + self.alpha * b

    @property
    def utilization(self) -> float:
        with self._lock:
            return self._util


class LoadTracker:
    """O(1) shared load signal for a replica pool.

    ``LoadMeter`` is an EWMA the scheduler must FEED by polling every
    worker per request (O(n_replicas) lock acquisitions on the hot
    path). ``LoadTracker`` inverts the flow: workers increment /
    decrement one shared busy counter as copies start and finish, and
    every reader — the shed decision, the adaptive controller, the
    benchmark — sees the SAME instantaneous signal with one lock and no
    per-worker traversal:

      * ``utilization()``       busy copies / capacity, O(1);
      * ``arrival_rate(now)``   arrivals per second over a sliding
                                ``window_s`` window (amortized O(1):
                                timestamps in a deque, stale entries
                                popped on read);
      * ``copies_per_request()`` dispatched copies per arrival over the
                                same window — the measured effective
                                replication factor k_eff, which lets a
                                controller convert busy fraction back
                                to OFFERED load (busy/k_eff) without
                                its own hedging feeding back into its
                                load estimate.

    Timestamps default to ``time.monotonic()`` but every note-method
    takes an explicit ``t`` so a virtual-clock harness (the trace
    replay simulator) can drive the identical object in simulated
    seconds.
    """

    def __init__(self, capacity: int, window_s: float = 30.0):
        self._lock = threading.Lock()
        self._busy = 0
        self._capacity = max(int(capacity), 0)
        self.window_s = float(window_s)
        self._arrivals = collections.deque()   # arrival timestamps
        self._copies = collections.deque()     # (timestamp, n_copies)
        self._copies_sum = 0

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._capacity = max(int(capacity), 0)

    @property
    def capacity(self) -> int:
        with self._lock:
            return self._capacity

    def incr_busy(self) -> None:
        with self._lock:
            self._busy += 1

    def decr_busy(self) -> None:
        with self._lock:
            self._busy -= 1

    def utilization(self) -> float:
        with self._lock:
            return self._busy / max(self._capacity, 1)

    def note_arrival(self, t: float | None = None) -> None:
        t = time.monotonic() if t is None else float(t)
        with self._lock:
            self._arrivals.append(t)
            self._trim(t)

    def note_copies(self, n: int, t: float | None = None) -> None:
        t = time.monotonic() if t is None else float(t)
        with self._lock:
            self._copies.append((t, int(n)))
            self._copies_sum += int(n)
            self._trim(t)

    def _trim(self, now: float) -> None:
        horizon = now - self.window_s
        arr, cop = self._arrivals, self._copies
        while arr and arr[0] < horizon:
            arr.popleft()
        while cop and cop[0][0] < horizon:
            self._copies_sum -= cop.popleft()[1]

    def arrival_rate(self, now: float | None = None) -> float:
        """Arrivals per second over the retained window. Batch submits
        stamp many arrivals with ONE timestamp, so the raw span can be
        zero (or microscopic) while the deque is full — dividing by it
        would report an absurd rate and slam an adaptive controller to
        its max-load policy. Until the window has observed a span of at
        least 5% of ``window_s``, the rate is conservatively floored:
        zero span reads as 0 (no rate measurable yet), tiny spans are
        divided by the floor instead."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            self._trim(now)
            if not self._arrivals:
                return 0.0
            span = now - self._arrivals[0]
            if span <= 0.0:
                return 0.0
            return len(self._arrivals) / max(span, 0.05 * self.window_s)

    def copies_per_request(self, now: float | None = None) -> float:
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            self._trim(now)
            if not self._arrivals:
                return 1.0
            return max(self._copies_sum / len(self._arrivals), 1.0)


@dataclasses.dataclass
class HedgePolicy:
    """Decide the replication factor for the next request.

    ``threshold`` should be the threshold load for the system's service-time
    distribution (estimated via ``repro_torch.core.threshold``); the paper
    guarantees it lies in (0.258, 0.5) when client-side overhead is small,
    so 0.25 is a universally safe default. ``client_overhead_frac`` is the
    client-side duplication cost relative to mean service time; following
    §2.1/Fig 4, hedging is disabled when it is large.
    """

    max_k: int = 2
    threshold: float = 0.25
    client_overhead_frac: float = 0.0
    overhead_cutoff: float = 0.5  # Fig 4: overhead ~ mean latency kills gains

    def k_for(self, utilization: float) -> int:
        if self.client_overhead_frac >= self.overhead_cutoff:
            return 1
        # duplicating multiplies utilization by k; pick the largest k
        # whose k-fold load stays under the threshold.
        k = self.max_k
        while k > 1 and k * utilization >= self.threshold:
            k -= 1
        return k


def hedged_call(replicas: Sequence[Callable[..., Any]],
                *args: Any,
                k: int = 2,
                executor: ThreadPoolExecutor | None = None,
                cancel: bool = False,
                timeout: float | None = None,
                **kwargs: Any) -> HedgeResult:
    """Run ``k`` of the given replica callables concurrently, first wins.

    Replicas are picked in order (callers shuffle / rank for diversity, as
    the DNS study ranks servers). ``cancel=True`` attempts
    ``Future.cancel()`` on the losers (only not-yet-started work can be
    cancelled — same constraint a real RPC layer has before the server
    dequeues the request).
    """
    k = max(1, min(k, len(replicas)))
    own_pool = executor is None
    pool = executor or ThreadPoolExecutor(max_workers=k)
    t0 = time.monotonic()
    futures: list[Future] = [pool.submit(replicas[i], *args, **kwargs)
                             for i in range(k)]
    try:
        done, pending = wait(futures, timeout=timeout,
                             return_when=FIRST_COMPLETED)
        if not done:
            raise TimeoutError(f"no replica completed within {timeout}s")
        # earliest completed future wins; exceptions propagate only if every
        # issued copy failed (redundancy masks single failures).
        winner_future = None
        for f in done:
            if f.exception() is None:
                winner_future = f
                break
        if winner_future is None:
            remaining = list(pending)
            while remaining:
                d, remaining_set = wait(remaining, return_when=FIRST_COMPLETED)
                remaining = list(remaining_set)
                for f in d:
                    if f.exception() is None:
                        winner_future = f
                        break
                if winner_future is not None:
                    break
            if winner_future is None:
                raise next(iter(done)).exception()  # every copy failed
        latency = time.monotonic() - t0
        cancelled = 0
        if cancel:
            for f in futures:
                if f is not winner_future and f.cancel():
                    cancelled += 1
        return HedgeResult(value=winner_future.result(),
                           winner=futures.index(winner_future),
                           latency=latency, k=k, losers_cancelled=cancelled)
    finally:
        if own_pool:
            pool.shutdown(wait=False, cancel_futures=True)
