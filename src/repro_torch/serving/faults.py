"""Fault injection for the serving layer (the port of
``repro.serving.faults``, unchanged: it wraps the port's engines).

``FaultInjector`` wraps any engine (real ``InferenceEngine``,
``SimulatedEngine``, anything with ``generate``) in a proxy whose
behaviour the injector can change at runtime — the serving-layer
analogue of the engine's degradation model (``core.scenario``):

  ``crash``  every ``generate`` raises ``ReplicaCrashed`` — the
             blackhole: the copy never responds and the scheduler's
             redundancy must mask it.
  ``stall``  ``generate`` blocks (checking cancellation) until the
             replica is healed — a hung replica rather than a dead one;
             distinguishable from crash because it pins a worker.
  ``slow``   service time is inflated by a factor — the straggler
             (the proxy times the inner call and pads the difference,
             so it works for real engines, not just simulated ones).

Faults are keyed by replica name, can be scheduled in the future
(``after=`` seconds, a daemon timer), and are reversible (``heal``).
The proxies stay valid across fault changes, so a chaos test can flip
one replica between healthy/slow/crashed mid-trace without touching
the scheduler.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable

STATE_OK = "ok"
STATE_CRASH = "crash"
STATE_STALL = "stall"
STATE_SLOW = "slow"


class ReplicaCrashed(RuntimeError):
    """Raised by a crashed replica's ``generate`` — the scheduler's
    workers treat any exception as a masked replica failure."""


class FaultyEngine:
    """Proxy engine: delegates to ``inner`` subject to the injector's
    current fault state for this replica name."""

    def __init__(self, inner: Any, injector: "FaultInjector"):
        self.inner = inner
        self.injector = injector
        self.name = getattr(inner, "name", repr(inner))

    def generate(self, tokens, max_new_tokens: int = 16,
                 check_cancel: Callable[[], bool] | None = None):
        state, factor = self.injector.state(self.name)
        if state == STATE_CRASH:
            raise ReplicaCrashed(self.name)
        if state == STATE_STALL:
            # hang until healed (or the copy is cancelled); re-dispatch
            # to the inner engine once healthy again
            while True:
                if check_cancel is not None and check_cancel():
                    return None
                state, factor = self.injector.state(self.name)
                if state == STATE_CRASH:
                    raise ReplicaCrashed(self.name)
                if state != STATE_STALL:
                    break
                time.sleep(0.001)
        t0 = time.monotonic()
        out = self.inner.generate(tokens, max_new_tokens,
                                  check_cancel=check_cancel)
        if state == STATE_SLOW and out is not None:
            # pad to factor x the measured service time, cancellable
            extra = (time.monotonic() - t0) * (factor - 1.0)
            deadline = time.monotonic() + extra
            while time.monotonic() < deadline:
                if check_cancel is not None and check_cancel():
                    return None
                time.sleep(min(0.0005,
                               max(deadline - time.monotonic(), 0.0)))
        return out


class FaultInjector:
    """Runtime fault switchboard for a set of wrapped replicas."""

    def __init__(self):
        self._lock = threading.Lock()
        self._state: dict[str, tuple[str, float]] = {}

    def wrap(self, engine: Any) -> FaultyEngine:
        return FaultyEngine(engine, self)

    def state(self, name: str) -> tuple[str, float]:
        with self._lock:
            return self._state.get(name, (STATE_OK, 1.0))

    def _set(self, name: str, state: str, factor: float,
             after: float) -> None:
        def apply():
            with self._lock:
                self._state[name] = (state, factor)
        if after > 0:
            t = threading.Timer(after, apply)
            t.daemon = True
            t.start()
        else:
            apply()

    def crash(self, name: str, after: float = 0.0) -> None:
        self._set(name, STATE_CRASH, 1.0, after)

    def stall(self, name: str, after: float = 0.0) -> None:
        self._set(name, STATE_STALL, 1.0, after)

    def slow(self, name: str, factor: float, after: float = 0.0) -> None:
        if factor < 1.0:
            raise ValueError(f"slow factor must be >= 1, got {factor}")
        self._set(name, STATE_SLOW, float(factor), after)

    def heal(self, name: str, after: float = 0.0) -> None:
        self._set(name, STATE_OK, 1.0, after)
