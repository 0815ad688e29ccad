"""The copy span current on a thread: what the layers below serving (the
engine's steps, the model's MoE layers) write a served request's records
into, and nothing more.

The serving layer's ``ReplicaWorker`` makes a copy's span
(``serving.metrics.CopySpan``) current on its thread around
``engine.generate`` (``set_current``); on every other thread, and for a
request that carries no trace, the current copy is ``NO_COPY``, whose
hooks do nothing, so training, tests and sharded runs pay one
thread-local read. While a ``torch.profiler`` session records, ``record``
enters a ``record_function`` of a span's name.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch.autograd.profiler as _autograd_profiler


def record(name: str):
    """A ``record_function`` of ``name`` entered, while a profiler session
    records (the flag the profiler sets on start, one attribute read);
    else None."""
    if not getattr(_autograd_profiler, "_is_profiler_enabled", False):
        return None
    rf = _autograd_profiler.record_function(name)
    rf.__enter__()
    return rf


class _NoCopy:
    """The engine's view of a thread with no copy span: nothing."""

    _open = None    # no step whose ops the host is enqueuing

    def enqueue(self, name: str, prompt_tokens: int = 0) -> None:
        pass

    def wait(self) -> None:
        pass

    def token(self) -> None:
        pass


NO_COPY = _NoCopy()


class _Current(threading.local):
    copy = NO_COPY      # the copy span this thread runs


_current = _Current()


def current_copy():
    """The copy span running on this thread, or ``NO_COPY``."""
    return _current.copy


def set_current(copy) -> None:
    """Make ``copy`` this thread's current copy span (``NO_COPY``: none)."""
    _current.copy = copy


class _Counted:
    __slots__ = ("step", "counter", "name", "t", "rf")

    def __init__(self, step, counter: str, name: str):
        self.step, self.counter, self.name = step, counter, name

    def __enter__(self):
        self.rf = record(self.name)
        self.t = time.perf_counter_ns()

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t
        c = self.step.counters
        c[self.counter] = c.get(self.counter, 0) + ns
        if self.rf is not None:
            self.rf.__exit__(None, None, None)


_NOTHING = contextlib.nullcontext()


def counted_in_step(counter: str, name: str):
    """Host time inside the ``with`` block, added to ``counter`` of the
    step whose ops this thread's copy is enqueuing (under a profiler, a
    ``record_function`` of ``name`` too); outside such a step, nothing."""
    step = _current.copy._open
    return _NOTHING if step is None else _Counted(step, counter, name)
