"""Shared arithmetic of the readers of the program's own spans and
counters: the trace each request of the program's service carries
(``Request.trace``: the request's submit stamp and one span per copy,
each holding its queue wait and the engine's steps, every stamp on
``time.perf_counter()``, the benchmark's own host clock). A reader
returns None where the program keeps no such trace."""
from __future__ import annotations

import collections
import math
import statistics

FINISHED = ("won", "lost")
# the spans in which a replica's thread runs the interpreter, enqueuing
ENQUEUES = ("repro.prefill", "repro.decode")


def copies(run) -> list:
    """(request trace, copy span) of every copy of the window's requests
    that began in the window and finished, won or lost."""
    w = run.window
    out = []
    for r in w.records:
        tr = getattr(r["req"], "trace", None)
        for c in getattr(tr, "copies", ()):
            if c.outcome in FINISHED and w.start <= c.start <= w.close:
                out.append((tr, c))
    return out


def _mean_ms(seconds: list) -> float | None:
    return 1e3 * statistics.fmean(seconds) if seconds else None


def queue_wait_ms(run) -> float | None:
    """Mean wait of a started copy in its replica's queue."""
    return _mean_ms([c.queue.seconds for _, c in copies(run)])


def loser_prefill_share(run) -> float | None:
    """Prompt tokens prefilled by copies that lost, as a share (%) of
    the prompt tokens every started copy prefilled."""
    cs = [c for _, c in copies(run)]
    total = sum(c.prompt_tokens for c in cs)
    if not total:
        return None
    return 100.0 * sum(c.prompt_tokens for c in cs
                       if c.outcome == "lost") / total


def ttft_ms(run) -> float | None:
    """Mean time from a request's submit stamp to its winning copy's
    first token on the host."""
    return _mean_ms([c.t_first_token - tr.t_submit for tr, c in copies(run)
                     if c.outcome == "won"])


def steps(run, name: str) -> list:
    """The spans called ``name`` of the finished copies, in order."""
    return [s for _, c in copies(run) for s in c.spans if s.name == name]


def step_ms(run, name: str) -> float | None:
    """Mean length of the steps' spans called ``name``."""
    return _mean_ms([s.seconds for s in steps(run, name)])


def counter_ms(run, name: str, counter: str) -> float | None:
    """Mean of the nanosecond counter ``counter`` over the steps called
    ``name``, in ms; None where no step counted it."""
    ss = steps(run, name)
    if not any(counter in s.counters for s in ss):
        return None
    return 1e-6 * statistics.fmean(s.counters.get(counter, 0) for s in ss)


def decode_overlap_ms(run) -> float | None:
    """Mean time a decode step's host enqueue overlaps the enqueues
    (prefill or decode) of the copies on the other replicas: the time two
    replica threads both had ops to enqueue through the one interpreter,
    read from the stamps alone. It bounds the step's wait for the
    interpreter from above; a wait for the card inside the enqueue, or a
    stretch of it that runs outside the interpreter, lies in it too."""
    enq = collections.defaultdict(list)   # replica -> its enqueue spans
    for r in run.window.records:
        tr = getattr(r["req"], "trace", None)
        for c in getattr(tr, "copies", ()):
            enq[c.replica] += [(s.start, s.end) for s in c.spans
                               if s.name in ENQUEUES and not math.isnan(s.end)]
    return _mean_ms([
        sum(max(min(b, s.end) - max(a, s.start), 0.0)
            for rep, ivs in enq.items() if rep != c.replica
            for a, b in ivs)
        for _, c in copies(run) for s in c.spans if s.name == "repro.decode"])
