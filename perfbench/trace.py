"""Reading a ``torch.profiler`` trace of the window from the profiler's
own events (``kineto_results``): the device's busy time, its operations
by time, the device time of the work launched inside each of the
benchmark's spans, and the device's idle gaps labelled by the spans
open on the host.

A device operation belongs to the spans that were open, on the thread
that launched it, when it was launched: the profiler links a kernel to
its launch call by a correlation id. A kernel whose launch the profiler
does not record (a library that links the CUDA runtime statically, as
the port's ``nvcc``-built kernels do) is placed by the stream's order:
it was launched between the launches of the linked operations before
and after it on its stream, and it is given to the one call span of
``ATTRIBUTED`` open in that interval, if exactly one is."""
from __future__ import annotations

import bisect
import collections

WINDOW = "perfbench.window"
SPANS = ("loadgen.wait", "service.submit", "engine.prefill",
         "engine.decode_step", "moe", "attention", "attention.decode")
ATTRIBUTED = ("attention", "attention.decode")
SHORT_GAP_US = 20.0


def base_name(name: str) -> str | None:
    """The span a host event is (``attention:12`` -> ``attention``), or
    None for the program's own events."""
    if name == WINDOW:
        return name
    head = name.split(":", 1)[0]
    return head if head in SPANS else None


class _Thread:
    """One host thread's spans, sorted by start (ns), each with the span
    it nests in (a thread's spans nest: they are ``with`` blocks)."""

    LOOK_BACK = 4096

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.parent = []
        stack = []
        for i, (a, b, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def open_at(self, t: float) -> list:
        """The spans open at ``t``, innermost last."""
        i = bisect.bisect_right(self.starts, t) - 1
        stop = max(i - self.LOOK_BACK, -1)
        while i > stop and self.spans[i][1] <= t:
            i -= 1
        out = []
        if i > stop:
            while i >= 0:
                out.append(self.spans[i])
                i = self.parent[i]
        return out[::-1]


def analyse(events, top: int = 10) -> dict:
    """``events``: ``profile.profiler.kineto_results.events()``."""
    from torch.autograd import DeviceType
    spans = collections.defaultdict(list)
    launches = {}
    dev = []
    w0 = w1 = None
    for ev in events:
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CPU:
            b = base_name(name)
            if b == WINDOW:
                w0, w1 = start, end
            elif b is not None:
                spans[ev.start_thread_id()].append((start, end, name))
            cid = ev.correlation_id()
            if cid and (cid not in launches or name.startswith("cu")):
                launches[cid] = (ev.start_thread_id(), start)
        elif base_name(name) is None and not ev.is_user_annotation():
            dev.append((start, end, name, ev.linked_correlation_id(),
                        ev.device_resource_id()))
    if w0 is None:
        raise RuntimeError("the trace holds no window span")
    threads = {t: _Thread(v) for t, v in spans.items()}
    dev.sort()
    # busy time and idle gaps over the window
    busy, cur, gaps = 0, w0, []
    for a, b, *_ in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
        busy += max(b - max(a, cur), 0)
        cur = max(cur, b)
    if w1 > cur:
        gaps.append((cur, w1))
    by_op = collections.Counter()
    span_ns = collections.Counter()
    linked_ns = unplaced_ns = 0
    # the launch (thread, host time) of each device op, by stream order
    where = [launches.get(d[3]) if d[3] else None for d in dev]
    by_stream = collections.defaultdict(list)
    for i, d in enumerate(dev):
        by_stream[d[4]].append(i)
    calls = sorted((s[0], s[1], s[2], t) for t, th in threads.items()
                   for s in th.spans if base_name(s[2]) in ATTRIBUTED)
    call_starts = [c[0] for c in calls]
    for order in by_stream.values():
        prev = None
        nxt = [None] * len(order)
        for j in range(len(order) - 1, -1, -1):
            nxt[j] = prev
            if where[order[j]] is not None:
                prev = where[order[j]]
        prev = None
        for j, i in enumerate(order):
            a, b, name = dev[i][:3]
            dur = b - a
            by_op[name] += dur
            if where[i] is not None:
                tid, t = where[i]
                prev = where[i]
                linked_ns += dur
                th = threads.get(tid)
                for s in (th.open_at(t) if th else []):
                    span_ns[s[2] if base_name(s[2]) in ATTRIBUTED
                            else base_name(s[2])] += dur
                continue
            lo = prev[1] if prev else float("-inf")
            hi = nxt[j][1] if nxt[j] else float("inf")
            k = bisect.bisect_right(call_starts, hi)
            cand = [c for c in calls[max(k - 64, 0):k] if c[1] >= lo]
            if len(cand) != 1:
                unplaced_ns += dur
                continue
            c0, c1, cname, tid = cand[0]
            span_ns[cname] += dur
            for s in threads[tid].open_at(0.5 * (c0 + c1)):
                if s[2] != cname:
                    span_ns[s[2] if base_name(s[2]) in ATTRIBUTED
                            else base_name(s[2])] += dur
    idle = collections.Counter()
    for a, b in gaps:
        if b - a < SHORT_GAP_US * 1e3:
            idle[f"gaps under {SHORT_GAP_US:g} us"] += b - a
            continue
        mid = 0.5 * (a + b)
        labels = set()
        for th in threads.values():
            inner = th.open_at(mid)
            if inner:
                labels.add(base_name(inner[-1][2]))
        if len(labels) > 1:   # the load generator waits whenever it can
            labels.discard("loadgen.wait")
        idle["+".join(sorted(labels)) or "no span"] += b - a
    ns = 1e-9
    agg = collections.Counter()
    for k, v in span_ns.items():
        agg[base_name(k)] += v * ns
    return {
        "window_s": (w1 - w0) * ns,
        "busy_s": busy * ns,
        "device_s": sum(by_op.values()) * ns,
        "linked_device_s": linked_ns * ns,
        "unplaced_device_s": unplaced_ns * ns,
        "span_device_s": {k: v * ns for k, v in span_ns.items()},
        "span_totals_s": dict(agg),
        "device_ops": [[n, t * ns] for n, t in by_op.most_common(top)],
        "idle_gaps": [[n, t * ns] for n, t in idle.most_common(top)],
    }
