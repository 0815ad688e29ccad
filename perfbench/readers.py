"""Shared arithmetic of the per-layer metrics' readers
(``metrics/<name>.py``). A reader returns None where it finds nothing to
read, and the metric is then left out of the line."""
from __future__ import annotations

from perfbench import flops


def copies_per_request(run) -> float | None:
    """Copies dispatched per request over the window, from the service's
    own counters: each hedged request sends one copy more (k <= 2)."""
    st = run.window.stats
    if not st.get("total"):
        return None
    return (st["total"] + st["hedged"]) / st["total"]


def decode_step_ms(run) -> float | None:
    """Mean host time of a decode step: from one ``decode_step`` call to
    the next within a copy (the last step: to the copy's end), over the
    copies begun in the window that finished."""
    w = run.window
    steps = []
    for c in run.copies:
        if c.out is None or not c.steps or not w.start <= c.t_start <= w.close:
            continue
        marks = c.steps + [c.t_end]
        steps += [b - a for a, b in zip(marks, marks[1:])]
    return 1e3 * sum(steps) / len(steps) if steps else None


def mfu(run) -> float | None:
    """Model FLOPs of the requests finished in the window over the
    window, as a share (%) of the card's dense bf16 peak."""
    if run.peak is None:
        return None
    w = run.window
    done = [r for r in w.records
            if r["done"] is not None and r["done"] <= w.close]
    if not done:
        return None
    total = sum(flops.request_flops(run.port, r["item"].prompt_len,
                                    r["item"].new_tokens) for r in done)
    return 100.0 * total / (w.close - w.start) / run.peak["bf16_flops_per_s"]


def span_share(run, name: str) -> float | None:
    """Device time linked to the calls of span ``name`` as a share (%)
    of all device time in the traced window."""
    tr = run.trace
    if tr is None or not tr["device_s"] or name not in tr["span_device_s"]:
        return None
    return 100.0 * tr["span_device_s"][name] / tr["device_s"]


def attention_roofline(run, kind: str) -> float | None:
    """Sum of the calls' bounds over the sum of the device time linked
    to them (%), over the calls of ``kind`` (``attention`` or
    ``attention.decode``) that the trace holds."""
    tr = run.trace
    if tr is None or run.peak is None:
        return None
    bound = spent = 0.0
    for name, (b, s, h, kv, hd, live) in run.attn_bounds.items():
        if name.split(":")[0] != kind:
            continue
        t = tr["span_device_s"].get(name)
        if not t:
            continue
        spent += t
        bound += (flops.flash_bound_s(b, s, h, kv, hd, run.peak)
                  if kind == "attention" else
                  flops.decode_bound_s(b, h, kv, hd, live, run.peak))
    return 100.0 * bound / spent if spent else None


def idle_share(run) -> float | None:
    """Share (%) of the traced window in which the card ran nothing."""
    tr = run.trace
    if tr is None or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
