"""The load generator: the schedule is the mix's alone (the same for
every ``--seed``), the seed draws the token ids, and an open loop times a
request from its due time."""
from __future__ import annotations

import threading
import time
import types

import numpy as np

from perfbench import harness, loadgen

MIX = {"loop": "open", "arrivals": "poisson", "rate_share": 0.8,
       "prompt_len": {"dist": "log_uniform", "lo": 1024, "hi": 4088},
       "new_tokens": {"dist": "uniform_int", "lo": 1, "hi": 4},
       "requests": 4000, "schedule_seed": 11}


def test_same_mix_same_schedule_and_the_rate_scales_it():
    a, b = loadgen.schedule(MIX, 2.0), loadgen.schedule(MIX, 4.0)
    assert [(x.prompt_len, x.new_tokens) for x in a] == [
        (x.prompt_len, x.new_tokens) for x in b]
    assert np.allclose([x.due_s for x in a], [2 * x.due_s for x in b])
    assert a[0].due_s == 0.0
    gaps = np.diff([x.due_s for x in a])
    assert abs(np.mean(gaps) - 0.5) < 0.03  # 1 / rate
    lens = np.array([x.prompt_len for x in a])
    assert lens.min() >= 1024 and lens.max() <= 4088
    assert abs(lens.mean() - 3064 / np.log(4089 / 1024)) < 60  # ~2,213
    assert {x.new_tokens for x in a} == {1, 2, 3, 4}
    other = dict(MIX, schedule_seed=12)
    assert [x.prompt_len for x in loadgen.schedule(other, 2.0)] != list(lens)


def test_seed_draws_the_tokens():
    items = loadgen.schedule(MIX, 1.0)[:20]
    p1 = loadgen.prompts(items, 256_000, 2**31 + 5)
    p2 = loadgen.prompts(items, 256_000, 2**31 + 5)
    p3 = loadgen.prompts(items, 256_000, 2**31 + 6)
    assert all(np.array_equal(x, y) for x, y in zip(p1, p2))
    assert not all(np.array_equal(x, y) for x, y in zip(p1, p3))
    assert [len(x) for x in p1] == [it.prompt_len for it in items]
    assert max(int(x.max()) for x in p1) < 256_000


def test_cell_rate_is_the_share_of_the_sustained_rate():
    assert loadgen.rate(MIX, {"sustained_rate_per_s": 5.0}) == 4.0
    assert loadgen.rate(dict(MIX, loop="closed"), {}) is None
    assert loadgen.max_positions(MIX) == 4091


class _StallingService:
    """Finishes each request 20 ms after its submit, but its first
    submit blocks the caller for 200 ms (a stall)."""

    def __init__(self):
        self.stats = {"total": 0, "hedged": 0}
        self.telemetry = types.SimpleNamespace(counters={"completions": 0})
        self.n = 0

    def submit(self, tokens, new):
        self.n += 1
        if self.n == 1:
            time.sleep(0.2)
        req = types.SimpleNamespace(done_event=threading.Event(),
                                    failed=False)

        def done():
            req.done_event.set()
            self.telemetry.counters["completions"] += 1
        threading.Timer(0.02, done).start()
        return req


def test_open_loop_latency_runs_from_the_due_time():
    mix = dict(MIX, requests=400)
    items = loadgen.schedule(mix, 100.0)
    s = types.SimpleNamespace(
        cell=types.SimpleNamespace(traffic=mix, end_to_end=[
            {"name": "latency_mean_ms", "unit": "ms"}]),
        service=_StallingService(), prompts=[None] * len(items),
        items=items, schedule_s=0.0, next_item=0,
        device=types.SimpleNamespace(type="cpu"),
        recorder=types.SimpleNamespace(trace=False, span=lambda n: _Null()))
    w = harness.run_window(s, 0.5)
    lat = [r["done"] - r["due"] for r in w.records]
    due = [r["item"].due_s for r in w.records]
    assert due[-1] < 0.5 and len(w.records) == sum(d < 0.5 for d in due)
    # the requests due during the stall were sent late and waited for it
    stalled = [x for x, d in zip(lat, due) if 0.0 < d < 0.1]
    assert stalled and min(stalled) > 0.1
    assert max(w.lateness_s) > 0.15
    m = harness.end_to_end(s, w, 1.0)["latency_mean_ms"]["value"]
    assert m > 1e3 * np.mean([0.02] * len(lat))


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False
