"""Per-copy spans beneath the serving layer's request records
(``serving.metrics``: ``RequestTrace``, ``CopySpan``, ``Span``).

One ``BatchedHedgedService`` over two ``InferenceEngine`` replicas of the
granite MoE smoke model serves a burst of requests at k=2, and each check
reads the burst's traces; beside it the switch, a replica that raises, the
profiler's view of the spans and the ``launch.serve`` export.
"""
import importlib.util
import json
import math
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_smoke_config
from repro_torch.core.hedging import HedgePolicy
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.serving.metrics import CopySpan
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.scheduler import HedgedScheduler
from repro_torch.serving.service import BatchedHedgedService

NEW_TOKENS = 3


@pytest.fixture(scope="module")
def replicas():
    cfg = get_smoke_config("granite-moe-3b-a800m")
    model = lm.init(torch.Generator().manual_seed(0), cfg)
    return cfg, [InferenceEngine(cfg, model, max_len=32, name=f"replica{i}",
                                 device="cpu") for i in range(2)]


def serve_burst(replicas, n, trace=True):
    """``n`` requests at once, prompts of 3, 4, ... tokens, two copies each
    (a utilization never reaches the shed watermark of 2); every copy has
    its outcome once the service has shut down."""
    cfg, engines = replicas
    svc = BatchedHedgedService(engines, k=2, seed=0, trace=trace,
                               shed_watermark=2.0)
    rng = np.random.default_rng(1)
    try:
        reqs = [svc.submit(rng.integers(0, cfg.vocab_size, 3 + i)
                           .astype(np.int32), NEW_TOKENS) for i in range(n)]
        for r in reqs:
            svc.result(r, timeout=60)
    finally:
        svc.shutdown()
    return reqs


@pytest.fixture(scope="module")
def burst(replicas):
    return serve_burst(replicas, 8)


def started(reqs):
    return [(r, c) for r in reqs for c in r.trace.copies
            if c.outcome != "cancelled"]


def one_copy_span_per_copy_and_one_winner(reqs):
    for r in reqs:
        tr = r.trace
        assert tr.rid == r.rid and tr.k == 2 and not tr.shed
        assert 0.0 <= tr.utilization <= 1.0
        assert len(tr.copies) == 2
        assert {c.replica for c in tr.copies} == {"replica0", "replica1"}
        assert sorted(c.priority for c in tr.copies) == [0, 1]
        assert {c.name for c in tr.copies} == {"repro.copy"}
        assert {c.outcome for c in tr.copies} <= {"won", "lost",
                                                  "cancelled"}
        won = [c for c in tr.copies if c.outcome == "won"]
        assert len(won) == 1 and won[0].replica == r.completed_by


def cancelled_copy_has_no_prefill(reqs):
    cancelled = [c for r in reqs for c in r.trace.copies
                 if c.outcome == "cancelled"]
    assert cancelled  # the duplicates queued behind the primaries
    for c in cancelled:
        assert c.spans == [] and c.prompt_tokens == 0 and c.tokens == 0
        assert math.isnan(c.start) and c.queue.end >= c.queue.start


def spans_nest_and_stamps_are_monotone(reqs):
    for r, c in started(reqs):
        assert r.trace.t_submit <= c.queue.start <= c.queue.end == c.start
        assert c.start <= c.spans[0].start and c.spans[-1].end <= c.end
        for a, b in zip(c.spans, c.spans[1:]):
            assert a.start <= a.end <= b.start <= b.end
        assert all(s.parent is c for s in c.spans)
        assert c.queue.parent is None and c.parent is None


def enqueue_and_sync_cover_each_step(reqs):
    for r, c in started(reqs):
        names = [s.name for s in c.spans]
        assert names[:2] == ["repro.prefill", "repro.prefill.sync"]
        assert names[2:] == ["repro.decode", "repro.decode.sync"] * (
            len(names) // 2 - 1)
        for enq, sync in zip(c.spans[::2], c.spans[1::2]):
            assert sync.name == enq.name + ".sync"
            assert sync.start == enq.end   # one stamp: nothing between
            assert 0 < enq.counters["moe_ns"] <= enq.seconds * 1e9
            assert not sync.counters
        assert c.t_first_token == c.spans[1].end
        assert c.tokens == len(names) // 2
        if c.outcome == "won":
            assert c.tokens == NEW_TOKENS == len(r.out_tokens)


def replicas_write_only_their_own_spans(reqs):
    # each prompt has its own length: a span written by the other
    # replica's thread would carry another request's prompt
    assert len({len(r.tokens) for r in reqs}) == len(reqs)
    for r, c in started(reqs):
        assert c.prompt_tokens == len(r.tokens)
    by_replica = {}
    for _, c in started(reqs):
        by_replica.setdefault(c.replica, []).append(c)
    for cs in by_replica.values():   # one worker runs one copy at a time
        cs.sort(key=lambda c: c.start)
        assert all(a.end <= b.start for a, b in zip(cs, cs[1:]))


@pytest.mark.parametrize("check", [
    one_copy_span_per_copy_and_one_winner, cancelled_copy_has_no_prefill,
    spans_nest_and_stamps_are_monotone, enqueue_and_sync_cover_each_step,
    replicas_write_only_their_own_spans], ids=lambda f: f.__name__)
def test_burst_traces(burst, check):
    check(burst)


def test_trace_off_leaves_no_trace(replicas):
    assert all(r.trace is None for r in serve_burst(replicas, 2, False))
    cfg, engines = replicas
    sched = HedgedScheduler(engines, trace=False)
    try:
        req = sched.submit(np.arange(4, dtype=np.int32), 2, timeout=60)
    finally:
        sched.shutdown()
    assert req.trace is None and len(req.out_tokens) == 2
    assert tracing.current_copy() is tracing.NO_COPY


class _Raises:
    name = "broken"

    def generate(self, prompt, max_new_tokens=16, check_cancel=None):
        tracing.current_copy().enqueue("repro.prefill", len(prompt))
        raise RuntimeError("replica down")


def test_a_replica_that_raises_closes_its_copy_as_failed(replicas):
    cfg, engines = replicas
    # k=2 at any load, never shed: each request reaches both replicas
    sched = HedgedScheduler([_Raises(), engines[0]], seed=0,
                            policy=HedgePolicy(max_k=2, threshold=3.0),
                            shed_watermark=2.0)
    try:
        reqs = [sched.submit(np.arange(3 + i, dtype=np.int32), 2,
                             timeout=60) for i in range(3)]
    finally:
        sched.shutdown()
    broken = [c for r in reqs for c in r.trace.copies
              if c.replica == "broken" and c.outcome != "cancelled"]
    assert broken and all(c.outcome == "failed" for c in broken)
    for c in broken:   # the step open when it raised is closed with it
        assert c.spans[-1].end == c.end and c.tokens == 0
    assert all(r.completed_by == "replica0" for r in reqs)


def test_moe_counter_counts_only_inside_a_steps_enqueue():
    def moe_call():
        with tracing.counted_in_step("moe_ns", "repro.moe"):
            pass

    moe_call()                      # a thread with no copy: nothing
    copy = CopySpan("replica0", 0, 0.0)
    copy.begin()
    try:
        copy.enqueue("repro.prefill", 4)
        moe_call()
        moe_call()
        copy.wait()
        moe_call()                  # waiting for the token: not counted
        copy.token()
        copy.enqueue("repro.decode")
        copy.wait()
        copy.token()
    finally:
        copy.finish("won")
    assert tracing.current_copy() is tracing.NO_COPY
    prefill, prefill_sync, decode, decode_sync = copy.spans
    assert 0 < prefill.counters["moe_ns"] <= prefill.seconds * 1e9
    assert not (prefill_sync.counters or decode.counters
                or decode_sync.counters)


def _base_name():
    path = Path(__file__).resolve().parents[1] / "perfbench" / "trace.py"
    spec = importlib.util.spec_from_file_location("perfbench_trace", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.base_name


def test_spans_enter_the_profiler_on_the_worker_threads(replicas):
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        serve_burst(replicas, 1)
    events = [(e.name(), e.start_thread_id())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("repro.")]
    names = {n for n, _ in events}
    assert names >= {"repro.copy", "repro.prefill", "repro.prefill.sync",
                     "repro.decode", "repro.decode.sync", "repro.moe"}
    assert threading.get_native_id() not in {t for _, t in events}
    base_name = _base_name()   # the benchmark's own spans: none of these
    assert all(base_name(n) is None for n in names)


def test_serve_writes_one_trace_line_a_request(tmp_path):
    out = tmp_path / "trace.jsonl"
    serve.main(["--arch", "granite-moe-3b-a800m", "--smoke", "--replicas",
                "2", "--requests", "3", "--max-new-tokens", "2",
                "--device", "cpu", "--trace-out", str(out)])
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["rid"] for r in rows] == [0, 1, 2]
    for r in rows:
        assert r["k"] >= 1 and r["t_submit"] > 0
        assert [c["outcome"] for c in r["copies"]].count("won") == 1
        won = next(c for c in r["copies"] if c["outcome"] == "won")
        assert won["prompt_tokens"] == 16 and won["tokens"] == 2
        names = [s["name"] for s in won["spans"]]
        assert names == ["repro.queue", "repro.copy", "repro.prefill",
                         "repro.prefill.sync", "repro.decode",
                         "repro.decode.sync"]
        assert won["spans"][2]["parent"] == "repro.copy"
        assert set(won["spans"][2]["counters"]) == {"moe_ns"}
