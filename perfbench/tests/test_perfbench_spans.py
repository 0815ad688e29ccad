"""The per-layer metrics read from the program's own spans and counters
(``perfbench/spans.py``): their arithmetic on a made-up trace, nothing
read (and nothing raised) where the requests carry no trace, as the
program's ``trace=False`` or a program without the spans leaves them, and
a traced run of the dense and of the MoE smoke cell on the CPU that reads
a number for every one of them its cell lists."""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from perfbench import spec
from perfbench.tests import helpers
from perfbench.tests.test_perfbench_cell import (CLOSED_MIX, LIMITS,
                                                 MOE_LIMITS, OPEN_MIX)
from repro_torch.serving.metrics import CopySpan, RequestTrace, Span

# each metric's value on the made-up trace below
EXPECTED = {
    "queue_wait_ms.lat": 1e3 * (0.1 + 0.3 + 0.1) / 3,
    "loser_prefill_share.lat": 100.0 * 100 / 250,
    "ttft_ms.lat": 1e3 * (0.4 + 0.5) / 2,
    "decode_enqueue_ms.lat": 40.0, "decode_enqueue_ms.batch": 40.0,
    "decode_overlap_ms.lat": 30.0, "decode_overlap_ms.batch": 30.0,
    "decode_sync_ms.lat": 140.0 / 3, "decode_sync_ms.batch": 140.0 / 3,
    "moe_enqueue_ms.batch": 10.0,
}
DENSE_CELL = {"queue_wait_ms.lat", "loser_prefill_share.lat", "ttft_ms.lat",
              "decode_enqueue_ms.lat", "decode_overlap_ms.lat",
              "decode_sync_ms.lat"}
MOE_CELL = {"decode_enqueue_ms.batch", "decode_overlap_ms.batch",
            "decode_sync_ms.batch", "moe_enqueue_ms.batch"}


def _copy(replica, t_queued, t_start, outcome, prompt, steps):
    """A finished copy: ``steps`` of (enqueue s, sync s, MoE ms), the
    first its prefill."""
    c = CopySpan(replica, 0, t_queued)
    c.queue.end = c.start = t = t_start
    c.outcome, c.prompt_tokens = outcome, prompt
    for i, (enq, sync, moe_ms) in enumerate(steps):
        name = "repro.prefill" if i == 0 else "repro.decode"
        s = Span(name, t, c)
        s.end = t + enq
        s.counters = {"moe_ns": int(moe_ms * 1e6)}
        y = Span(name + ".sync", s.end, c)
        y.end = t = s.end + sync
        c.spans += [s, y]
        if math.isnan(c.t_first_token):
            c.t_first_token = t
    c.end = t
    return c


def _run(traced: bool):
    # replica0 enqueues its decode steps over 0.40-0.43 and 0.48-0.53 s,
    # replica1 its prefill over 0.30-0.50 s: 30 and 20 ms overlapped;
    # replica1's decode step over 0.60-0.64 s lies inside replica0's
    # prefill (0.60-0.90 s): 40 ms
    a = RequestTrace(0, 0.0)
    a.copies = [
        _copy("replica0", 0.0, 0.1, "won", 100,
              [(0.2, 0.1, 0), (0.03, 0.05, 20), (0.05, 0.07, 10)]),
        _copy("replica1", 0.0, 0.3, "lost", 100,
              [(0.2, 0.1, 0), (0.04, 0.02, 0)]),
        CopySpan("replica1", 1, 0.0)]                 # queued, never run
    a.copies[2].drop()
    b = RequestTrace(1, 0.5)
    b.copies = [_copy("replica0", 0.5, 0.6, "won", 50, [(0.3, 0.1, 0)])]
    c = RequestTrace(2, 0.9)                          # began past the close
    c.copies = [_copy("replica0", 0.9, 2.0, "won", 70,
                      [(0.1, 0.1, 0), (1.0, 1.0, 5)])]
    reqs = [SimpleNamespace(trace=t) if traced else SimpleNamespace()
            for t in (a, b, c)]
    window = SimpleNamespace(start=0.0, close=1.0,
                             records=[{"req": r} for r in reqs])
    return SimpleNamespace(window=window)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_arithmetic_on_a_made_up_trace(name):
    got = spec.metric_reader(name)(_run(traced=True))
    assert got == pytest.approx(EXPECTED[name], rel=1e-6)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_nothing_without_the_programs_trace(name):
    assert spec.metric_reader(name)(_run(traced=False)) is None


def test_every_reader_of_the_programs_spans_is_listed():
    listed = {m["name"]: m for m in spec.load_spec()["per_layer"]
              if m["source"] in ("program_span", "program_counter")}
    assert set(EXPECTED) <= set(listed)
    assert {n for n in EXPECTED if listed[n]["workloads"] ==
            ["nemotron-4-15b.docqa-r50"]} == DENSE_CELL


FAMILIES = {
    "dense": (helpers.TINY_DENSE, "dense_gqa", OPEN_MIX, LIMITS, "float32",
              DENSE_CELL),
    "moe": (helpers.TINY_MOE, "moe_gqa", CLOSED_MIX, MOE_LIMITS, "bf16",
            MOE_CELL)}

# both smoke cells traced in one fresh process, as ``helpers.run_cpu``
# runs one: the program's import is paid once
RUNNER = """
import json, sys, time
sys.path[:0] = ['.', 'src']
import torch
from perfbench import harness
out = {}
for cell in sys.argv[2:]:
    out[cell] = harness.run_cell(cell, int(sys.argv[1]), 1.0, True,
                                 torch.device('cpu'), time.perf_counter())
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Each family's cell, its span metrics as BENCHMARK.json lists them,
    and its traced run."""
    root = helpers.checkout(tmp_path_factory.mktemp("spans"))
    cells = {}
    for family, (port, ref, mix, limits, precision, _) in FAMILIES.items():
        cells[family] = helpers.add_cell(
            root, f"spans-{family}", port, ref, mix,
            {"sustained_rate_per_s": 40.0, "limits": limits},
            precision=precision)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    p = subprocess.run([sys.executable, "-c", RUNNER, str(2**31 + 23),
                        *cells.values()], cwd=root, env=env,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-4000:]
    runs = json.loads(p.stdout.strip().splitlines()[-1])
    per_layer = spec.load_spec(root)["per_layer"]
    return {f: ({m["name"] for m in per_layer if c in m["workloads"]}
                & set(EXPECTED), runs[c]) for f, c in cells.items()}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_traced_smoke_cell_reads_every_listed_span_metric(traced, family):
    listed, r = traced[family]
    want = FAMILIES[family][-1]
    assert listed == want
    assert r["correct"], r["check"]
    for name in want:
        v = r["metrics"][name]["value"]
        assert math.isfinite(v) and v >= 0, (name, v)
