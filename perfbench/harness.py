"""One run of one cell: set-up, the measured window, the check.

``prepare`` builds the program's hedged service over the cell's
replicas on weights drawn from the seed and sends one warm request of
the cell's longest shape (both replicas run it: an idle pool hedges).
``run_window`` offers the mix for ``seconds``: in an open loop each
request is submitted at its due time and timed from it; in a closed
loop each client sends its next request when its reply arrives. It then
waits for every request sent, a minute past the close at most.
``check`` decides ``correct`` (``perfbench.check``). ``run_cell`` does
all of it and returns the result line.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import sys
import threading
import time

import numpy as np

from perfbench import check as checks
from perfbench import (instrument, loadgen, peaks, readers, spec, trace,
                       weights)

DRAIN_S = 60.0
# the traced window's share of the run's length: stopping the profiler and
# reading its trace take 75-135 s for a 45 s window on the card's host
TRACED_SHARE = 0.5
# the columns of every served logits row kept for the check
KEPT_COLUMNS = 8192


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def model_config(port: dict):
    """The program's ``ModelConfig`` from a configuration's ``port``."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    kw = dict(port)
    for key in ("pattern", "prefix", "suffix"):
        if key in kw:
            kw[key] = tuple(kw[key])
    if kw.get("moe"):
        kw["moe"] = MoEConfig(**kw["moe"])
    return ModelConfig(**kw)


@dataclasses.dataclass
class Setup:
    cell: spec.Cell
    device: object
    port: dict
    ref: object
    params: dict
    recorder: instrument.Recorder
    service: object
    items: list
    prompts: list
    build_s: float
    peak: dict | None
    kind: str
    schedule_s: float = 0.0   # an open loop's next window starts here
    next_item: int = 0        # a closed loop's next window starts here


def prepare(cell: spec.Cell, seed: int, device, trace_on: bool,
            rate: float | None = None) -> Setup:
    import torch
    from repro_torch.core.hedging import HedgePolicy
    from repro_torch.models import layers, lm
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.service import BatchedHedgedService

    conf, mix = cell.config, cell.traffic
    port, assumed = conf["port"], conf["assumed"]
    ref = spec.reference(conf["reference"])
    build_s = 0.0
    if device.type == "cuda":
        from repro_torch.kernels import build
        t = time.perf_counter()
        built = build.build_all()
        build_s = time.perf_counter() - t if built else 0.0
        log(f"build: {sorted(built) or 'every kernel library found built'}"
            f" in {build_s:.1f} s")
    cfg = model_config(port)
    if loadgen.max_positions(mix) > assumed["max_len"]:
        raise ValueError("the mix's longest request does not fit max_len")
    model = lm.init(layers.MetaGenerator(), cfg)
    params = weights.materialize(model, seed, device, ref.fan_in)
    rec = instrument.Recorder(trace_on)
    gen = torch.Generator().manual_seed(abs(int(seed)) % 2**63)
    rec.cols = torch.randperm(port["vocab_size"], generator=gen)[
        :KEPT_COLUMNS].sort().values.to(device)
    rec.install()
    engines = [instrument.RecordingEngine(
        InferenceEngine(cfg, model, max_len=assumed["max_len"],
                        name=f"replica{i}", device=device), rec)
        for i in range(assumed["replicas"])]
    hedge = assumed["hedge"]
    service = BatchedHedgedService(
        engines, policy=HedgePolicy(max_k=hedge["max_k"],
                                    threshold=hedge["threshold"]),
        seed=int(mix["schedule_seed"]))
    items = loadgen.schedule(mix, rate if rate is not None
                             else loadgen.rate(mix, cell.own))
    prompts = loadgen.prompts(items, port["vocab_size"], seed)
    # the warm request: the longest shape of the schedule, on every replica
    longest = max(range(len(items)), key=lambda i: items[i].prompt_len)
    warm_tokens = (prompts[longest][::-1] + 1) % port["vocab_size"]
    req = service.submit(warm_tokens, max(it.new_tokens for it in items))
    if not req.done_event.wait(600) or req.failed:
        raise RuntimeError("the warm request did not complete")
    _wait_idle(service)
    _counted(service, 1)
    if device.type == "cuda":
        torch.cuda.synchronize()
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    with rec.lock:
        rec.copies.clear()
    return Setup(cell, device, port, ref, params, rec, service, items,
                 prompts, build_s, peaks.peaks(kind), kind)


def _counted(service, n: int, timeout: float = 10.0) -> int:
    """The service's count of completions once it reaches ``n``, or as
    it stands when ``timeout`` runs out: the service counts a request
    after it has woken the request's waiters."""
    end = time.monotonic() + timeout
    while True:
        got = service.telemetry.counters["completions"]
        if got >= n or time.monotonic() >= end:
            return got
        time.sleep(0.005)


def _wait_idle(service, timeout: float = 600.0) -> None:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if service.tracker.utilization() == 0 and not any(
                w.is_busy() or w.queue_depth() for g in service._groups
                for w in g):
            return
        time.sleep(0.005)
    raise RuntimeError("the replicas did not go idle")


@dataclasses.dataclass
class Window:
    start: float
    close: float
    records: list           # one dict a request sent
    stats: dict             # the service's counters over the window
    completions: int        # the service's completions over the window
    lateness_s: list
    trace: dict | None = None


class _Tracer:
    """The profiler over the window, on every thread (the replicas run
    on the service's worker threads)."""

    def __init__(self):
        self.prof = self.span = None
        self.exit_s = 0.0

    def start(self) -> None:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self.prof.__enter__()

    def open_window(self, rec) -> None:
        if self.prof is not None:
            self.span = rec.span(trace.WINDOW)
            self.span.__enter__()

    def stop(self, device) -> None:
        if self.prof is None:
            return
        self.span.__exit__(None, None, None)
        t = time.perf_counter()
        if device.type == "cuda":
            import torch
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.exit_s = time.perf_counter() - t


def _stamp_on_done(rec: dict, deadline: float) -> None:
    if rec["req"].done_event.wait(max(deadline - time.perf_counter(), 0)):
        rec["done"] = time.perf_counter()


def run_window(s: Setup, seconds: float, traced: bool = False) -> Window:
    """One window of the mix, from where the last window left its
    schedule; ``traced``: under the profiler, with the benchmark's
    spans."""
    mix = s.cell.traffic
    svc, rec = s.service, s.recorder
    stats0 = dict(svc.stats)
    comp0 = svc.telemetry.counters["completions"]
    tracer = _Tracer()
    if traced:
        tracer.start()   # before the window: starting takes seconds
        rec.active = True
    start = time.perf_counter()
    tracer.open_window(rec)
    close = start + seconds
    deadline = close + DRAIN_S
    records, waiters, late = [], [], []

    def wait_until(t):
        with rec.span("loadgen.wait"):
            time.sleep(max(t - time.perf_counter(), 0.0))

    if mix["loop"] == "open":
        base = s.schedule_s
        for it in s.items:
            if it.due_s < base:
                continue
            if it.due_s >= base + seconds:
                break
            due = start + it.due_s - base
            wait_until(due)
            with rec.span("service.submit"):
                req = svc.submit(s.prompts[it.index], it.new_tokens)
            late.append(time.perf_counter() - due)
            r = {"item": it, "req": req, "due": due, "done": None}
            records.append(r)
            t = threading.Thread(target=_stamp_on_done, args=(r, deadline),
                                 daemon=True)
            t.start()
            waiters.append(t)
        else:
            raise RuntimeError("the schedule ran out inside the window")
        s.schedule_s = base + seconds
        wait_until(close)
    else:
        lock = threading.Lock()
        nxt = iter(s.items[s.next_item:])
        ran_out = []

        def client():
            while True:
                with lock:
                    if time.perf_counter() >= close:
                        return
                    it = next(nxt, None)
                    if it is None:
                        ran_out.append(True)
                        return
                    with rec.span("service.submit"):
                        req = svc.submit(s.prompts[it.index], it.new_tokens)
                    r = {"item": it, "req": req, "due": None, "done": None}
                    records.append(r)
                _stamp_on_done(r, deadline)
                if r["done"] is None:
                    return
        waiters = [threading.Thread(target=client, daemon=True)
                   for _ in range(int(mix["clients"]))]
        for t in waiters:
            t.start()
        wait_until(close)
        if ran_out:
            raise RuntimeError("the schedule ran out inside the window")
    tracer.stop(s.device)
    rec.active = False
    for t in waiters:
        t.join(max(deadline - time.perf_counter(), 0.0) + 1.0)
    s.next_item += len(records)
    finished = sum(r["req"].done_event.is_set() and not r["req"].failed
                   for r in records)
    comp = _counted(svc, comp0 + finished) - comp0
    stats = {k: v - stats0.get(k, 0) for k, v in svc.stats.items()}
    w = Window(start, close, records, stats, comp, late)
    if tracer.prof is not None:
        t = time.perf_counter()
        w.trace = trace.analyse(tracer.prof.profiler.kineto_results.events())
        tr = w.trace
        log(f"trace: stopped in {tracer.exit_s:.1f} s, read in "
            f"{time.perf_counter() - t:.1f} s; device {tr['device_s']:.4f} s,"
            f" linked to its launch {tr['linked_device_s']:.4f} s, placed by "
            f"stream order {tr['device_s'] - tr['linked_device_s'] - tr['unplaced_device_s']:.4f} s,"
            f" not placed {tr['unplaced_device_s']:.4f} s; by span "
            f"{tr['span_totals_s']}")
    return w


def end_to_end(s: Setup, w: Window, setup_s: float) -> dict:
    """The cell's end-to-end metrics, by name."""
    names = [m["name"] for m in s.cell.end_to_end]
    timed = [r for r in w.records if r["due"] is not None]
    # a request that never came makes the latencies unmeasured
    lat = ([r["done"] - r["due"] for r in timed]
           if all(r["done"] is not None for r in timed) else [])
    done_in = [r for r in w.records
               if r["done"] is not None and r["done"] <= w.close]
    out = {}
    for m in s.cell.end_to_end:
        n = m["name"]
        if n == "setup_s":
            v = setup_s
        elif n == "latency_mean_ms":
            v = float(np.mean(lat)) * 1e3 if lat else None
        elif n.startswith("latency_p") and n.endswith("_ms"):
            q = int(n[len("latency_p"):-len("_ms")]) / 100  # nearest rank
            v = sorted(lat)[math.ceil(q * len(lat)) - 1] * 1e3 if lat else None
        elif n.split(".")[0] == "tokens_per_s":
            v = sum(r["item"].prompt_len + r["item"].new_tokens
                    for r in done_in) / (w.close - w.start)
        else:
            raise KeyError(f"no measurement for end-to-end metric {n!r}")
        if v is not None:
            out[n] = {"value": v, "unit": m["unit"]}
    missing = set(names) - set(out)
    if missing:
        log(f"end-to-end metrics not measured: {sorted(missing)}")
    return out


@dataclasses.dataclass
class RunData:
    """What a per-layer metric's reader reads: the untraced window (its
    requests, the service's counters, the copies' host stamps) and the
    parsed trace of the traced window."""
    cell: spec.Cell
    port: dict
    window: Window
    copies: list
    attn_bounds: dict
    peak: dict | None
    trace: dict | None = None


def per_layer(s: Setup, w: Window, traced: Window) -> dict:
    data = RunData(s.cell, s.port, w, list(s.recorder.copies),
                   dict(s.recorder.attn_bounds), s.peak, traced.trace)
    out = {}
    for m in s.cell.per_layer:
        v = spec.metric_reader(m["name"])(data)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def teardown(s: Setup) -> None:
    """Stop the service's threads, put the program's functions back and
    free its state (the weights stay: the reference reads them)."""
    s.service.shutdown()
    s.recorder.restore()
    s.service = None
    gc.collect()
    if s.device.type == "cuda":
        import torch
        torch.cuda.empty_cache()


def _decode_step_ms(s: Setup, w: Window) -> float | None:
    return readers.decode_step_ms(RunData(
        s.cell, s.port, w, list(s.recorder.copies), {}, s.peak))


def run_cell(name: str, seed: int, seconds: float, trace_on: bool,
             device, t0: float) -> dict:
    """One run of cell ``name``; returns the result line's object. With
    ``trace_on`` the run measures two windows, the mix's schedule running
    on from one to the next: the per-layer metrics read on the host clock
    come from the first, of ``seconds`` and untraced, and those read from
    the trace from the second, of ``TRACED_SHARE`` of it, under the
    profiler, whose cost on the host would slow the host-paced steps that
    the first times."""
    import torch
    cell = spec.find_cell(name)
    s = prepare(cell, seed, device, trace_on)
    # the kernels' build, once a checkout, is recorded apart
    setup_s = time.perf_counter() - t0 - s.build_s
    log(f"setup: {setup_s:.3f} s, and apart from it the kernels' build "
        f"{s.build_s:.3f} s")
    windows = [run_window(s, seconds)]
    if trace_on:
        windows.append(run_window(s, TRACED_SHARE * seconds, traced=True))
    for w, what in zip(windows, ("", " (traced window)")):
        step_ms = _decode_step_ms(s, w)
        if step_ms is not None:
            log(f"engine: decode step {step_ms:.3f} ms on the host clock, "
                f"mean over the copies begun in the window{what}")
    late = np.asarray([x for w in windows for x in w.lateness_s]) * 1e3
    if late.size:
        log(f"loadgen: {len(late)} requests due in the window, sent late by "
            f"p50 {np.percentile(late, 50):.3f} ms, p99 "
            f"{np.percentile(late, 99):.3f} ms, max {late.max():.3f} ms")
    mem = (torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else 0)
    w = windows[0]
    metrics = (per_layer(s, w, windows[-1]) if trace_on
               else end_to_end(s, w, setup_s))
    teardown(s)
    # every window's requests are the timed path's
    every = dataclasses.replace(
        w, records=[r for x in windows for r in x.records],
        completions=sum(x.completions for x in windows))
    verdict = checks.check(s, every, seed)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": s.kind, "count": cell.chips, "memory_peak_bytes": int(mem)}
    result = {"correct": verdict["correct"],
              "attempted": len(every.records),
              "failed": verdict["failed"], "metrics": metrics, "device": dev}
    traced = windows[-1].trace
    if traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["check"] = verdict["numbers"]
    return result


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi not read: {e}"
    return f"card: {out}"
