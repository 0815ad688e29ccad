"""Serve a model through the BATCHED hedged service: pooled transfer
buffers, non-blocking submits, and an online controller that picks the
replication factor from engine sweeps — then open-loop trace replays on
the model's replicas (adaptive, and static k=2 with one replica crashed
a third of the way in), and a chaos segment where two simulated replicas
stall and the controller backs replication off.

On the card (gemma2-2b at full width and depth, random weights from the
port's init; the replicas run its attention kernels, the policy table
runs ``cell_update``):

    PYTHONPATH=src python -m repro_torch.examples.serve_hedged

On the CPU (the smoke model, plain paths):

    PYTHONPATH=src python -m repro_torch.examples.serve_hedged --smoke --device cpu

``live_replay`` and ``check_tokens`` are the pieces ``chip_smoke.py``'s
phase 14 drives at full width.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import base as cfgbase
from repro_torch.core import distributions as dists
from repro_torch.core import queueing, threshold
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serving.controller import AdaptiveController, PolicyTable
from repro_torch.serving.engine import InferenceEngine, SimulatedEngine
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.metrics import Telemetry
from repro_torch.serving.replay import poisson_trace, replay_live
from repro_torch.serving.service import BatchedHedgedService

PROMPT_LEN = 16
NEW_TOKENS = 4
# A static k=2 run sends every request to two replicas: no shedding (at
# the service's default watermark of 1.0 it sheds duplicates while every
# replica is busy, and a shed request that lands on a crashed replica
# fails).
STATIC_NO_SHED = 2.0


class SlowWrapper:
    """A replica with an injected 150 ms stall (multi-tenant interference)."""

    def __init__(self, inner, stall_s=0.15):
        self.inner = inner
        self.stall_s = stall_s
        self.name = inner.name + "-slow"

    def generate(self, *args, **kwargs):
        time.sleep(self.stall_s)
        return self.inner.generate(*args, **kwargs)


def make_replicas(arch: str, smoke: bool, n: int, device="cuda",
                  seed: int = 0, max_len: int = 64):
    """(config, shared model, ``n`` engines over it); the model's weights
    are random, from the port's init seeded with ``seed``."""
    dev = resolve_device(device)
    cfg = (cfgbase.get_smoke_config(arch) if smoke
           else cfgbase.get_config(arch))
    model = lm.init(torch.Generator(dev).manual_seed(seed), cfg)
    engines = [InferenceEngine(cfg, model, max_len=max_len, name=f"r{i}",
                               device=dev) for i in range(n)]
    return cfg, model, engines


def mean_service_s(engine, new_tokens: int = NEW_TOKENS,
                   prompt_len: int = PROMPT_LEN) -> float:
    """Seconds one request takes on ``engine`` alone, from a warm call."""
    prompt = np.arange(prompt_len, dtype=np.int32)
    engine.generate(prompt, max_new_tokens=new_tokens)  # warm
    t0 = time.perf_counter()
    engine.generate(prompt, max_new_tokens=new_tokens)
    return time.perf_counter() - t0


def run_static(k: int, engines) -> np.ndarray:
    """Batched submits through the service at a fixed k."""
    svc = BatchedHedgedService(engines, batch_sizes=(1, 4), max_seq=16,
                               k=k, seed=0)
    rng = np.random.default_rng(0)
    lat = []
    try:
        for _ in range(4):
            prompts = [rng.integers(0, 500, 12).astype(np.int32)
                       for _ in range(4)]
            reqs = svc.submit_batch(prompts, max_new_tokens=4)
            for r in reqs:
                svc.result(r, timeout=120.0)
                lat.append(r.latency)
        stats = dict(svc.stats)
    finally:
        svc.shutdown()
    print(f"  k={k}: mean={np.mean(lat) * 1e3:.0f}ms "
          f"p90={np.percentile(lat, 90) * 1e3:.0f}ms  stats={stats}")
    return np.asarray(lat)


def live_replay(engines, *, n_requests: int, mean_s: float,
                table: PolicyTable | None = None, k: int = 2,
                rho: float = 0.2, crash: str | None = None, seed: int = 0,
                shed_watermark: float = 1.0, new_tokens: int = NEW_TOKENS,
                prompt_len: int = PROMPT_LEN, timeout_s: float = 300.0,
                vocab: int = 1000) -> dict:
    """Replay a Poisson trace of ``n_requests`` at offered load ``rho``
    open loop through a ``BatchedHedgedService`` over ``engines``: with
    an ``AdaptiveController`` on ``table`` when given, else at static
    ``k``. ``crash`` names a replica that ``FaultInjector.crash`` takes
    down a third of the way through the trace. ``shed_watermark`` is the
    service's (above 1 it never sheds a duplicate). Prompts take token ids
    below ``vocab``. Returns the requests, the service's stats, the
    telemetry's and controller's provenance, the decisions and the wall
    seconds."""
    n_rep = len(engines)
    injector = None
    if crash is not None:
        injector = FaultInjector()
        engines = [injector.wrap(e) for e in engines]
    ctl = None
    if table is not None:
        ctl = AdaptiveController(table, n_replicas=n_rep,
                                 mean_service_s=mean_s, hysteresis=0.1,
                                 decision_stride=4)
    trace = poisson_trace(n_requests, rho=rho, n_replicas=n_rep,
                          mean_service_s=mean_s, seed=seed)
    svc = BatchedHedgedService(engines, batch_sizes=(1,),
                               max_seq=prompt_len, controller=ctl, k=k,
                               telemetry=Telemetry(window_s=10 * mean_s),
                               shed_watermark=shed_watermark, seed=seed)
    if injector is not None:
        injector.crash(crash, after=float(trace.t[-1]) / 3)
    t0 = time.perf_counter()
    try:
        reqs = replay_live(svc, trace, max_new_tokens=new_tokens,
                           prompt_len=prompt_len, timeout_s=timeout_s,
                           vocab=vocab)
    finally:
        svc.shutdown()
    wall = time.perf_counter() - t0
    return {"requests": reqs, "stats": dict(svc.stats),
            "telemetry": svc.telemetry.provenance(),
            "latency_s": np.asarray([r.latency for r in reqs
                                     if not r.failed]),
            "controller": ctl.provenance() if ctl is not None else None,
            "decisions": ([(float(h.rho_hat), int(h.k), float(h.delay),
                            bool(h.switched)) for h in ctl.history]
                          if ctl is not None else []),
            "wall_s": wall}


def check_tokens(engine, reqs) -> list[int]:
    """The rids of the requests whose tokens differ from what ``engine``
    alone gives for their prompt (the hedged service must hand each
    caller its own answer)."""
    bad = []
    for r in reqs:
        want = engine.generate(r.tokens, max_new_tokens=r.max_new_tokens)
        if r.failed or list(map(int, want)) != list(r.out_tokens):
            bad.append(r.rid)
    return bad


def chaos_segment(device) -> None:
    """Open-loop Poisson traffic on 4 fast simulated replicas; two of
    them stall mid-run. The controller's busy term (stalled workers
    stay busy) pushes its load estimate past the crossing, it backs
    off to k=1, and after the heal the estimate falls and hedging
    returns."""
    mean_s = 0.01
    print("\nchaos: sweep the policy table (one mixed-grid engine run)...")
    cfg = queueing.SimConfig(n_servers=4, n_arrivals=2_000)
    tab = threshold.policy_table(0, dists.exponential(), cfg,
                                 rhos=[0.05, 0.2, 0.35, 0.5, 0.7],
                                 ks=(1, 2), delays=(0.0, 1.0), n_seeds=2,
                                 device=device)
    table = PolicyTable.from_sweep(tab)

    rngs = [np.random.default_rng(10 + i) for i in range(4)]
    injector = FaultInjector()
    engines = [injector.wrap(SimulatedEngine(
        lambda r=rngs[i]: float(r.exponential(mean_s)), name=f"s{i}"))
        for i in range(4)]
    ctl = AdaptiveController(table, n_replicas=4, mean_service_s=mean_s,
                             window_s=1.0, hysteresis=0.1,
                             decision_stride=16, initial_rho=0.2)
    svc = BatchedHedgedService(engines, batch_sizes=(1, 4), max_seq=8,
                               controller=ctl,
                               telemetry=Telemetry(window_s=1.0), seed=1)
    trace = poisson_trace(720, rho=0.2, n_replicas=4,
                          mean_service_s=mean_s, seed=2)
    # the chaos clock: stall two replicas a third of the way in, heal
    # them two thirds of the way in
    span = float(trace.t[-1])
    for name in ("s0", "s1"):
        injector.stall(name, after=span / 3)
        injector.heal(name, after=2 * span / 3)
    try:
        replay_live(svc, trace, max_new_tokens=2, timeout_s=60.0)
    finally:
        svc.shutdown()

    ks, counts = [0, 0, 0], [0, 0, 0]
    for h in ctl.history:
        third = min(int(3 * (h.t - ctl.history[0].t) / max(span, 1e-9)), 2)
        ks[third] += h.k
        counts[third] += 1
    mean_k = [k / max(c, 1) for k, c in zip(ks, counts)]
    print(f"  controller mean k by phase: healthy={mean_k[0]:.2f}  "
          f"stalled={mean_k[1]:.2f}  healed={mean_k[2]:.2f}")
    print(f"  switches={ctl.switches}  decisions={ctl.decisions}")
    print(f"  telemetry: {svc.telemetry.provenance()}")
    if not mean_k[1] < mean_k[0]:
        raise AssertionError("the controller should back off under stall")


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b",
                    choices=cfgbase.list_architectures())
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's smoke config")
    ap.add_argument("--requests", type=int, default=32,
                    help="requests of each live replay")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, _, engines = make_replicas(args.arch, args.smoke, 4, dev)
    # warm the kernels' builds so latencies measure serving
    mean_s = mean_service_s(engines[1])
    print(f"{cfg.name}: {mean_s * 1e3:.1f} ms a request alone "
          f"({PROMPT_LEN}-token prompt, {NEW_TOKENS} new tokens)")

    slow = [SlowWrapper(engines[0])] + engines[1:]  # one straggler
    print("without redundancy (k=1): requests landing on the slow replica "
          "eat the stall")
    l1 = run_static(1, slow)
    print("with redundancy (k=2, duplicates at low priority):")
    l2 = run_static(2, slow)
    print(f"p90 improvement: "
          f"{np.percentile(l1, 90) / np.percentile(l2, 90):.1f}x")

    from repro_torch.bench import serving_hedge
    table = PolicyTable.from_sweep(serving_hedge.policy_table_sweep(
        args.smoke, device=dev))
    out = {}
    for tag, kw in (("adaptive", {"table": table}),
                    ("crash", {"k": 2, "crash": "r0", "seed": 1,
                               "shed_watermark": STATIC_NO_SHED})):
        r = out[tag] = live_replay(engines, n_requests=args.requests,
                                   mean_s=mean_s,
                                   vocab=min(cfg.vocab_size, 1000), **kw)
        bad = check_tokens(engines[1], r["requests"])
        lat = r["latency_s"]
        print(f"live replay, {tag}: {r['telemetry']['completions']}/"
              f"{args.requests} completed in {r['wall_s']:.1f}s, latency "
              f"mean {lat.mean() * 1e3:.0f}ms p99 "
              f"{np.percentile(lat, 99) * 1e3:.0f}ms, stats {r['stats']}, "
              f"tokens differing from a lone engine: {bad}")
        if bad or r["stats"]["failed"]:
            raise AssertionError(f"{tag}: requests {bad} got other tokens, "
                                 f"{r['stats']['failed']} failed")

    chaos_segment(dev)
    return out


if __name__ == "__main__":
    main()
