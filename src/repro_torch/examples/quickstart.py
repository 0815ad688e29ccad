"""Quickstart: the paper's result in 30 seconds.

1. Declare the paper's queueing model (§2.1) as a ``Scenario`` and run it
   through the sweep engine; locate the threshold load for exponential
   service — Theorem 1 says exactly 1/3.
2. Step OFF the paper's point in the policy space: cancellation
   (Joshi et al.) keeps replication helpful at loads where the paper's
   replicate-all model has already flipped to harmful.
3. Wrap a flaky "service" in the hedged-call combinator and watch the tail
   collapse.
4. Fault masking — the paper's "even under exceptional conditions":
   stragglers and blackhole failures as Scenario coordinates
   (``Degradation``), masked by hedging in the engine; then a live
   replica CRASHED mid-trace, masked by the hedged scheduler
   (``serving.faults.FaultInjector`` — the full matrix is
   ``repro_torch.bench.fig_fault_masking``).
5. Adaptive serving — close the loop: precompute a (load x policy)
   table from ONE engine sweep, then replay a diurnal trace open loop
   while an online controller interpolates the table from live load and
   re-picks k / hedge delay as the day moves through the threshold
   (the million-request version is ``repro_torch.bench.serving_hedge``).

Run on the card:   PYTHONPATH=src python -m repro_torch.examples.quickstart
On the CPU, small: PYTHONPATH=src python -m repro_torch.examples.quickstart \\
                       --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import analytic, distributions as dists, hedging
from repro_torch.core import queueing, threshold
from repro_torch.core.hedging import HedgePolicy
from repro_torch.core.scenario import (CANCEL_ON_COMPLETE, Degradation,
                                       Policy, Scenario)
from repro_torch.serving.controller import AdaptiveController, PolicyTable
from repro_torch.serving.engine import SimulatedEngine
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.replay import diurnal_trace, replay_virtual
from repro_torch.serving.scheduler import HedgedScheduler


def _print_gain(loads, gain) -> None:
    for rho, g in zip(loads, gain):
        sign = "helps" if g > 0 else "hurts"
        print(f"  load {float(rho):.2f}: {float(g):+.3f}  ({sign})")


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes (for the plain path on the CPU)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device
    out: dict = {}

    # --- 1. the queueing model, as a declarative Scenario ---------------
    cfg = queueing.SimConfig(n_servers=20,
                             n_arrivals=4_000 if args.smoke else 40_000)
    loads = [0.1, 0.25, 0.4]
    paper = Scenario.paper_default(dists.exponential())  # replicate-all, iid
    gain = threshold.scenario_gain(0, paper, loads, cfg, device=dev)
    print("replication gain (mean response, k=2 vs k=1, paper model):")
    _print_gain(loads, gain)
    t = threshold.threshold_bisect(0, paper, cfg, iters=3 if args.smoke
                                   else 7, n_seeds=2, device=dev)
    print(f"estimated threshold load = {t:.3f} "
          f"(Theorem 1: {analytic.THRESHOLD_EXPONENTIAL:.3f})")
    out["gain"], out["threshold"] = gain, t

    # --- 2. one step into the policy space: cancel the losers -----------
    cancel = Scenario(dists=dists.exponential(), policy=CANCEL_ON_COMPLETE)
    g_cancel = threshold.scenario_gain(0, cancel, loads, cfg, device=dev)
    print("with CANCEL_ON_COMPLETE (losers vacate their queue slot):")
    _print_gain(loads, g_cancel)
    out["gain_cancel"] = g_cancel

    # --- 3. hedged calls ------------------------------------------------
    rng = np.random.default_rng(0)

    def flaky_service():
        # 5 ms typical, 100 ms with probability 0.2
        time.sleep(0.1 if rng.random() < 0.2 else 0.005)
        return "ok"

    lat1, lat2 = [], []
    for _ in range(10 if args.smoke else 30):
        t0 = time.monotonic()
        flaky_service()
        lat1.append(time.monotonic() - t0)
        lat2.append(hedging.hedged_call([flaky_service, flaky_service],
                                        k=2).latency)
    print(f"\nhedged_call: p90 {np.percentile(lat1, 90) * 1e3:.0f} ms -> "
          f"{np.percentile(lat2, 90) * 1e3:.0f} ms "
          f"(mean {np.mean(lat1) * 1e3:.0f} -> {np.mean(lat2) * 1e3:.0f} ms)")

    # --- 4a. fault masking in the engine --------------------------------
    # Degradation makes faults sweep coordinates: with probability p_slow
    # a copy's service is inflated 8x (straggler), with p_fail it never
    # returns (blackhole). Healthy cells keep their exact bits — fault
    # draws come from a dedicated stream.
    deg = Degradation(p_slow=0.05, slow_factor=8.0, p_fail=0.02)
    d = dists.exponential()
    scns = [
        Scenario(dists=d, ks=(1,), degradation=deg),                # bare
        Scenario(dists=d, policy=Policy.TIMEOUT_RETRY, delay=1.0,
                 ks=(2,), degradation=deg),                         # retry
        Scenario(dists=d, policy=Policy.HEDGE_AFTER_DELAY, delay=1.0,
                 ks=(2,), degradation=deg),                         # hedge
    ]
    res = queueing.run(0, scns, [0.2], cfg, n_seeds=2, percentiles=(99.0,),
                       device=dev)
    p99 = res["p99"].mean(dim=0)[0].cpu().numpy()
    frac = (res["completed"].mean(dim=0)[0] / float(res["count"])).cpu() \
        .numpy()
    print("\nfault masking (5% 8x-stragglers + 2% blackholes, load 0.2):")
    for name, j in (("bare k=1", 0), ("timeout-retry", 1),
                    ("hedge-after-delay", 2)):
        print(f"  {name:18s} p99 {p99[j]:6.2f}   completed {frac[j]:.4f}")
    out["fault_p99"], out["fault_completed"] = p99, frac

    # --- 4b. fault masking in the serving stack -------------------------
    # crash one of three replicas mid-trace; the hedged duplicate on a
    # healthy replica masks the blackhole at ~zero latency cost.
    inj = FaultInjector()
    engines = [inj.wrap(SimulatedEngine(lambda: 0.005, name=f"s{i}"))
               for i in range(3)]
    sched = HedgedScheduler(engines,
                            policy=HedgePolicy(max_k=2, threshold=1.1),
                            tied_cancel=True, seed=0)
    try:
        lats = []
        for i in range(20):
            if i == 10:
                inj.crash("s1")  # blackhole: never answers, never removed
            lats.append(sched.submit(np.zeros(2, np.int32),
                                     timeout=5.0).latency)
    finally:
        sched.shutdown()
    print(f"replica s1 crashed mid-trace: {len(lats)}/20 completed, "
          f"max latency {max(lats) * 1e3:.1f} ms (hedging masks the crash)")
    out["crash_latency_s"] = lats

    # --- 5. adaptive serving: the threshold, closed-loop ----------------
    # ONE mixed-grid sweep precomputes p99 over (load x {k=1, k=2@delay});
    # at serve time the controller is pure numpy — it estimates load from
    # arrival/busy windows and interpolates the table to re-pick the
    # policy.
    tab = threshold.policy_table(0, dists.exponential(),
                                 queueing.SimConfig(n_servers=8,
                                                    n_arrivals=3_000),
                                 rhos=[0.05, 0.2, 0.35, 0.5, 0.7],
                                 ks=(1, 2), delays=(0.0, 1.0), n_seeds=2,
                                 device=dev)
    table = PolicyTable.from_sweep(tab)
    trace = diurnal_trace(4_000 if args.smoke else 20_000,
                          rhos=(0.15, 0.75, 0.15), n_replicas=8, seed=0)
    runs = {f"static k={k}": replay_virtual(trace, static_k=k, seed=1)
            for k in (1, 2)}
    ctl = AdaptiveController(table, n_replicas=8, window_s=40.0,
                             decision_stride=16, initial_rho=0.15)
    runs["adaptive"] = replay_virtual(trace, controller=ctl, seed=1)
    print("\nadaptive serving over a night/peak/night day (p99 per segment):")
    for name, r in runs.items():
        segs = "  ".join(f"{r.tails(segment=s)[1]:6.2f}"
                         for s in range(trace.n_segments))
        print(f"  {name:11s} {segs}")
    print(f"  controller re-decided {ctl.decisions} times, "
          f"switched policy {ctl.switches}x as load crossed the threshold")
    out["replays"], out["controller"] = runs, ctl
    return out


if __name__ == "__main__":
    main()
