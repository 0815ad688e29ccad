"""Fault-masking figure: redundancy vs timeout-retry under failures, at
BOTH layers of the stack.

Engine part — the (fault rate x policy) grid is ONE mixed-policy
``queueing.run`` call. Each fault rate ``f`` splits across both axes of
the degradation model (blackholes ``p_fail=f/2`` and 8x stragglers
``p_slow=f/2``), served three ways: bare k=1 (no protection),
``HEDGE_AFTER_DELAY`` (k=2 redundancy plus Dean & Barroso's delay) and
``TIMEOUT_RETRY`` (non-redundant resend with capped backoff). The two
fault axes separate cleanly in the outputs: blackholes show up in the
COMPLETED fraction (bare loses ~f/2, hedging ~f^2/4, retry nothing —
its last in-budget attempt is blackhole-exempt), stragglers in the TAIL
(bare p99 inflates ~8x, both timed policies mask it back to ~delay +
clean). Every cell rides the same chunk body (``cell_update`` on the
card, its plain version under ``kernel="off"``) and reports
mean/p99/p999 plus completion.

Serving part — the chaos acceptance demo: four simulated replicas behind
``HedgedScheduler``, 25% of them (1 of 4) CRASHED mid-trace via
``FaultInjector``. Hedged serving must complete 100% of requests with a
p99 within 2x its no-fault baseline, while the timeout-retry baseline
degrades by at least the hedged gap — the ``chaos`` summary row records
exactly those booleans."""
from __future__ import annotations

import numpy as np

from repro_torch.bench.common import Row, timed
from repro_torch.core import distributions as dists
from repro_torch.core import queueing, scenario as scn_mod
from repro_torch.core.hedging import HedgePolicy, LoadMeter
from repro_torch.core.scenario import Degradation, Policy, Scenario
from repro_torch.kernels import dispatch
from repro_torch.serving.engine import SimulatedEngine
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.scheduler import HedgedScheduler, RetryPolicy

CFG = queueing.SimConfig(n_servers=10, n_arrivals=120_000)
CHUNK = 4_096
RHO = 0.2
# f splits evenly across blackholes (p_fail=f/2) and stragglers
# (p_slow=f/2): a copy is "bad" with probability f, so the both-copies-
# bad mass f^2 must stay < 1% for k=2's p99 to sit in the masked region
FAULT_RATES = (0.0, 0.04, 0.08)
SLOW_FACTOR = 8.0
DELAY = 1.0            # units of mean service time, both policies
N_REQS = 80            # serving trace length (full run)


def _engine_grid() -> list[tuple[str, Scenario]]:
    d = dists.exponential()
    entries: list[tuple[str, Scenario]] = []
    for f in FAULT_RATES:
        kw = ({"degradation": Degradation(p_fail=f / 2, p_slow=f / 2,
                                          slow_factor=SLOW_FACTOR)}
              if f > 0 else {})
        entries.append((f"bare@f{f:g}",
                        Scenario(dists=d, ks=(1,), **kw)))
        entries.append((f"hedge@f{f:g}",
                        Scenario(dists=d, policy=Policy.HEDGE_AFTER_DELAY,
                                 delay=DELAY, ks=(2,), **kw)))
        entries.append((f"retry@f{f:g}",
                        Scenario(dists=d, policy=Policy.TIMEOUT_RETRY,
                                 delay=DELAY, ks=(2,), **kw)))
    return entries


def compute(smoke: bool = False, kernel: str = "auto", device="cuda"):
    """(the engine grid's summaries, microseconds)."""
    cfg = (queueing.SimConfig(n_servers=10, n_arrivals=6_000) if smoke
           else CFG)
    return timed(lambda: queueing.run(
        17, tuple(s for _, s in _engine_grid()), (RHO,), cfg,
        n_seeds=2 if smoke else 3, percentiles=(99.0, 99.9),
        chunk_size=CHUNK, kernel=kernel, device=device))


def _serve_trace(n_reqs: int, retry: bool, crash: bool,
                 seed: int) -> dict[str, float]:
    """One scheduler trace: mid-trace, replica s1 (25% of the fleet) is
    crashed WITHOUT being removed — a blackhole the scheduler does not
    know about, masked only by redundancy (hedged) or deadlines
    (retry)."""
    inj = FaultInjector()
    engines = [inj.wrap(SimulatedEngine(
        (lambda r=np.random.default_rng(seed + i):
         0.004 * (0.5 + r.random())), name=f"s{i}")) for i in range(4)]
    sched = HedgedScheduler(
        engines, policy=HedgePolicy(max_k=2, threshold=1.1),
        meter=LoadMeter(alpha=0.0, init=0.0), tied_cancel=True,
        seed=seed,
        retry=RetryPolicy(deadline=0.05, backoff=2.0, max_retries=2)
        if retry else None)
    lats, done = [], 0
    try:
        for i in range(n_reqs):
            if crash and i == n_reqs // 2:
                inj.crash("s1")
            try:
                req = sched.submit(np.zeros(2, np.int32),
                                   max_new_tokens=2, timeout=5.0)
                lats.append(req.latency)
                done += 1
            except TimeoutError:
                pass
    finally:
        sched.shutdown()
    lats = np.asarray(lats) if lats else np.asarray([np.inf])
    return {"frac": done / n_reqs,
            "p99_ms": float(np.percentile(lats, 99) * 1e3),
            "max_ms": float(lats.max() * 1e3),
            "retries": sched.stats["retries"],
            "hedged": sched.stats["hedged"]}


def run(smoke: bool = False, kernel: str = "auto",
        device="cuda") -> list[Row]:
    rows: list[Row] = []
    resolved = dispatch.resolve(kernel, device)

    # ---- engine: (fault rate x policy) in ONE mixed-grid run --------
    entries = _engine_grid()
    out, total_us = compute(smoke, kernel, device)
    n_seeds = out["mean"].shape[0]
    stats = {s: out[s].mean(dim=0)[0].cpu().numpy() for s in
             ("mean", "p99", "p99.9", "completed")}
    count = float(out["count"])
    tails, fracs = {}, {}
    for j, (name, scn) in enumerate(entries):
        tails[name] = float(stats["p99"][j])
        fracs[name] = float(stats["completed"][j]) / count
        rows.append((
            f"fig_fault_masking/{name}", total_us / len(entries),
            f"mean={stats['mean'][j]:.4f};p99={stats['p99'][j]:.4f};"
            f"p999={stats['p99.9'][j]:.4f};"
            f"completed_frac={fracs[name]:.4f}",
            None, scn_mod.provenance(scn), resolved))
    fx = f"f{FAULT_RATES[-1]:g}"
    rows.append((
        "fig_fault_masking/engine", total_us,
        f"rho={RHO:g};delay={DELAY:g};"
        f"hedge_masks_tail={tails[f'hedge@{fx}'] < 0.6 * tails[f'bare@{fx}']};"
        f"retry_masks_tail={tails[f'retry@{fx}'] < 0.6 * tails[f'bare@{fx}']};"
        f"completion_order="
        f"{fracs[f'retry@{fx}'] >= fracs[f'hedge@{fx}'] > fracs[f'bare@{fx}']};"
        f"retry_completes_all={fracs[f'retry@{fx}'] == 1.0};"
        f"scenarios={len(entries)};seeds={n_seeds}",
        None, None, resolved))

    # ---- serving: 25% of replicas crashed mid-trace -----------------
    n_reqs = 16 if smoke else N_REQS
    res = {}
    for tag, retry, crash in (("hedged_nofault", False, False),
                              ("hedged_crash25", False, True),
                              ("retry_nofault", True, False),
                              ("retry_crash25", True, True)):
        r, us = timed(lambda retry=retry, crash=crash:
                      _serve_trace(n_reqs, retry, crash, seed=11))
        res[tag] = r
        rows.append((f"fig_fault_masking/serve_{tag}", us / n_reqs,
                     f"completed_frac={r['frac']:.3f};"
                     f"p99_ms={r['p99_ms']:.2f};max_ms={r['max_ms']:.2f};"
                     f"retries={r['retries']};hedged={r['hedged']}"))

    # the acceptance booleans
    hedged_gap = (res["hedged_crash25"]["p99_ms"]
                  - res["hedged_nofault"]["p99_ms"])
    retry_gap = (res["retry_crash25"]["p99_ms"]
                 - res["retry_nofault"]["p99_ms"])
    completes = res["hedged_crash25"]["frac"] == 1.0
    within_2x = (res["hedged_crash25"]["p99_ms"]
                 <= 2.0 * res["hedged_nofault"]["p99_ms"])
    rows.append((
        "fig_fault_masking/chaos", 0.0,
        f"crashed_frac=0.25;hedged_completes_all={completes};"
        f"hedged_p99_within_2x={within_2x};"
        f"hedged_gap_ms={hedged_gap:.2f};retry_gap_ms={retry_gap:.2f};"
        f"retry_degrades_more={retry_gap >= hedged_gap};"
        f"masked={completes and within_2x and retry_gap >= hedged_gap}"))
    return rows
