"""The port's adaptive serving stack (``serving/metrics``, ``controller``,
``faults``, ``replay``, ``service``) against the JAX package's.

The numpy twins are held EXACTLY on identical inputs: ``TailSketch``
counts and quantiles, ``Telemetry`` rows, ``PolicyTable`` lookups,
``AdaptiveController`` decisions on a scripted arrival sequence, the
trace generators and ``replay_virtual`` (static k=1, static k=2,
adaptive) give the JAX modules' outputs with ``np.array_equal``. The live
parts run on ``SimulatedEngine`` replicas as the twins of
``tests/test_serving.py::TestFaultInjector``/``TestElasticChaos`` and
``tests/test_serving_adaptive.py``; the slice end to end serves the
gemma2-2b smoke model behind ``BatchedHedgedService`` +
``AdaptiveController`` + ``replay_live``, every request's tokens equal to
the port's lone engine's on its prompt.
"""
import time

import numpy as np
import pytest

from repro.serving import controller as jctl
from repro.serving import metrics as jmet
from repro.serving import replay as jrep
from repro_torch.core.hedging import HedgePolicy
from repro_torch.examples import serve_hedged
from repro_torch.serving import controller as tctl
from repro_torch.serving import replay
from repro_torch.serving.controller import AdaptiveController, PolicyTable
from repro_torch.serving.engine import SimulatedEngine
from repro_torch.serving.faults import FaultInjector, ReplicaCrashed
from repro_torch.serving.metrics import TailSketch, Telemetry
from repro_torch.serving.scheduler import HedgedScheduler
from repro_torch.serving.service import (BatchedHedgedService,
                                         TransferBufferPool)


def crossing_table(cls=PolicyTable, lo_tail=(5.0, 2.0), hi_tail=(5.0, 20.0)):
    """Two-variant (k=1, k=2) table with a crossing between rho 0.1
    and rho 0.5: k=2 wins low, k=1 wins high."""
    return cls(rhos=[0.1, 0.5], k=[1, 2], delay=[0.0, 0.0],
               tail=[list(lo_tail), list(hi_tail)])


def random_table(cls, seed=0):
    """A (8 loads x 5 variants) table shaped like ``policy_table``'s."""
    rng = np.random.default_rng(seed)
    return cls(rhos=np.linspace(0.05, 0.8, 8), k=[1, 2, 2, 2, 2],
               delay=[0.0, 0.0, 0.5, 1.0, 2.0],
               tail=rng.uniform(1.0, 30.0, (8, 5)),
               mean=rng.uniform(0.5, 5.0, (8, 5)), percentile=99.0)


def two_point(rng, shape):
    return np.where(rng.random(shape) < 0.9, 0.5, 5.5)


# ---------------------------------------------------------------------------
# numpy twins, exactly equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geometry", [{}, {"n_bins": 100, "lo": 0.01,
                                           "hi": 50.0}])
def test_tail_sketch_equals_jax(geometry):
    rng = np.random.default_rng(1)
    vals = np.concatenate([rng.exponential(1.0, 20_000) + 1e-4,
                           [1e-7, 3e6], rng.pareto(1.5, 500) + 0.5])
    a, b = TailSketch(**geometry), jmet.TailSketch(**geometry)
    for part in np.array_split(vals, 7):
        a.fold(part)
        b.fold(part)
    assert np.array_equal(a.counts, b.counts) and a.count == b.count
    qs = (0.0, 1.0, 50.0, 90.0, 99.0, 99.9, 100.0)
    assert np.array_equal(a.quantiles(qs), b.quantiles(qs))
    assert a.quantile(99.0) == b.quantile(99.0)
    assert np.isnan(TailSketch(**geometry).quantile(50.0))


def test_sketch_geometry_is_the_ports_hist_sketch():
    from repro_torch.kernels.hist_sketch.ops import (DEFAULT_BINS, HIST_HI,
                                                     HIST_LO)
    sk = TailSketch()
    assert (sk.n_bins, sk.lo, sk.hi) == (DEFAULT_BINS, HIST_LO, HIST_HI)
    assert (sk.n_bins, sk.lo, sk.hi) == (jmet.TailSketch().n_bins,
                                         jmet.TailSketch().lo,
                                         jmet.TailSketch().hi)
    with pytest.raises(ValueError):
        sk.fold([0.0])
    with pytest.raises(ValueError):
        sk.merge(TailSketch(n_bins=16))


def _telemetry_script(tel):
    rng = np.random.default_rng(2)
    t = 0.0
    for rid in range(300):
        t += rng.exponential(0.05)
        tel.note_arrival(rid, t)
        tel.note_dispatch(rid, t, 2, shed=rid % 17 == 0)
        if rid % 3 == 0:
            tel.note_hedge(rid, 1)
        if rid % 29 == 0:
            tel.note_failure(rid, t + 0.1)
            continue
        if rid % 5 == 0:
            tel.note_cancel(rid, t + 0.05, 1, timeout=rid % 10 == 0)
        tel.note_completion(rid, t + rng.exponential(0.2) + 1e-3, "r1")
    return tel


def test_telemetry_equals_jax():
    a = _telemetry_script(Telemetry(window_s=2.0))
    b = _telemetry_script(jmet.Telemetry(window_s=2.0))
    assert a.json_rows() == b.json_rows()
    assert a.provenance() == b.provenance()
    assert np.array_equal(a.latencies(), b.latencies())
    # repr: a record's unset timestamps are NaN, which == never equals
    assert [repr(vars(r)) for r in a.records()] == \
        [repr(vars(r)) for r in b.records()]


def test_policy_table_lookups_equal_jax():
    a, b = random_table(PolicyTable), random_table(jctl.PolicyTable)
    for rho in np.linspace(0.0, 0.9, 61):
        assert np.array_equal(a.predict_tail(rho), b.predict_tail(rho))
        assert a.best(rho) == b.best(rho)
    assert a.to_json() == b.to_json()
    assert [a.entry(v) for v in range(5)] == [b.entry(v) for v in range(5)]
    d = {"rhos": a.rhos, "k": a.k, "delay": a.delay, "tail": a.tail,
         "mean": a.mean, "percentile": 99.0}
    c = PolicyTable.from_sweep(d)
    assert np.array_equal(c.tail, jctl.PolicyTable.from_sweep(d).tail)
    one = PolicyTable(rhos=[0.3], k=[1, 2], delay=[0, 0], tail=[[2.0, 1.0]])
    assert one.best(0.9) == 1 and np.array_equal(one.predict_tail(0.1),
                                                 [2.0, 1.0])


def test_policy_table_validation():
    with pytest.raises(ValueError):
        PolicyTable(rhos=[0.5, 0.1], k=[1], delay=[0.0], tail=[[1], [2]])
    with pytest.raises(ValueError):
        PolicyTable(rhos=[0.1], k=[1, 2], delay=[0.0], tail=[[1.0]])


def _controller_script(cls, table):
    """Feed a scripted arrival sequence (three load steps, busy samples
    from a seed) and return every decision."""
    ctl = cls(table, n_replicas=8, mean_service_s=1.0, window_s=40.0,
              hysteresis=0.1, decision_stride=8, initial_rho=0.1)
    rng = np.random.default_rng(3)
    t, out = 0.0, []
    for gap, busy, n in ((1.0, 0.15, 200), (0.2, 0.6, 400), (1.2, 0.1, 300)):
        for _ in range(n):
            t += rng.exponential(gap)
            k, d = ctl.on_arrival(t, busy_fraction=busy
                                  + 0.05 * rng.random())
            ctl.note_dispatch(k, t)
            out.append((k, d))
    hist = [(h.t, h.rho_hat, h.variant, h.k, h.delay, h.switched)
            for h in ctl.history]
    return out, hist, ctl.provenance(), ctl.load_estimate(t)


@pytest.mark.parametrize("table", ["crossing", "random"])
def test_controller_decisions_equal_jax(table):
    make = ((lambda c: crossing_table(c)) if table == "crossing"
            else (lambda c: random_table(c, seed=4)))
    got = _controller_script(AdaptiveController, make(PolicyTable))
    want = _controller_script(jctl.AdaptiveController,
                              make(jctl.PolicyTable))
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2] == want[2] and got[3] == want[3]
    assert got[2]["switches"] > 0


@pytest.mark.parametrize("make", ["poisson", "mmpp", "diurnal"])
def test_traces_equal_jax(make):
    kw = {"poisson": dict(n=3_000, rho=0.3, n_replicas=4, seed=5),
          "mmpp": dict(n=3_000, rho_lo=0.1, rho_hi=0.6, n_replicas=4,
                       seed=5),
          "diurnal": dict(n=3_001, n_replicas=8, seed=5)}[make]
    a = getattr(replay, f"{make}_trace")(**kw)
    b = getattr(jrep, f"{make}_trace")(**kw)
    assert np.array_equal(a.t, b.t) and np.array_equal(a.segment, b.segment)
    assert np.array_equal(a.rho, b.rho) and a.kind == b.kind
    assert np.all(np.diff(a.t) >= 0)


def _replays(rep, ctl_mod, n=20_000):
    trace = rep.diurnal_trace(n, rhos=(0.15, 0.30, 0.75, 0.15),
                              n_replicas=8, seed=0)
    out = {f"k{k}": rep.replay_virtual(trace, static_k=k, seed=1,
                                       svc_sampler=two_point)
           for k in (1, 2)}
    ctl = ctl_mod.AdaptiveController(random_table(ctl_mod.PolicyTable, 6),
                                     8, mean_service_s=1.0, window_s=40.0,
                                     hysteresis=0.1, decision_stride=16,
                                     initial_rho=0.15)
    out["adaptive"] = rep.replay_virtual(trace, controller=ctl, seed=1,
                                         svc_sampler=two_point)
    out["twin"] = rep.replay_virtual(trace, static_k=2,
                                     static_delay_s=0.5, seed=2,
                                     shed_watermark=0.7, cancel_queued=True,
                                     dup_low_priority=True)
    return out


def test_replay_virtual_equals_jax():
    got, want = _replays(replay, tctl), _replays(jrep, jctl)
    for name in got:
        a, b = got[name], want[name]
        for field in ("latency", "k_planned", "hedged", "shed"):
            assert np.array_equal(getattr(a, field), getattr(b, field)), \
                (name, field)
        assert a.cancelled_queued == b.cancelled_queued, name
        assert a.loser_service == b.loser_service, name
        assert a.segment_tails() == b.segment_tails(), name
        assert a.provenance() == b.provenance(), name
    assert got["adaptive"].controller.switches > 0


# ---------------------------------------------------------------------------
# controller and replay behaviour (twins of tests/test_serving_adaptive.py)
# ---------------------------------------------------------------------------

def drive(ctl, t0, n, gap_s, busy, k_dispatch):
    t = t0
    for _ in range(n):
        k, _ = ctl.on_arrival(t, busy_fraction=busy)
        ctl.note_dispatch(k_dispatch if k_dispatch else k, t)
        t += gap_s
    return t


class TestAdaptiveController:
    def test_adaptation_physics(self):
        ctl = AdaptiveController(crossing_table(), n_replicas=4,
                                 mean_service_s=1.0, window_s=50.0,
                                 hysteresis=0.1, decision_stride=8,
                                 initial_rho=0.1)
        assert ctl.current()[0] == 2
        t = drive(ctl, 0.0, 40, 2.5, busy=0.2, k_dispatch=2)
        assert ctl.current()[0] == 2
        t_step = t
        t = drive(ctl, t, 300, 0.5, busy=0.5, k_dispatch=1)
        assert ctl.current()[0] == 1
        down = next(h for h in ctl.history if h.k == 1)
        assert down.t - t_step <= 2 * 50.0
        t_back = t
        drive(ctl, t, 60, 2.5, busy=0.2, k_dispatch=2)
        assert ctl.current()[0] == 2
        up = next(h for h in ctl.history if h.t > t_back and h.k == 2)
        assert up.t - t_back <= 2 * 50.0

    def test_busy_spike_does_not_flip_policy(self):
        ctl = AdaptiveController(crossing_table(), n_replicas=4,
                                 mean_service_s=1.0, window_s=50.0,
                                 hysteresis=0.1, decision_stride=16,
                                 initial_rho=0.1)
        t = 0.0
        for i in range(64):
            ctl.on_arrival(t, busy_fraction=1.0 if i % 16 == 7 else 0.2)
            ctl.note_dispatch(2, t)
            t += 2.5
        assert ctl.current()[0] == 2 and ctl.switches == 0

    @pytest.mark.parametrize("hyst,expect_switch", [(0.15, False),
                                                    (0.0, True)])
    def test_hysteresis_blocks_near_ties(self, hyst, expect_switch):
        t = PolicyTable(rhos=[0.1, 0.5], k=[1, 2], delay=[0.0, 0.0],
                        tail=[[9.5, 10.0], [9.5, 10.0]])
        ctl = AdaptiveController(t, n_replicas=4, mean_service_s=1.0,
                                 window_s=50.0, hysteresis=hyst,
                                 decision_stride=8, initial_rho=0.1)
        assert ctl.current()[0] == 1
        ctl._variant = 1
        drive(ctl, 0.0, 40, 2.5, busy=0.2, k_dispatch=2)
        assert (ctl.switches > 0) == expect_switch

    def test_hysteresis_validation(self):
        with pytest.raises(ValueError):
            AdaptiveController(crossing_table(), 4, hysteresis=1.0)


class TestVirtualReplay:
    def test_same_seed_identical_records(self):
        tr = replay.diurnal_trace(4_000, n_replicas=8, seed=2)
        a = replay.replay_virtual(tr, static_k=2, seed=9)
        b = replay.replay_virtual(tr, static_k=2, seed=9)
        assert np.array_equal(a.latency, b.latency)
        assert not np.array_equal(
            a.latency, replay.replay_virtual(tr, static_k=2,
                                             seed=10).latency)

    def test_all_complete_and_hedging_helps_at_low_load(self):
        tr = replay.poisson_trace(4_000, 0.15, 8, seed=1)
        r1 = replay.replay_virtual(tr, static_k=1, seed=4)
        r2 = replay.replay_virtual(tr, static_k=2, seed=4)
        assert np.all(np.isfinite(r1.latency))
        assert np.all(np.isfinite(r2.latency))
        assert r2.tails()[1] < r1.tails()[1]

    def test_delayed_hedge_spares_work(self):
        tr = replay.poisson_trace(4_000, 0.1, 8, seed=1)
        imm = replay.replay_virtual(tr, static_k=2, seed=4)
        dly = replay.replay_virtual(tr, static_k=2, static_delay_s=2.0,
                                    seed=4)
        assert (imm.hedged | imm.shed).all() and imm.hedged.mean() > 0.9
        assert 0 < dly.hedged.sum() < 0.5 * tr.n
        assert dly.loser_service < imm.loser_service

    def test_shed_watermark_bounds_duplication(self):
        tr = replay.poisson_trace(4_000, 0.9, 4, seed=1)
        r = replay.replay_virtual(tr, static_k=2, shed_watermark=0.8,
                                  seed=4)
        assert r.shed.sum() > 0 and np.all(r.k_planned[r.shed] == 1)

    def test_service_twin_knobs(self):
        tr = replay.poisson_trace(4_000, 0.5, 8, seed=1)
        base = replay.replay_virtual(tr, static_k=2, seed=4)
        twin = replay.replay_virtual(tr, static_k=2, seed=4,
                                     cancel_queued=True,
                                     dup_low_priority=True)
        assert base.cancelled_queued == 0 < twin.cancelled_queued
        assert twin.tails()[1] <= base.tails()[1]


# ---------------------------------------------------------------------------
# live behaviour on simulated replicas (twins of tests/test_serving*.py)
# ---------------------------------------------------------------------------

def sim_engines(n=4, mean_s=0.005, seed=0):
    rngs = [np.random.default_rng(seed + i) for i in range(n)]
    return [SimulatedEngine(lambda r=rngs[i]: float(r.exponential(mean_s)),
                            name=f"s{i}") for i in range(n)]


class FailingEngine:
    def __init__(self, name="bad"):
        self.name = name

    def generate(self, tokens, max_new_tokens=16, check_cancel=None):
        raise RuntimeError("replica down")


class TestFaultInjector:
    def test_crash_raises_and_heal_restores(self):
        inj = FaultInjector()
        eng = inj.wrap(SimulatedEngine(lambda: 0.005, name="x"))
        inj.crash("x")
        with pytest.raises(ReplicaCrashed):
            eng.generate(np.zeros(2, np.int32), 2)
        inj.heal("x")
        assert eng.generate(np.zeros(2, np.int32), 2) is not None

    def test_slow_inflates_service_time(self):
        inj = FaultInjector()
        eng = inj.wrap(SimulatedEngine(lambda: 0.02, name="x"))
        t0 = time.monotonic()
        eng.generate(np.zeros(2, np.int32), 2)
        base = time.monotonic() - t0
        inj.slow("x", 5.0)
        t0 = time.monotonic()
        eng.generate(np.zeros(2, np.int32), 2)
        assert time.monotonic() - t0 > 2.0 * base
        with pytest.raises(ValueError):
            inj.slow("x", 0.5)

    def test_scheduled_crash_fires_later(self):
        inj = FaultInjector()
        eng = inj.wrap(SimulatedEngine(lambda: 0.001, name="x"))
        inj.crash("x", after=0.15)
        assert eng.generate(np.zeros(2, np.int32), 2) is not None
        time.sleep(0.3)
        with pytest.raises(ReplicaCrashed):
            eng.generate(np.zeros(2, np.int32), 2)

    def test_stall_hangs_until_cancelled(self):
        inj = FaultInjector()
        eng = inj.wrap(SimulatedEngine(lambda: 0.001, name="x"))
        inj.stall("x")
        t0 = time.monotonic()
        deadline = t0 + 0.1
        assert eng.generate(np.zeros(2, np.int32), 2,
                            check_cancel=lambda: time.monotonic()
                            > deadline) is None
        assert time.monotonic() - t0 >= 0.1


@pytest.mark.parametrize("tied_cancel", [False, True])
def test_replica_killed_mid_trace(tied_cancel):
    # 4 replicas; mid-trace one is crashed AND removed: every request
    # completes, later ones never on the victim
    inj = FaultInjector()
    rngs = [np.random.default_rng(i) for i in range(4)]
    engines = [inj.wrap(SimulatedEngine(
        lambda r=rngs[i]: 0.01 * (0.5 + r.random()), name=f"s{i}"))
        for i in range(4)]
    sched = HedgedScheduler(engines,
                            policy=HedgePolicy(max_k=2, threshold=1.1),
                            tied_cancel=tied_cancel, seed=8)
    try:
        reqs = []
        for i in range(30):
            if i == 10:
                inj.crash("s1")
                assert sched.remove_replica("s1")
            reqs.append(sched.submit(np.zeros(2, np.int32), timeout=10.0))
        assert len(reqs) == 30
        assert all(r.done_event.is_set() for r in reqs)
        assert all(r.completed_by != "s1" for r in reqs[10:])
    finally:
        sched.shutdown()


class TestBatchedService:
    def test_submit_batch_results_match_engine(self):
        svc = BatchedHedgedService(sim_engines(), batch_sizes=(1, 4),
                                   max_seq=8, k=2, seed=0)
        try:
            prompts = [np.full(3, i, np.int32) for i in range(4)]
            reqs = svc.submit_batch(prompts, max_new_tokens=3)
            outs = [svc.result(r, timeout=10.0) for r in reqs]
            for p, o in zip(prompts, outs):
                want = SimulatedEngine(lambda: 0.0).generate(p, 3)
                assert np.array_equal(o, want)
            deadline = time.monotonic() + 5.0
            while (svc.telemetry.counters["completions"] < 4
                   and time.monotonic() < deadline):
                time.sleep(0.01)  # the winner's callback folds it
            assert svc.telemetry.counters["completions"] == 4
            assert svc.stats["batches"] == 1
        finally:
            svc.shutdown()

    def test_batch_size_fit_and_pool_reuse(self):
        pool = TransferBufferPool((2, 8), max_seq=4, buffers_per_size=1)
        assert pool.fit(1) == 2 and pool.fit(3) == 8
        with pytest.raises(ValueError):
            pool.fit(9)
        buf = pool.acquire(2)
        with pytest.raises(TimeoutError):
            pool.acquire(2, timeout=0.02)
        pool.release(buf)
        assert pool.acquire(2) is buf
        with pytest.raises(ValueError):
            buf.fill([np.zeros(5, np.int32)])

    def test_nonblocking_submit_and_hedge_delay_timer(self):
        svc = BatchedHedgedService(sim_engines(mean_s=0.05), k=2,
                                   hedge_delay_s=10.0, batch_sizes=(1,),
                                   max_seq=8, seed=0)
        try:
            t0 = time.monotonic()
            reqs = [svc.submit(np.zeros(2, np.int32), max_new_tokens=2)
                    for _ in range(8)]
            assert time.monotonic() - t0 < 0.05
            for r in reqs:
                svc.result(r, timeout=10.0)
            assert svc.stats["hedged"] == 0
        finally:
            svc.shutdown()

    @pytest.mark.parametrize("variant,want_hedged", [(0, False), (1, True)])
    def test_controller_steers_service(self, variant, want_hedged):
        tail = ([[1.0, 9.0], [1.0, 9.0]] if variant == 0
                else [[9.0, 1.0], [9.0, 1.0]])
        table = PolicyTable(rhos=[0.1, 0.9], k=[1, 2], delay=[0.0, 0.0],
                            tail=tail)
        ctl = AdaptiveController(table, n_replicas=4, mean_service_s=0.005,
                                 decision_stride=4)
        svc = BatchedHedgedService(sim_engines(), controller=ctl,
                                   batch_sizes=(1,), max_seq=8, seed=0)
        try:
            reqs = [svc.submit(np.zeros(2, np.int32), max_new_tokens=2)
                    for _ in range(12)]
            for r in reqs:
                svc.result(r, timeout=10.0)
            assert (svc.stats["hedged"] > 0) == want_hedged
        finally:
            svc.shutdown()

    def test_controller_needs_the_services_tracker(self):
        from repro_torch.core.hedging import LoadTracker
        ctl = AdaptiveController(crossing_table(), n_replicas=4)
        with pytest.raises(ValueError):
            BatchedHedgedService(sim_engines(), controller=ctl,
                                 tracker=LoadTracker(4)).shutdown()

    @pytest.mark.parametrize("k", [1, 2])
    def test_all_copies_failing_raises_instead_of_hanging(self, k):
        svc = BatchedHedgedService([FailingEngine(f"b{i}") for i in range(2)],
                                   batch_sizes=(1,), max_seq=8, k=k, seed=0)
        try:
            req = svc.submit(np.zeros(2, np.int32), max_new_tokens=2)
            with pytest.raises(RuntimeError):
                svc.result(req, timeout=5.0)
            assert req.failed and req.done_event.is_set()
            assert svc.stats["failed"] == 1
            assert svc.telemetry.counters["failures"] == 1
            assert not svc._pending
        finally:
            svc.shutdown()

    def test_all_copies_failing_with_delayed_hedge(self):
        svc = BatchedHedgedService([FailingEngine(f"b{i}") for i in range(2)],
                                   batch_sizes=(1,), max_seq=8, k=2,
                                   hedge_delay_s=0.05, seed=0)
        try:
            req = svc.submit(np.zeros(2, np.int32), max_new_tokens=2)
            t0 = time.monotonic()
            with pytest.raises(RuntimeError):
                svc.result(req, timeout=10.0)
            assert time.monotonic() - t0 < 5.0
            assert svc.stats["hedged"] == 1 and svc.stats["failed"] == 1
        finally:
            svc.shutdown()

    def test_failure_masked_by_surviving_replica(self):
        svc = BatchedHedgedService([FailingEngine("bad")] + sim_engines(1),
                                   batch_sizes=(1,), max_seq=8, k=2, seed=0)
        try:
            reqs = [svc.submit(np.zeros(2, np.int32), max_new_tokens=2)
                    for _ in range(6)]
            for r in reqs:
                assert svc.result(r, timeout=10.0)
            assert svc.stats["failed"] == 0
            assert svc.telemetry.counters["completions"] == 6
        finally:
            svc.shutdown()

    def test_timeout_cancels_the_request(self):
        inj = FaultInjector()
        engines = [inj.wrap(e) for e in sim_engines(2)]
        for e in engines:
            inj.stall(e.name)
        svc = BatchedHedgedService(engines, batch_sizes=(1,), max_seq=8,
                                   k=2, seed=0)
        try:
            req = svc.submit(np.zeros(2, np.int32), max_new_tokens=2)
            with pytest.raises(TimeoutError):
                svc.result(req, timeout=0.1)
            assert req.cancelled
            assert svc.telemetry.counters["timeouts"] == 1
        finally:
            svc.shutdown()
            for e in engines:
                inj.heal(e.name)


def test_every_request_completes_with_one_replica_crashed():
    # static k=2 over a replayed trace, one of four replicas crashed a
    # third of the way in: the surviving copies mask it, 100% complete
    inj = FaultInjector()
    engines = [inj.wrap(e) for e in sim_engines(4, mean_s=0.01, seed=3)]
    trace = replay.poisson_trace(90, rho=0.3, n_replicas=4,
                                 mean_service_s=0.01, seed=4)
    svc = BatchedHedgedService(engines, batch_sizes=(1,), max_seq=8, k=2,
                               seed=2)
    inj.crash("s2", after=float(trace.t[-1]) / 3)
    try:
        reqs = replay.replay_live(svc, trace, max_new_tokens=2)
    finally:
        svc.shutdown()
    assert len(reqs) == 90 and not any(r.failed for r in reqs)
    assert svc.telemetry.counters["completions"] == 90
    assert svc.stats["failed"] == 0
    assert any(r.completed_by != "s2" for r in reqs)


def test_controller_backs_off_under_a_stall():
    # the example's chaos segment: two of four replicas stall a third of
    # the way in; the controller's mean k drops while they hang (it
    # raises otherwise)
    serve_hedged.chaos_segment("cpu")


# ---------------------------------------------------------------------------
# the slice end to end: a model behind the adaptive service
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_replicas():
    return serve_hedged.make_replicas("gemma2-2b", True, 4, "cpu")


@pytest.mark.parametrize("run", ["adaptive", "crash"])
def test_model_behind_the_adaptive_service_answers_each_caller(
        smoke_replicas, run):
    cfg, model, engines = smoke_replicas
    table = PolicyTable(rhos=[0.05, 0.3, 0.8], k=[1, 2, 2],
                        delay=[0.0, 0.0, 0.5],
                        tail=[[5.0, 2.0, 3.0], [6.0, 4.0, 3.5],
                              [9.0, 30.0, 20.0]])
    mean_s = serve_hedged.mean_service_s(engines[1])
    kw = ({"table": table} if run == "adaptive"
          else {"k": 2, "crash": "r0", "seed": 1,
                "shed_watermark": serve_hedged.STATIC_NO_SHED})
    out = serve_hedged.live_replay(engines, n_requests=10, mean_s=mean_s,
                                   vocab=cfg.vocab_size, **kw)
    reqs = out["requests"]
    assert len(reqs) == 10 and out["stats"]["failed"] == 0
    assert out["telemetry"]["completions"] == 10
    from repro_torch.serving.engine import InferenceEngine
    lone = InferenceEngine(cfg, model, max_len=64, name="lone",
                           device="cpu")
    assert serve_hedged.check_tokens(lone, reqs) == []
    assert all(len(r.out_tokens) == serve_hedged.NEW_TOKENS for r in reqs)
    if run == "adaptive":
        assert out["controller"]["decisions"] > 0
