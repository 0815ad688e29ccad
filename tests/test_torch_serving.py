"""The port's serving layer: the inference engine on the gemma2-2b smoke
model against the JAX engine, the hedged scheduler's semantics on
simulated replicas (twins of ``tests/test_serving.py``, stalls from the
port's ``FaultInjector``), the port's ``estimate_hedge_delay`` and the
``launch.serve`` command line.

Token parity: greedy tokens can only be held equal where the step's
top-2 logit margin exceeds twice the logit tolerance of
``tests/test_torch_lm.py`` (0.21): below that, the two packages' bf16
rounding may legitimately pick different argmaxes, after which the
sequences part.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import decode as jdec
from repro.models import lm as jlm
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.core import distributions as dists
from repro_torch.core import queueing
from repro_torch.core import hedging
from repro_torch.core.hedging import HedgePolicy, LoadMeter, LoadTracker
from repro_torch.launch import serve
from repro_torch.models import decode, lm
from repro_torch.serving.engine import InferenceEngine, SimulatedEngine
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.scheduler import (HedgedScheduler, RetryPolicy,
                                           estimate_hedge_delay)

LOGIT_TOL = 0.21  # tests/test_torch_lm.py


def make_sim(mean_s=0.01, tail_s=0.3, tail_p=0.0, seed=0):
    rng = np.random.default_rng(seed)

    def sampler():
        if rng.random() < tail_p:
            return tail_s
        return mean_s * (0.5 + rng.random())

    return sampler


@pytest.fixture(scope="module")
def gemma():
    jcfg, cfg = jax_smoke_config("gemma2-2b"), get_smoke_config("gemma2-2b")
    params = jax.device_get(jlm.init(jax.random.PRNGKey(0), jcfg))
    model = lm.init(torch.Generator("cpu").manual_seed(0), cfg)
    model.load_state_dict(interop.lm_params_from_numpy(params, cfg, "cpu"),
                          assign=True)
    return jcfg, cfg, params, model


class TestEngine:
    def test_generate_deterministic(self, gemma):
        _, cfg, _, model = gemma
        eng = InferenceEngine(cfg, model, max_len=64, device="cpu")
        prompt = np.arange(8, dtype=np.int32) % cfg.vocab_size
        out1 = eng.generate(prompt, max_new_tokens=4)
        out2 = eng.generate(prompt, max_new_tokens=4)
        assert out1.shape == (4,) and out1.dtype == np.int32
        np.testing.assert_array_equal(out1, out2)

    def test_generate_matches_prefill_extension(self, gemma):
        # greedy decode must equal repeated prefill argmax (teacher forcing)
        _, cfg, _, model = gemma
        eng = InferenceEngine(cfg, model, max_len=64, device="cpu")
        prompt = (np.arange(20, dtype=np.int32) * 7) % cfg.vocab_size
        out = eng.generate(prompt, max_new_tokens=4)
        cur = list(prompt)
        for i in range(4):
            logits, _ = decode.prefill(
                model, torch.tensor([cur], dtype=torch.long), 64)
            nxt = int(torch.argmax(logits, dim=-1)[0])
            assert nxt == int(out[i]), f"step {i}"
            cur.append(nxt)

    def test_tokens_match_jax_engine_where_margin_allows(self, gemma):
        jcfg, cfg, params, model = gemma
        prompt = np.random.default_rng(3).integers(
            0, cfg.vocab_size, 24).astype(np.int32)
        n = 6
        want = JaxEngine(jcfg, params, max_len=64).generate(prompt, n)
        got = InferenceEngine(cfg, model, max_len=64, device="cpu").generate(
            prompt, n)
        checked = 0
        for i in range(n):
            logits, _ = jax.jit(lambda p, b: jdec.prefill(p, jcfg, b, 64))(
                params, {"tokens": jnp.asarray(
                    np.concatenate([prompt, want[:i]]))[None]})
            top2 = np.sort(np.asarray(logits[0]))[-2:]
            if top2[1] - top2[0] <= 2 * LOGIT_TOL:
                break
            assert got[i] == want[i], f"step {i}"
            checked += 1
        assert checked >= 1

    def test_cancel_between_steps(self, gemma):
        _, cfg, _, model = gemma
        eng = InferenceEngine(cfg, model, max_len=64, device="cpu")
        assert eng.generate(np.arange(4, dtype=np.int32), 3,
                            check_cancel=lambda: True) is None

    def test_default_device_is_cuda(self, gemma):
        _, cfg, _, model = gemma
        with pytest.raises((RuntimeError, ValueError)):
            # CUDA by default: absent here, and the model is on the CPU
            InferenceEngine(cfg, model)


class TestHedgedScheduler:
    def test_first_wins_and_duplicate_can_win(self):
        slow = SimulatedEngine(lambda: 0.25, name="slow")
        fast = SimulatedEngine(lambda: 0.01, name="fast")
        sched = HedgedScheduler([slow, fast],
                                policy=HedgePolicy(max_k=2, threshold=1.1),
                                seed=1)
        try:
            lat = [sched.submit(np.zeros(4, np.int32),
                                max_new_tokens=2).latency for _ in range(6)]
            # with k=2 every request touches both replicas: latency ~ fast
            assert np.median(lat) < 0.15
        finally:
            sched.shutdown()

    @pytest.mark.parametrize("load, hedged", [(0.9, 0), (0.0, 1)])
    def test_policy_follows_load(self, load, hedged):
        eng = [SimulatedEngine(make_sim(0.005), name=f"s{i}")
               for i in range(4)]
        sched = HedgedScheduler(
            eng, policy=HedgePolicy(max_k=2, threshold=0.25),
            meter=LoadMeter(alpha=0.0, init=load))  # pinned load
        try:
            sched.submit(np.zeros(2, np.int32))
            assert sched.stats["hedged"] == hedged
        finally:
            sched.shutdown()

    def test_replica_failure_masked(self):
        class Boom:
            name = "boom"

            def generate(self, *a, **kw):
                raise RuntimeError("replica died")

        ok = SimulatedEngine(lambda: 0.01, name="ok")
        sched = HedgedScheduler([Boom(), ok],
                                policy=HedgePolicy(max_k=2, threshold=1.1),
                                seed=0)
        try:
            req = sched.submit(np.zeros(2, np.int32), timeout=5.0)
            assert req.completed_by == "ok"
        finally:
            sched.shutdown()


class TestSchedulerRobustness:
    def test_shutdown_idempotent(self):
        sched = HedgedScheduler([SimulatedEngine(lambda: 0.01, name="a")])
        sched.shutdown()
        sched.shutdown()  # must be a no-op, not an error

    def test_retry_policy_resends_after_deadline(self):
        # first attempt lands on a stalled replica; the resend completes
        inj = FaultInjector()
        engines = [inj.wrap(SimulatedEngine(lambda: 0.01, name=f"s{i}"))
                   for i in range(2)]
        inj.stall("s0")
        sched = HedgedScheduler(engines, seed=3)
        try:
            for _ in range(6):
                req = sched.submit(
                    np.zeros(2, np.int32), timeout=5.0,
                    retry=RetryPolicy(deadline=0.05, max_retries=2))
                assert req.completed_by == "s1"
            assert sched.stats["hedged"] == 0  # the baseline never hedges
            assert sched.stats["retries"] >= 1
        finally:
            sched.shutdown()
            inj.heal("s0")

    def test_hedge_after_delay_defers_duplicates(self):
        engines = [SimulatedEngine(lambda: 0.005, name=f"s{i}")
                   for i in range(3)]
        sched = HedgedScheduler(
            engines, policy=HedgePolicy(max_k=2, threshold=1.1),
            hedge_delay=0.5, seed=4)
        try:
            for _ in range(5):
                sched.submit(np.zeros(2, np.int32), timeout=5.0)
            assert sched.stats["hedged"] == 0
            for _ in range(5):
                sched.submit(np.zeros(2, np.int32), timeout=5.0,
                             hedge_delay=0.0)
            assert sched.stats["hedged"] == 5
        finally:
            sched.shutdown()

    def test_hedge_after_delay_rescues_straggler(self):
        engines = [SimulatedEngine(lambda: 1.0, name="s0"),
                   SimulatedEngine(lambda: 0.01, name="s1")]
        sched = HedgedScheduler(
            engines, policy=HedgePolicy(max_k=2, threshold=1.1),
            hedge_delay=0.05, tied_cancel=True, seed=5)
        try:
            lats = [sched.submit(np.zeros(2, np.int32), timeout=5.0).latency
                    for _ in range(6)]
            assert max(lats) < 0.5  # well under the straggler's 1 s
        finally:
            sched.shutdown()

    def test_shed_watermark_disables_duplicates(self):
        engines = [SimulatedEngine(lambda: 0.005, name=f"s{i}")
                   for i in range(2)]
        sched = HedgedScheduler(
            engines, policy=HedgePolicy(max_k=2, threshold=1.1),
            shed_watermark=0.0, seed=6)   # always above the watermark
        try:
            sched.submit(np.zeros(2, np.int32), timeout=5.0)
            assert sched.stats["shed"] == 1
            assert sched.stats["hedged"] == 0
        finally:
            sched.shutdown()

    def test_remove_replica_requeues_pending_work(self):
        # fill a worker's queue while it is stalled, then remove it: the
        # queued copies must land on the survivor and complete
        inj = FaultInjector()
        engines = [inj.wrap(SimulatedEngine(lambda: 0.005, name=f"s{i}"))
                   for i in range(2)]
        inj.stall("s0")
        sched = HedgedScheduler(
            engines, policy=HedgePolicy(max_k=2, threshold=1.1), seed=7)
        try:
            reqs, threads = [], []

            def go():
                reqs.append(sched.submit(np.zeros(2, np.int32),
                                         timeout=10.0))

            for _ in range(4):
                t = threading.Thread(target=go)
                t.start()
                threads.append(t)
            time.sleep(0.2)      # let copies queue up behind the stall
            assert sched.remove_replica("s0")
            for t in threads:
                t.join(timeout=10.0)
            assert len(reqs) == 4
            assert all(r.completed_by == "s1" for r in reqs)
        finally:
            sched.shutdown()
            inj.heal("s0")


class TestHedging:
    """Twins of ``tests/test_core_apps.py::TestHedging`` and the
    ``LoadTracker`` test of ``tests/test_serving_adaptive.py``."""

    def test_first_completion_wins(self):
        def slow():
            time.sleep(0.2)
            return "slow"

        def fast():
            time.sleep(0.01)
            return "fast"

        res = hedging.hedged_call([slow, fast], k=2)
        assert (res.value, res.winner) == ("fast", 1) and res.latency < 0.15

    def test_k1_no_hedge(self):
        res = hedging.hedged_call([lambda: 7, lambda: 8], k=1)
        assert res.value == 7 and res.k == 1

    def test_failure_masked_and_all_fail_raises(self):
        def boom():
            raise RuntimeError("down")

        def ok():
            time.sleep(0.02)
            return 42

        assert hedging.hedged_call([boom, ok], k=2).value == 42
        with pytest.raises(RuntimeError):
            hedging.hedged_call([boom, boom], k=2)

    def test_policy_steps_down_with_load(self):
        p = HedgePolicy(max_k=4, threshold=0.5)
        assert [p.k_for(u) for u in (0.1, 0.13, 0.2, 0.3)] == [4, 3, 2, 1]
        assert HedgePolicy(max_k=2, threshold=0.3,
                           client_overhead_frac=0.9).k_for(0.01) == 1

    def test_load_meter_ewma(self):
        m = LoadMeter(alpha=0.5, init=0.0)
        m.update(1.0)
        assert m.utilization == pytest.approx(0.5)
        m.update(1.0)
        assert m.utilization == pytest.approx(0.75)

    def test_batch_stamp_does_not_explode_arrival_rate(self):
        tr = LoadTracker(4, window_s=10.0)
        for _ in range(64):
            tr.note_arrival(5.0)
        assert tr.arrival_rate(5.0) == 0.0
        tr.note_arrival(5.001)
        assert tr.arrival_rate(5.001) <= 65 / 0.5
        tr2 = LoadTracker(4, window_s=10.0)
        for i in range(50):
            tr2.note_arrival(i * 0.1)
        assert tr2.arrival_rate(5.0) == pytest.approx(10.0, rel=0.01)


def test_estimate_hedge_delay_runs_the_port_engine():
    delays = (0.0, 0.5, 2.0)
    d = estimate_hedge_delay(0, dists.pareto(2.1), 0.2,
                             queueing.SimConfig(n_servers=6, n_arrivals=3000),
                             delays=delays, device="cpu")
    assert d in delays


def test_serve_main_answers_requests(capsys):
    out = serve.main(["--arch", "gemma2-2b", "--smoke", "--replicas", "2",
                      "--requests", "4", "--max-k", "2", "--device", "cpu"])
    assert out["latency_s"].shape == (4,)
    assert np.all(out["latency_s"] > 0)
    assert out["stats"]["total"] == 4
    assert "[serve] n=4" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_serve_main_serves_recurrent_archs(arch, capsys):
    out = serve.main(["--arch", arch, "--smoke", "--replicas", "2",
                      "--requests", "3", "--max-k", "2", "--device", "cpu"])
    assert out["latency_s"].shape == (3,)
    assert np.all(out["latency_s"] > 0)
    assert out["stats"]["total"] == 3
    assert "[serve] n=3" in capsys.readouterr().out
