"""The PyTorch port's estimators on its own draws: closed forms, the
exponential threshold of Theorem 1, and parity of the pure functions
with the JAX package.

The twin of ``tests/test_analytic_golden.py`` at a size the plain CPU
path runs in seconds (40k arrivals instead of 1M). Tolerances come from
the Monte-Carlo error at that size (repeated seeds: k=1 means within
3%, p99 within 3.5% at rho <= 0.25, k=2 means within 1%, CRN-paired
exponential thresholds within 0.002 of 1/3), with room to spare.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytic as janalytic
from repro.core import threshold as jthreshold
from repro_torch.core import analytic, queueing, threshold
from repro_torch.core import distributions as dists
from repro_torch.core.scenario import HEDGE_AFTER_DELAY, Scenario

RHOS = (0.1, 0.25, 0.5)
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def k12():
    cfg = queueing.SimConfig(n_servers=20, n_arrivals=40_000)
    out = queueing.run(100, Scenario.paper_default(dists.exponential(),
                                                   ks=(1, 2)),
                       RHOS, cfg, n_seeds=1, percentiles=(99.0,),
                       chunk_size=8192, **CPU)
    return {k: (v.numpy() if hasattr(v, "numpy") else v)
            for k, v in out.items()}


class TestClosedForms:
    @pytest.mark.parametrize("i,rho", enumerate(RHOS))
    def test_k1_mean_is_mm1(self, k12, i, rho):
        assert k12["mean"][0, i, 0] == pytest.approx(
            float(analytic.mm1_mean(rho)), rel=0.05)

    @pytest.mark.parametrize("i,rho", enumerate(RHOS[:2]))
    def test_k1_p99_is_exponential_response(self, k12, i, rho):
        # M/M/1 response ~ Exp(1 - rho): p99 = ln(100) / (1 - rho)
        assert k12["p99"][0, i, 0] == pytest.approx(
            math.log(100.0) / (1.0 - rho), rel=0.08)

    @pytest.mark.parametrize("i,rho", enumerate(RHOS[:2]))
    def test_k2_mean_is_min_of_two_mm1(self, k12, i, rho):
        assert k12["mean"][0, i, 1] == pytest.approx(
            float(analytic.mm1_replicated_mean(rho, 2)), rel=0.04)

    def test_counts(self, k12):
        assert k12["count"] == 36_000
        np.testing.assert_array_equal(k12["completed"], 36_000.0)


class TestThresholds:
    def test_exponential_threshold_is_one_third(self):
        est = threshold.threshold_grid(
            0, dists.exponential(), queueing.SimConfig(20, 30_000),
            rhos=np.linspace(0.25, 0.42, 8), n_seeds=2, chunk_size=8192,
            **CPU)
        assert est == pytest.approx(analytic.exponential_threshold(),
                                    abs=0.02)

    def test_bisect_brackets_one_third(self):
        est = threshold.threshold_bisect(
            3, dists.exponential(), queueing.SimConfig(20, 8_000), iters=4,
            n_seeds=2, lo=0.2, hi=0.45, chunk_size=4096, **CPU)
        assert est == pytest.approx(1.0 / 3.0, abs=0.04)

    @pytest.mark.parametrize("iters,calls", [(4, [2, 3, 3]),
                                             (3, [2, 3, 1])])
    def test_bisect_probes_quarter_points_and_a_last_odd_level(
            self, monkeypatch, iters, calls):
        # a stand-in engine whose paired gain is 1/3 - rho, exactly
        probes = []

        def fake_run(seed, scn, rhos, cfg, **kw):
            probes.append(len(rhos))
            g = torch.tensor([1.0 / 3.0 - r for r in rhos], dtype=torch.float64)
            return {"mean": torch.stack([g, torch.zeros_like(g)], dim=-1)[None]}

        monkeypatch.setattr(threshold, "run", fake_run)
        lo, hi = 0.02, 0.499
        est = threshold.threshold_bisect(0, dists.exponential(),
                                         queueing.SimConfig(), lo=lo, hi=hi,
                                         iters=iters, **CPU)
        assert probes == calls
        assert abs(est - 1.0 / 3.0) <= (hi - lo) / 2 ** (iters + 1)

    def test_grid_batch_of_one_equals_grid(self):
        cfg = queueing.SimConfig(n_servers=10, n_arrivals=3_000)
        rhos = np.linspace(0.2, 0.45, 4)
        a = threshold.threshold_grid(4, dists.pareto(2.5), cfg, rhos=rhos,
                                     chunk_size=1000, **CPU)
        b = threshold.threshold_grid_batch(4, [dists.pareto(2.5)], cfg,
                                           rhos=rhos, chunk_size=1000, **CPU)
        assert b == [a]

    def test_scenario_gain_of_systems_and_policy_table(self):
        cfg = queueing.SimConfig(n_servers=10, n_arrivals=2_000)
        g = threshold.scenario_gain(
            1, [Scenario.paper_default(dists.exponential()),
                Scenario.paper_default(dists.pareto(2.2))],
            [0.1, 0.3], cfg, chunk_size=1000, **CPU)
        assert g.shape == (2, 2) and np.isfinite(g).all()
        tbl = threshold.policy_table(1, dists.exponential(), cfg,
                                     rhos=[0.1, 0.3], delays=(0.0, 1.0),
                                     chunk_size=1000, **CPU)
        assert tbl["k"].tolist() == [1, 2, 2]
        assert tbl["delay"].tolist() == [0.0, 0.0, 1.0]
        assert tbl["tail"].shape == tbl["mean"].shape == (2, 3)
        # hedging at delay 0 halves the light-load mean (min of two)
        assert tbl["mean"][0, 1] < 0.7 * tbl["mean"][0, 0]
        assert Scenario(dists=dists.exponential(), policy=HEDGE_AFTER_DELAY,
                        delay=1.0).delay == 1.0


class TestPureFunctionsMatchReference:
    def test_crossing_load(self):
        rng = np.random.default_rng(0)
        rhos = np.linspace(0.05, 0.495, 24, dtype=np.float32)
        for _ in range(5):
            g = np.sort(rng.normal(size=24))[::-1].astype(np.float32)
            g += rng.uniform(-1, 1)
            assert threshold.crossing_load(rhos, g) == pytest.approx(
                jthreshold.crossing_load(jnp.asarray(rhos), jnp.asarray(g)),
                rel=1e-6)
        # float32 linspace: numpy and XLA may round a point one ULP apart
        np.testing.assert_allclose(threshold.default_rhos(),
                                   np.asarray(jthreshold._default_rhos()),
                                   rtol=2e-7)

    def test_closed_forms(self):
        rho = np.asarray([0.05, 0.2, 1 / 3, 0.45, 0.7])
        for f in ("mm1_mean", "mm1_replicated_mean", "hedge_mean_light",
                  "retry_mean_light"):
            np.testing.assert_allclose(getattr(analytic, f)(rho),
                                       np.asarray(getattr(janalytic, f)(rho)),
                                       rtol=1e-6)
        np.testing.assert_allclose(analytic.mm1_response_cdf(2.0, rho),
                                   janalytic.mm1_response_cdf(2.0, rho),
                                   rtol=1e-6)
        for lo, hi in zip(analytic.mm1_cancel_bounds(rho),
                          janalytic.mm1_cancel_bounds(rho)):
            np.testing.assert_allclose(lo, np.asarray(hi), rtol=1e-6)
        for k, c in ((2, 0.0), (2, 0.1), (3, 0.0)):
            assert analytic.exponential_threshold(k, c) == \
                janalytic.exponential_threshold(k, c)
