"""The port's empirical systems (paper §2.2-2.4, §3.1-3.2) against the
JAX package: the TCP handshake model, the storage service models and
replicated DNS.

Deterministic functions are held exactly equal, and functions of
random draws are held on the JAX package's own draws, injected (torch's
Philox and JAX's threefry give different numbers for one seed). The
port's own draws are held to the JAX package's moments within stated
Monte-Carlo tolerances, and by twins of the JAX package's behaviour
tests (``tests/test_core_apps.py``). The fat-tree simulator's twins are
in ``tests/test_torch_netsim.py``.
"""
import dataclasses
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytic as janalytic
from repro.core import distributions as jdists
from repro.core import dns as jdns
from repro.core import storage_sim as jstorage
from repro_torch.bench import fig5_diskdb
from repro_torch.core import analytic, dns, queueing, storage_sim, threshold
from repro_torch.core import distributions as dists
from repro_torch.device import seeded_generator

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CPU = dict(device="cpu")


def gen(*words):
    return seeded_generator(words, "cpu")


# ---------------------------------------------------------------- TCP

class TestTCP:
    def test_first_order_saving_equals_jax(self):
        for m in (analytic.TCPModel(), analytic.TCPModel(rtt=0.1,
                                                         p_single=0.01)):
            jm = janalytic.TCPModel(**dataclasses.asdict(m))
            assert analytic.handshake_mean_saving(m) == \
                janalytic.handshake_mean_saving(jm)
        assert analytic.BENEFIT_THRESHOLD_MS_PER_KB == \
            janalytic.BENEFIT_THRESHOLD_MS_PER_KB

    @pytest.mark.parametrize("p,timeout", [(0.0048, 3.0), (0.0007, 3.0),
                                           (0.0048, 0.09), (0.3, 0.09)])
    def test_completion_times_on_jax_uniforms(self, p, timeout):
        # JAX's _packet_completion_time draws uniform(key, shape) and
        # inverts the geometric; the port inverts the same uniforms. A
        # float32 log1p or log may round one ulp apart between the two,
        # which moves floor() at a retry boundary by one step: at most 5
        # of 100k draws may differ, each by one retry.
        key = jax.random.PRNGKey(int(p * 1e4) + int(timeout * 100))
        n, rtt, retries = 100_000, 0.03, 8
        want = np.asarray(janalytic._packet_completion_time(
            key, p, timeout, rtt, (n,), retries))
        u = torch.from_numpy(np.array(jax.random.uniform(key, (n,))))
        got = analytic._completion_from_uniform(u, p, timeout, rtt,
                                                retries).numpy()
        assert got.dtype == want.dtype == np.float32
        diff = got != want
        assert diff.sum() <= 5, diff.sum()

        def retry(t):
            return np.rint(np.log2((t.astype(np.float64) - rtt / 2)
                                   / timeout + 1))

        np.testing.assert_array_equal(
            np.abs(retry(got[diff]) - retry(want[diff])), 1.0)

    def test_draws_are_reproducible_and_on_device(self):
        m = analytic.TCPModel()
        a = analytic.handshake_times(3, m, 1000, duplicated=True, **CPU)
        b = analytic.handshake_times(3, m, 1000, duplicated=True, **CPU)
        assert torch.equal(a, b) and a.dtype == torch.float32
        assert float(a.min()) >= 1.5 * m.rtt - 1e-6

    # twins of TestAnalytic's TCP tests
    def test_tcp_mean_saving_at_least_25ms(self):
        assert analytic.handshake_mean_saving(analytic.TCPModel()) >= 0.0246

    def test_tcp_monte_carlo_matches_first_order(self):
        m = analytic.TCPModel()
        t1 = analytic.handshake_times(0, m, 400_000, duplicated=False, **CPU)
        t2 = analytic.handshake_times(0, m, 400_000, duplicated=True, **CPU)
        saving = float(t1.double().mean() - t2.double().mean())
        assert saving == pytest.approx(analytic.handshake_mean_saving(m),
                                       rel=0.25)

    def test_tcp_tail_saving(self):
        m = analytic.TCPModel()
        t1 = analytic.handshake_times(1, m, 400_000, duplicated=False,
                                      **CPU).numpy()
        t2 = analytic.handshake_times(1, m, 400_000, duplicated=True,
                                      **CPU).numpy()
        assert np.percentile(t1, 99.5) - np.percentile(t2, 99.5) > 0.88
        for q in (99.0, 99.5, 99.9, 99.99):
            assert np.percentile(t2, q) <= np.percentile(t1, q) + 1e-3


# ------------------------------------------------------------ storage

def _jax_cfg(cfg):
    return jstorage.StorageConfig(**dataclasses.asdict(cfg))


STORAGE = dict(fig5_diskdb.VARIANTS, memcached=storage_sim.MEMCACHED)


class TestStorage:
    def test_fig5_variants_equal_the_jax_benchmark(self):
        from benchmarks import fig5_diskdb as jfig5
        assert list(fig5_diskdb.VARIANTS) == list(jfig5.VARIANTS)
        for name, cfg in fig5_diskdb.VARIANTS.items():
            assert dataclasses.asdict(cfg) == \
                dataclasses.asdict(jfig5.VARIANTS[name])
        assert dataclasses.asdict(storage_sim.MEMCACHED) == \
            dataclasses.asdict(jstorage.MEMCACHED)

    @pytest.mark.parametrize("name", list(STORAGE))
    def test_closed_forms_equal_jax(self, name):
        cfg = STORAGE[name]
        jcfg = _jax_cfg(cfg)
        assert cfg.hit_rate == jcfg.hit_rate
        assert storage_sim.mean_service_ms(cfg) == \
            jstorage.mean_service_ms(jcfg)
        assert storage_sim.client_overhead_ms(cfg) == \
            jstorage.client_overhead_ms(jcfg)
        dist, scale, ovh = storage_sim.service_dist(cfg)
        jdist, jscale, jovh = jstorage.service_dist(jcfg)
        assert (dist.name, scale, ovh) == (jdist.name, jscale, jovh)

    @pytest.mark.parametrize("name", list(STORAGE))
    def test_sampled_mean_is_the_closed_form(self, name):
        # 200k draws; the heaviest variance (fig9's seek CV of 1.5) puts
        # one standard error at ~0.3% of the mean, so 2% is > 6 SE.
        cfg = STORAGE[name]
        s = storage_sim._sample_ms(cfg, gen(1, len(name)), (200_000,))
        assert float(s.double().mean()) == pytest.approx(
            storage_sim.mean_service_ms(cfg), rel=0.02)
        assert float(s.min()) >= 0.0

    @pytest.mark.parametrize("cv", [0.5, 1.0, 1.5, 3.0])
    def test_seek_nonnegative_with_pinned_moments(self, cv):
        # mean_file_kb=0 + no cache: the sampled service IS the seek
        cfg = storage_sim.StorageConfig(mean_file_kb=0.0,
                                        cache_disk_ratio=0.0, seek_cv=cv)
        s = storage_sim._sample_ms(cfg, gen(11, int(cv * 10)),
                                   (400_000,)).double()
        assert float(s.min()) >= 0.0
        mean = float(s.mean())
        assert mean == pytest.approx(cfg.seek_ms, rel=0.05)
        assert float(s.std()) / mean == pytest.approx(cv, rel=0.05)

    def test_pareto_sizes_never_infinite(self):
        cfg = storage_sim.StorageConfig(file_dist="pareto",
                                        cache_disk_ratio=1.0)
        s = storage_sim._sample_ms(cfg, gen(5), (400_000,))
        assert bool(torch.isfinite(s).all())

    def test_empirical_fit_on_jax_draws_equals_jax(self):
        # the fit is float64 numpy in both packages: the same draws give
        # the same knots
        cfg = fig5_diskdb.VARIANTS["fig7_pareto_sizes"]
        ms = np.asarray(jstorage._sample_ms(_jax_cfg(cfg),
                                            jax.random.PRNGKey(0),
                                            (50_000,)))
        got = dists.empirical(ms, name="x")
        want = jdists.empirical(ms, name="x")
        assert got.table == want.table and got.scale == want.scale

    def test_empirical_service_dist_is_unit_mean(self):
        dist, scale, ovh = storage_sim.empirical_service_dist(
            storage_sim.StorageConfig(), n_samples=50_000, **CPU)
        assert scale == dist.scale
        assert ovh == storage_sim.client_overhead_ms(
            storage_sim.StorageConfig()) / scale
        knots = np.asarray(dist.table)
        mean = float((0.5 * knots[0] + knots[1:-1].sum()
                      + 0.5 * knots[-1]) / (len(knots) - 1))
        assert mean == pytest.approx(1.0, abs=1e-12)
        assert scale == pytest.approx(storage_sim.mean_service_ms(
            storage_sim.StorageConfig()), rel=0.03)

    def test_closure_sampler_rides_the_stacked_engine(self):
        # the model's own sampler (not a table) in a multi-dist sweep:
        # each dist's cells read its own stacked service rows
        disk, _, _ = storage_sim.service_dist(storage_sim.StorageConfig())
        mem, _, _ = storage_sim.service_dist(storage_sim.MEMCACHED)
        cfg = queueing.SimConfig(n_servers=10, n_arrivals=20_000)
        with pytest.warns(DeprecationWarning):
            out = queueing.sweep_dists(0, (disk, mem), (0.05,), cfg,
                                       ks=(1,), n_seeds=1,
                                       percentiles=(), **CPU)
        means = out["mean"][:, 0, 0, 0]
        # at load 0.05 queueing adds little: the disk model (hit rate
        # 0.1, seek CV 0.5) and the near-deterministic memcached model
        # both come out near their unit mean
        assert float(means[0]) == pytest.approx(1.0, rel=0.08)
        assert float(means[1]) == pytest.approx(1.0, rel=0.08)
        sampler = queueing.make_sampler(0, (disk, mem), cfg, 1, 1,
                                        device="cpu")
        assert sampler.spec.kind == "stacked"
        _, _, services = sampler(0, 4096)
        # memcached's rows are nearly constant; the disk rows are not
        assert float(services[1].std()) < 0.05 < float(services[0].std())

    # twins of TestStorageModel
    def test_base_config_threshold_near_paper(self):
        dist, _, ovh = storage_sim.service_dist(storage_sim.StorageConfig())
        assert ovh < 0.02
        cfg = queueing.SimConfig(n_servers=20, n_arrivals=60_000,
                                 client_overhead=ovh)
        t = threshold.threshold_grid(2, dist, cfg, n_seeds=2, **CPU)
        assert 0.25 <= t <= 0.45

    def test_unit_mean(self):
        dist, scale, _ = storage_sim.service_dist(storage_sim.StorageConfig())
        s = dist.sample(gen(3), (200_000,))
        assert float(s.double().mean()) == pytest.approx(1.0, rel=0.05)
        assert scale == pytest.approx(
            storage_sim.mean_service_ms(storage_sim.StorageConfig()),
            rel=1e-6)

    def test_large_files_kill_replication(self):
        dist, _, ovh = storage_sim.service_dist(
            storage_sim.StorageConfig(mean_file_kb=400.0))
        assert ovh > 0.2
        sim = queueing.SimConfig(n_servers=20, n_arrivals=60_000,
                                 client_overhead=ovh)
        t400 = threshold.threshold_grid(4, dist, sim, n_seeds=2, **CPU)
        base, _, base_ovh = storage_sim.service_dist(
            storage_sim.StorageConfig())
        t4 = threshold.threshold_grid(
            4, base, queueing.SimConfig(n_servers=20, n_arrivals=60_000,
                                        client_overhead=base_ovh),
            n_seeds=2, **CPU)
        assert t400 < t4

    def test_memcached_replication_hurts_at_10pct(self):
        dist, _, ovh = storage_sim.service_dist(storage_sim.MEMCACHED)
        assert ovh == pytest.approx(0.09, abs=0.03)
        sim = queueing.SimConfig(n_servers=20, n_arrivals=60_000,
                                 client_overhead=ovh)
        with pytest.warns(DeprecationWarning):
            g = queueing.replication_gain(5, dist, (0.1, 0.3), sim,
                                          n_seeds=2, **CPU)
        assert float(g[1]) < 0.0


# ---------------------------------------------------------------- DNS

POP = dns.DNSPopulation()
JPOP = jdns.DNSPopulation()


@pytest.fixture(scope="module")
def jax_table():
    """The JAX package's latency table and ranking, as numpy arrays."""
    lat = np.asarray(jdns.sample_latencies(jax.random.PRNGKey(7), JPOP,
                                           50_000))
    ranking = np.asarray(jdns.rank_servers(jax.random.PRNGKey(6), JPOP))
    return lat, ranking


class TestDNS:
    def test_population_equals_jax(self):
        assert dataclasses.asdict(POP) == dataclasses.asdict(JPOP)
        assert dns.TIMEOUT_MS == jdns.TIMEOUT_MS

    def test_replicated_response_on_jax_table(self, jax_table):
        lat, ranking = jax_table
        lt, rt = torch.from_numpy(lat), torch.from_numpy(ranking)
        for k in range(1, 11):
            want = np.asarray(jdns.replicated_response(
                jnp.asarray(lat), jnp.asarray(ranking), k))
            np.testing.assert_array_equal(
                dns.replicated_response(lt, rt, k).numpy(), want)

    def test_ranking_of_jax_table_equals_jax(self):
        key = jax.random.PRNGKey(6)
        lat = np.asarray(jdns.sample_latencies(key, JPOP, 20_000))
        np.testing.assert_array_equal(
            dns.rank_table(torch.from_numpy(lat)).numpy(),
            np.asarray(jdns.rank_servers(key, JPOP)))

    def test_fits_of_injected_mins_equal_jax(self, jax_table):
        lat, ranking = jax_table
        lt, rt = torch.from_numpy(lat), torch.from_numpy(ranking)
        for k in (1, 2, 5, 10):
            got = dists.empirical(
                dns.replicated_response(lt, rt, k).numpy(),
                name=f"dns(k={k})")
            want = jdists.empirical(jdns.replicated_response(
                jnp.asarray(lat), jnp.asarray(ranking), k),
                name=f"dns(k={k})")
            assert got.table == want.table
            assert got.scale == want.scale and got.name == want.name

    def test_own_draws_match_jax_moments(self, jax_table):
        # 400k draws each. Per server the mean (sd <= ~300 ms at the
        # lossiest server, 2% of queries at the 2 s timeout) has a standard
        # error of the difference of the two packages' means of ~0.25%:
        # 1% is ~4 SE. Loss fractions within 4 SE of the difference of
        # two binomial fractions.
        n = 400_000
        got = dns.sample_latencies(gen(21), POP, n).double().numpy()
        want = np.asarray(jdns.sample_latencies(jax.random.PRNGKey(21),
                                                JPOP, n), np.float64)
        np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=0.01)
        lost_got = (got == dns.TIMEOUT_MS).mean(0)
        lost_want = (want == dns.TIMEOUT_MS).mean(0)
        p = np.asarray([s.loss for s in POP.servers])
        se = np.sqrt(2 * p * (1 - p) / n)
        assert np.all(np.abs(lost_got - lost_want) <= 4 * se)
        assert np.all(np.abs(lost_got - p) <= 4 * np.sqrt(p * (1 - p) / n)
                      + 1e-4)

    def test_shared_component_fraction_and_mean(self):
        n = 400_000
        shared = dns._shared_ms(gen(22), POP, n).double().numpy()[:, 0]
        on = shared > 0
        p = POP.p_shared
        assert abs(on.mean() - p) <= 4 * math.sqrt(p * (1 - p) / n)
        # Exp(250 ms) given on: ~8,000 episodes, SE ~1.1%
        assert shared[on].mean() == pytest.approx(POP.shared_ms, rel=0.05)

    def test_empirical_k_dists_are_reproducible_unit_mean_fits(self):
        a = dns.empirical_k_dists(6, POP, ks=(1, 3), n_samples=20_000, **CPU)
        b = dns.empirical_k_dists(6, POP, ks=(1, 3), n_samples=20_000, **CPU)
        assert [d.table for d in a] == [d.table for d in b]
        assert [d.name for d in a] == ["dns(k=1)[q512]", "dns(k=3)[q512]"]
        assert a[1].scale < a[0].scale

    # twins of TestDNS
    def test_replication_reduces_tail(self):
        ranking = dns.rank_servers(gen(6), POP)
        lat = dns.sample_latencies(gen(7), POP, 200_000)
        r1 = dns.replicated_response(lat, ranking, 1)
        r10 = dns.replicated_response(lat, ranking, 10)
        f1 = float((r1 > 500.0).double().mean())
        f10 = float((r10 > 500.0).double().mean())
        assert f10 < f1 / 3.0
        assert float(r10.mean()) < float(r1.mean())

    def test_more_servers_monotone(self):
        ranking = dns.rank_servers(gen(8), POP)
        lat = dns.sample_latencies(gen(9), POP, 50_000)
        means = [float(dns.replicated_response(lat, ranking, k).mean())
                 for k in range(1, 11)]
        assert all(a >= b for a, b in zip(means, means[1:]))

    def test_marginal_savings_positive_and_diminishing(self):
        ranking = dns.rank_servers(gen(10), POP)
        lat = dns.sample_latencies(gen(11), POP, 200_000)
        means = np.asarray(
            [float(dns.replicated_response(lat, ranking, k).mean())
             for k in range(1, 11)])
        marg = dns.marginal_savings_ms_per_kb(means, POP)
        assert marg[0] > analytic.BENEFIT_THRESHOLD_MS_PER_KB
        assert marg[0] > marg[-1]
        np.testing.assert_array_equal(
            marg, jdns.marginal_savings_ms_per_kb(means, JPOP))
