"""The port's raw-response simulator (``queueing._scan_sim``, ``simulate``,
``simulate_grid``, ``_warm``) against the JAX package's.

``_scan_sim`` is held on the JAX package's own draws: its sampled
arrivals, copy sets and service columns go into both packages'
``_scan_sim``. Where ``cell_update``'s parity is bit-exact (every policy,
IID and SERVER_DEPENDENT at mix 0.5, degraded, timed delays whose backoff
products are exact) the responses agree bit for bit. At a generic mix
XLA contracts the blend into an FMA on the CPU (ROADMAP queue 3), so the
completion instants (arrival + response, the quantities the simulation
rounds) agree within rtol 1e-6 and every request completes in both or
in neither.

``simulate``/``simulate_grid`` draw from torch generators, so whole runs
are held statistically: the k=1 mean within 2% of M/M/1, and the means
over six seeds within 4 standard errors of the JAX package's; the CRN
coupling is held on the port's own draws (k=2 reuses k=1's first copy).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributions as jd
from repro.core import queueing as jq
from repro.core import scenario as jscn
from repro_torch.core import distributions as td
from repro_torch.core import queueing as tq
from repro_torch.core import scenario as tscn

CPU = {"device": "cpu"}
SIM_CFG = dict(n_servers=6, n_arrivals=3_000)
RHOS = (0.1, 0.3, 0.45)


def _scenarios(policy: int, model: int, mix: float, delay: float,
               degraded: bool, k: int):
    kw = dict(policy=policy, service_model=model, mix=mix, delay=delay,
              ks=(k,))
    jkw, tkw = dict(kw), dict(kw)
    if degraded:
        jkw["degradation"] = jscn.Degradation(p_fail=0.05, p_slow=0.1,
                                              slow_factor=4.0)
        tkw["degradation"] = tscn.Degradation(p_fail=0.05, p_slow=0.1,
                                              slow_factor=4.0)
    jkw["policy"], jkw["service_model"] = (jscn.Policy(policy),
                                           jscn.ServiceModel(model))
    return (jscn.Scenario(dists=jd.exponential(), **jkw).variant_for(k),
            tscn.Scenario(dists=td.exponential(), **tkw).variant_for(k))


def _both_scan_sims(policy, model=0, mix=0.0, delay=0.0, degraded=False,
                    k=2, seed=3):
    """(port, JAX) responses (B, M) on the JAX package's draws, and the
    arrivals."""
    jv, tv = _scenarios(policy, model, mix, delay, degraded, k)
    cfg = jq.SimConfig(**SIM_CFG)
    gaps, srv, svc = jq._sample_inputs(
        jax.random.PRNGKey(seed), jd.exponential(), cfg, k,
        with_shared=jv.needs_shared_draw,
        with_degr=jv.needs_degradation_draw)
    rhos = jnp.asarray(RHOS, jnp.float32)
    arr = jnp.cumsum(gaps)[None, :] / (cfg.n_servers * rhos)[:, None]
    want = np.asarray(jax.vmap(lambda a: jq._scan_sim(
        a, srv[:, :k], svc, cfg.n_servers, jv))(arr))
    got = tq._scan_sim(torch.tensor(np.asarray(arr)),
                       torch.tensor(np.asarray(srv[:, :k])),
                       torch.tensor(np.asarray(svc)), cfg.n_servers, tv)
    return got.numpy(), want, np.asarray(arr)


# (policy, service model, mix, delay, degraded, k): every policy under IID
# and under SERVER_DEPENDENT at mix 0.5, the degraded grid, retry with
# three attempts
EXACT_ARMS = [(p, m, 0.5 if m else 0.0, d, False, 2)
              for p, d in ((0, 0.0), (1, 0.0), (2, 0.0), (3, 0.5), (4, 0.5))
              for m in (0, 1)]
EXACT_ARMS += [(4, 0, 0.0, 0.5, True, 2), (0, 0, 0.0, 0.0, True, 2),
               (3, 0, 0.0, 0.75, False, 3), (1, 1, 0.5, 0.0, True, 2)]


@pytest.mark.parametrize("policy,model,mix,delay,degraded,k", EXACT_ARMS)
def test_scan_sim_bit_equal_on_exact_arms(policy, model, mix, delay,
                                          degraded, k):
    got, want, _ = _both_scan_sims(policy, model, mix, delay, degraded, k)
    assert got.shape == want.shape == (len(RHOS), SIM_CFG["n_arrivals"])
    assert np.array_equal(np.isinf(got), np.isinf(want))
    assert np.array_equal(got, want), \
        f"{int((got != want).sum())} responses differ"


@pytest.mark.parametrize("policy", [0, 1, 2, 3, 4])
def test_scan_sim_generic_mix_differs_only_by_contraction(policy):
    got, want, arr = _both_scan_sims(policy, 1, 0.6, 0.5)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got + arr, want + arr, rtol=1e-6)


def test_simulate_k1_mean_matches_mm1():
    # N independent M/M/1 queues at each load: mean response 1/(1 - rho)
    cfg = tq.SimConfig(n_servers=10, n_arrivals=60_000)
    rhos = (0.2, 0.3)
    resp = tq.simulate_grid(5, td.exponential(), rhos, cfg, 1, **CPU)
    got = tq._warm(resp, cfg).mean(dim=-1).numpy()
    np.testing.assert_allclose(got, [1 / (1 - r) for r in rhos], rtol=0.02)
    one = tq.simulate(5, td.exponential(), 0.3, cfg, 1, **CPU)
    assert one.shape == (cfg.n_arrivals,)
    assert tq._warm(one, cfg).mean() == pytest.approx(1 / 0.7, rel=0.02)


def test_simulate_grid_means_within_standard_errors_of_jax():
    # six seeds of each package; per-(load, k) means and the paired gain
    cfg = dict(n_servers=10, n_arrivals=8_000)
    rhos, n = (0.2, 0.35), 6
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    stats = {}
    for pkg in ("torch", "jax"):
        per_seed = []
        for s in range(n):
            ms = []
            for k in (1, 2):
                if pkg == "torch":
                    c = tq.SimConfig(**cfg)
                    r = tq.simulate_grid(0, td.exponential(), rhos, c, k,
                                         row=s, **CPU).numpy()
                else:
                    c = jq.SimConfig(**cfg)
                    r = np.asarray(jq.simulate_grid(
                        keys[s], jd.exponential(), jnp.asarray(rhos), c, k))
                ms.append(r[:, int(c.n_arrivals * c.warmup_frac):]
                          .mean(axis=-1))
            per_seed.append(np.concatenate([ms[0], ms[1], ms[0] - ms[1]]))
        per_seed = np.asarray(per_seed)
        stats[pkg] = (per_seed.mean(axis=0),
                      per_seed.std(axis=0, ddof=1) / np.sqrt(n))
    (mt, st), (mj, sj) = stats["torch"], stats["jax"]
    assert np.all(np.abs(mt - mj) <= 4 * np.sqrt(st ** 2 + sj ** 2)), \
        (mt, mj, st, sj)


def test_k2_reuses_k1_first_copy():
    # the nested-copy CRN contract: k=2's streams extend k=1's
    cfg = tq.SimConfig(n_servers=8, n_arrivals=2_000)
    dev = torch.device("cpu")
    g1, srv1, svc1 = tq._sample_inputs(4, td.pareto(2.1), cfg, 1,
                                       row=1, device=dev)
    g2, srv2, svc2 = tq._sample_inputs(4, td.pareto(2.1), cfg, 2,
                                       row=1, device=dev)
    assert torch.equal(g1, g2)
    assert torch.equal(srv1[:, 0], srv2[:, 0])
    assert torch.equal(svc1[:, 0], svc2[:, 0])
    assert bool((srv2[:, 1] != srv2[:, 0]).all())  # distinct servers
    # the same streams as seed row 1 of an unchunked run
    sampler = tq.make_sampler(4, (td.pareto(2.1),), cfg, 2, 2, device=dev)
    gaps, servers, services = sampler(0, cfg.n_arrivals)
    assert torch.equal(gaps[1], g2) and torch.equal(servers[1], srv2)
    assert torch.equal(services[1], svc2)
    # with no queueing (arrivals far apart on every server), k=2 is the
    # min of the two copies' services and k=1 the first's
    light = tq.SimConfig(n_servers=8, n_arrivals=64)
    r1 = tq.simulate(4, td.exponential(), 1e-3, light, 1, **CPU)
    r2 = tq.simulate(4, td.exponential(), 1e-3, light, 2, **CPU)
    _, _, s2 = tq._sample_inputs(4, td.exponential(), light, 2, device=dev)
    torch.testing.assert_close(r1, s2[:, 0], rtol=0, atol=2e-3)
    torch.testing.assert_close(r2, s2.min(dim=1).values, rtol=0, atol=2e-3)


def test_simulate_takes_a_scenario_and_needs_the_device():
    cfg = tq.SimConfig(n_servers=6, n_arrivals=1_500)
    cancel = tscn.Scenario(dists=td.exponential(),
                           policy=tscn.CANCEL_ON_COMPLETE)
    paper = tq.simulate(2, td.exponential(), 0.4, cfg, 2, **CPU)
    r = tq.simulate(2, td.exponential(), 0.4, cfg, 2, scenario=cancel,
                    **CPU)
    # cancellation frees the losers' servers: never slower on the same
    # draws at a load where replicate-all queues
    assert tq._warm(r, cfg).mean() < tq._warm(paper, cfg).mean()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tq.simulate(2, td.exponential(), 0.4, cfg, 2)
