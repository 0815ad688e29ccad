"""The port's deprecated paper-default shims of ``queueing`` (``sweep``,
``sweep_dists``, ``mean_response``, ``replication_gain``) against the
port's own ``run`` on the same scenario, bit for bit, and its scenario
helpers (``provenance``, ``parse_policy``, ``parse_service_model``)
against the JAX package's for the same scenarios and names."""
import inspect

import pytest
import torch

from repro.core import distributions as jdists
from repro.core import scenario as jscenario
from repro_torch.core import distributions as dists
from repro_torch.core import queueing, scenario

CFG = queueing.SimConfig(n_servers=10, n_arrivals=3_000,
                         client_overhead=0.05)
RHOS = (0.1, 0.3)
CPU = dict(device="cpu")


def _run(dist_or_dists, ks, **kw):
    scn = scenario.Scenario.paper_default(
        dist_or_dists, ks=ks, client_overhead=CFG.client_overhead,
        warmup_frac=CFG.warmup_frac)
    return queueing.run(3, scn, RHOS, CFG, **kw, **CPU)


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


def test_sweep_is_run_bit_for_bit_and_warns():
    with pytest.warns(DeprecationWarning, match="queueing.sweep"):
        got = queueing.sweep(3, dists.pareto(2.1), RHOS, CFG, ks=(1, 3),
                             n_seeds=2, percentiles=(50.0, 99.0), **CPU)
    want = _run(dists.pareto(2.1), (1, 3), n_seeds=2,
                percentiles=(50.0, 99.0))
    _assert_same(got, want)
    assert got["mean"].shape == (2, len(RHOS), 2)


@pytest.mark.parametrize("n_dists", [1, 2])
def test_sweep_dists_is_run_with_a_dist_axis(n_dists):
    dl = (dists.weibull(0.5), dists.exponential())[:n_dists]
    with pytest.warns(DeprecationWarning, match="queueing.sweep_dists"):
        got = queueing.sweep_dists(3, dl, RHOS, CFG, ks=(1, 2), n_seeds=2,
                                   percentiles=(99.0,), **CPU)
    want = _run(dl if n_dists > 1 else dl[0], (1, 2), n_seeds=2,
                percentiles=(99.0,))
    if n_dists == 1:  # the shim adds the leading dist axis itself
        want = {k: (v[None] if isinstance(v, torch.Tensor) else v)
                for k, v in want.items()}
    _assert_same(got, want)
    assert got["mean"].shape == (n_dists, 2, len(RHOS), 2)


def test_mean_response_is_the_seed_mean_of_run():
    got = queueing.mean_response(3, dists.exponential(), RHOS, CFG, k=2,
                                 n_seeds=3, **CPU)
    m = _run(dists.exponential(), (2,), n_seeds=3, percentiles=())["mean"]
    assert torch.equal(got, m[:, :, 0].mean(dim=0))
    assert got.shape == (len(RHOS),)


def test_replication_gain_is_the_paired_reduction_of_run():
    with pytest.warns(DeprecationWarning, match="replication_gain"):
        got = queueing.replication_gain(3, dists.deterministic(), RHOS, CFG,
                                        k=2, n_seeds=2, **CPU)
    m = _run(dists.deterministic(), (1, 2), n_seeds=2,
             percentiles=())["mean"]
    assert torch.equal(got, (m[:, :, 0] - m[:, :, 1]).mean(dim=0))
    # mesh= runs the sharded executor, with the same bits
    assert "mesh" in inspect.signature(queueing.replication_gain).parameters
    from repro_torch.launch.mesh import make_sweep_mesh
    with pytest.warns(DeprecationWarning, match="replication_gain"):
        sharded = queueing.replication_gain(
            3, dists.deterministic(), RHOS, CFG, k=2, n_seeds=2,
            mesh=make_sweep_mesh(devices=("cpu",) * 2), **CPU)
    assert torch.equal(sharded, got)


def _scenario_pairs():
    """The same scenarios built in both packages."""
    def both(build):
        return build(scenario, dists), build(jscenario, jdists)

    return [
        both(lambda s, d: s.Scenario.paper_default(d.pareto(2.1))),
        both(lambda s, d: s.Scenario.paper_default(
            (d.pareto(2.5), d.weibull(0.5)), ks=(1, 3),
            client_overhead=0.1)),
        both(lambda s, d: s.Scenario(
            dists=d.exponential(), policy=s.CANCEL_ON_COMPLETE, ks=(2,))),
        both(lambda s, d: s.Scenario(
            dists=d.two_point(0.5), service_model=s.SERVER_DEPENDENT,
            mix=0.4, ks=(1, 2))),
        both(lambda s, d: s.Scenario(
            dists=d.deterministic(), policy=s.HEDGE_AFTER_DELAY, delay=0.5,
            ks=(2,), degradation=s.Degradation(p_slow=0.05, slow_factor=5.0,
                                               p_fail=0.02))),
        both(lambda s, d: s.Scenario(dists=d.weibull(2.0),
                                     policy=s.TIMEOUT_RETRY, delay=1.5,
                                     ks=(3,))),
    ]


@pytest.mark.parametrize("i", range(6))
def test_provenance_equals_jax(i):
    port, ref = _scenario_pairs()[i]
    assert scenario.provenance(port) == jscenario.provenance(ref)


def test_provenance_of_a_mixed_grid_equals_jax():
    pairs = _scenario_pairs()
    port = [p for p, _ in pairs]
    ref = [r for _, r in pairs]
    assert scenario.provenance(port) == jscenario.provenance(ref)


@pytest.mark.parametrize("spell", [str.lower, str.upper, str.title, None])
def test_parse_policy_and_service_model_equal_jax(spell):
    for pol in jscenario.Policy:
        name = pol.name if spell is None else spell(pol.name)
        arg = int(pol) if spell is None else name
        got = scenario.parse_policy(arg)
        assert (got.name, int(got)) == (pol.name, int(pol))
        assert scenario.parse_policy(got) is got
    for model in jscenario.ServiceModel:
        arg = int(model) if spell is None else spell(model.name)
        got = scenario.parse_service_model(arg)
        assert (got.name, int(got)) == (model.name, int(model))
    with pytest.raises(KeyError):
        scenario.parse_policy("replicate_most")
    with pytest.raises(ValueError):
        scenario.parse_service_model(7)
