"""The port's fat-tree replication simulator (paper §2.4) against the JAX
package's ``repro.core.netsim``: the topology and the workload table are
the same numpy code, and the slot loop is integer-only, so delivery slots,
flow completion times and the fitted FCT tables must be equal exactly.
Then the twins of the behaviour tests of ``tests/test_netsim.py``."""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import netsim as jnetsim
from repro_torch.core import netsim

CPU = dict(device="cpu")

# (n_flows, load, elephant_frac, elephant_pkts, seed)
PARITY = {"light": (60, 0.05, 0.05, 200, 1),
          "headline": (200, 0.25, 0.12, 400, 7)}


def _cfg(mod, key, replicate_first):
    n_flows, load, ef, ep, seed = PARITY[key]
    return mod.NetConfig(n_flows=n_flows, load=load, elephant_frac=ef,
                         elephant_pkts=ep, replicate_first=replicate_first,
                         seed=seed)


def test_constants_equal_jax():
    for name in ("K", "N_HOST", "N_EDGE", "N_AGG", "N_CORE", "L_HE", "L_EA",
                 "L_AC", "L_CA", "L_AE", "L_EH", "N_LINKS", "MAX_HOPS"):
        assert getattr(netsim, name) == getattr(jnetsim, name), name
    assert dataclasses.asdict(netsim.NetConfig()) == \
        dataclasses.asdict(jnetsim.NetConfig())


def test_links_for_path_equals_jax_everywhere():
    for src, dst in itertools.permutations(range(netsim.N_HOST), 2):
        for up1, up2 in itertools.product(range(3), range(3)):
            assert netsim._links_for_path(src, dst, up1, up2) == \
                jnetsim._links_for_path(src, dst, up1, up2)


@pytest.mark.parametrize("cfg", [
    dict(n_flows=60, load=0.05, seed=1),
    dict(n_flows=200, load=0.25, elephant_frac=0.12, elephant_pkts=400,
         replicate_first=0, seed=7),
    dict(n_flows=80, load=0.4, replicate_first=3, seed=2)])
def test_build_workload_equals_jax(cfg):
    got = netsim.build_workload(netsim.NetConfig(**cfg))
    want = jnetsim.build_workload(jnetsim.NetConfig(**cfg))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("replicate_first", [0, 8])
@pytest.mark.parametrize("key", list(PARITY))
def test_simulate_delivered_equals_jax(key, replicate_first):
    cfg = _cfg(netsim, key, replicate_first)
    meta, paths, lens, sizes, starts = netsim.build_workload(cfg)
    n_slots = netsim.default_n_slots(cfg, sizes, starts)
    kw = dict(n_slots=n_slots, buffer_pkts=cfg.buffer_pkts,
              rto_slots=cfg.rto_slots)
    want = np.asarray(jnetsim._simulate(jnp.asarray(meta),
                                        jnp.asarray(paths),
                                        jnp.asarray(lens), **kw))
    got = netsim._simulate(meta, paths, lens, **kw, **CPU).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).mean() > 0.99  # the run delivers, so it compares


def test_flow_completion_times_equal_jax():
    got = netsim.flow_completion_times(_cfg(netsim, "headline", 8), **CPU)
    want = jnetsim.flow_completion_times(_cfg(jnetsim, "headline", 8))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("short_only", [True, False])
def test_empirical_fct_dist_equals_jax(short_only):
    got = netsim.empirical_fct_dist(_cfg(netsim, "light", 8),
                                    short_only=short_only, n_quantiles=64,
                                    **CPU)
    want = jnetsim.empirical_fct_dist(_cfg(jnetsim, "light", 8),
                                      short_only=short_only, n_quantiles=64)
    assert got.table == want.table
    assert (got.scale, got.name) == (want.scale, want.name)


def test_truncated_horizon_equals_jax():
    cfg = netsim.NetConfig(n_flows=80, load=0.4, replicate_first=8, seed=2)
    *_, starts = netsim.build_workload(cfg)
    n_slots = int(starts.max()) + 5
    got = netsim.flow_completion_times(cfg, n_slots=n_slots, **CPU)
    want = jnetsim.flow_completion_times(
        jnetsim.NetConfig(**dataclasses.asdict(cfg)), n_slots=n_slots)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# twins of tests/test_netsim.py::TestSimulation

def test_all_delivered_at_low_load():
    cfg = netsim.NetConfig(n_flows=60, load=0.05, replicate_first=0, seed=0)
    fct, sizes, short, undelivered = netsim.flow_completion_times(cfg, **CPU)
    assert undelivered.sum() == 0
    assert np.all(fct >= sizes)


def test_censored_fct_units_consistent():
    cfg = netsim.NetConfig(n_flows=80, load=0.4, replicate_first=0, seed=2)
    *_, starts = netsim.build_workload(cfg)
    n_slots = int(starts.max()) + 5
    fct, sizes, _, undelivered = netsim.flow_completion_times(
        cfg, n_slots=n_slots, **CPU)
    assert undelivered.any()
    np.testing.assert_array_equal(
        fct[undelivered], (float(n_slots) - starts)[undelivered])
    assert np.all(fct[undelivered] <= n_slots)
    assert np.all(fct[~undelivered] <= n_slots)
    assert np.all(fct >= 0.0)


def test_replication_never_hurts_uncongested():
    base = netsim.NetConfig(n_flows=60, load=0.05, replicate_first=0, seed=1)
    rep = dataclasses.replace(base, replicate_first=8)
    f0, _, sh0, _ = netsim.flow_completion_times(base, **CPU)
    f1, _, sh1, _ = netsim.flow_completion_times(rep, **CPU)
    assert np.mean(f1[sh1]) <= np.mean(f0[sh0]) * 1.02


def test_replication_helps_at_intermediate_load():
    base = netsim.NetConfig(n_flows=400, load=0.45, replicate_first=0,
                            elephant_frac=0.12, elephant_pkts=400, seed=3)
    rep = dataclasses.replace(base, replicate_first=8)
    f0, _, sh0, _ = netsim.flow_completion_times(base, **CPU)
    f1, _, sh1, _ = netsim.flow_completion_times(rep, **CPU)
    assert np.mean(f1[sh1]) < np.mean(f0[sh0])
    assert np.percentile(f1[sh1], 90) <= np.percentile(f0[sh0], 90)


def test_elephants_unaffected():
    base = netsim.NetConfig(n_flows=300, load=0.4, replicate_first=0,
                            elephant_frac=0.12, elephant_pkts=300, seed=4)
    rep = dataclasses.replace(base, replicate_first=8)
    f0, s0, sh0, _ = netsim.flow_completion_times(base, **CPU)
    f1, s1, sh1, _ = netsim.flow_completion_times(rep, **CPU)
    e0, e1 = f0[~sh0], f1[~sh1]
    assert abs(np.mean(e1) - np.mean(e0)) / np.mean(e0) < 0.05
