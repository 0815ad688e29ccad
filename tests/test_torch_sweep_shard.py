"""The port's sharded cell-plan executor and its launch layer, on the CPU.

The port's CRN contract keeps the line "sharded == unsharded": for the
same ``(seed, chunk_size)`` a run on a ``"cells"`` mesh gives the
unsharded run's bits for any number of slots, because every draw is per
``(seed, chunk, row, purpose, j)`` stream and a shard reads its rows
through an exact remap (``cellplan.device_row_maps``). Here every arm of
the JAX package's 8-device script (``tests/test_sweep_shard.py``) runs
at 1, 2, 3, 4 and 8 CPU slots (``devices=("cpu",) * n``) and is held to
the unsharded run with ``torch.equal``; a planted wrong remap shows that
the comparison can fail. The JAX package's own sharded run is the
anchor on identical draws: its ``queueing.run(mesh=make_sweep_mesh(1))``
against the port's executor at 3 slots on the JAX sampler's draws,
replayed through ``interop.NumpySampler.rows``, to the tolerance of the
unsharded twin in ``tests/test_torch_engine.py`` (means rtol 1e-5,
``completed`` exact, percentiles one log-bin width: ``torch.cumsum`` and
``jnp.cumsum`` round the arrival times differently on the CPU). The
mesh helpers and ``device_row_maps`` / ``make_cell_plan(pad_to=)`` are
held to the JAX functions with ``np.array_equal``.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cellplan as jcellplan
from repro.core import distributions as jdists
from repro.core import queueing as jq
from repro.core import scenario as jscenario
from repro.launch import mesh as jmesh
from repro_torch import interop
from repro_torch.core import cellplan, chunkflow, queueing, threshold
from repro_torch.core import scenario as scenario_mod
from repro_torch.core import distributions as dists
from repro_torch.core.scenario import (CANCEL_ON_COMPLETE, REPLICATE_TO_IDLE,
                                       SERVER_DEPENDENT, Scenario)
from repro_torch.distributed import sweep_shard
from repro_torch.kernels.hist_sketch import ops as hist_ops
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch.mesh import make_sweep_mesh, use_sweep_mesh

CPU = torch.device("cpu")
CFG = queueing.SimConfig(n_servers=10, n_arrivals=1_200)
RHOS2 = [0.15, 0.35]
RHOS3 = [0.1, 0.25, 0.4]
SLOTS = (1, 2, 3, 4, 8)
FIELDS = ("mean", "completed", "p50", "p99")


def cpu_mesh(n: int):
    return make_sweep_mesh(devices=("cpu",) * n)


def assert_bit_equal(a: dict, b: dict, fields=FIELDS):
    assert a["count"] == b["count"]
    for f in fields:
        if f in a:
            assert torch.equal(a[f], b[f]), f


class TestSweepMesh:
    """Twins of tests/test_multihost.py's mesh checks."""

    def test_default_takes_the_cards_and_needs_one(self):
        # the port's entry points run on the card unless the CPU is asked
        # for: the default mesh (every visible card) raises without one
        if torch.cuda.is_available():
            assert make_sweep_mesh().size == torch.cuda.device_count()
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make_sweep_mesh()
        mesh = cpu_mesh(4)
        assert mesh.axis_names == ("cells",)
        assert mesh.size == 4 and mesh.shape == (4,)
        assert mesh.slots == ((0, CPU),) * 4

    @pytest.mark.parametrize("n", [3, 0, 5, -1])
    def test_rejects_what_cannot_tile(self, n):
        with pytest.raises(ValueError, match="divide"):
            make_sweep_mesh(n, devices=("cpu",) * 4)

    def test_explicit_devices(self):
        devs = ("cpu",) * 2
        assert make_sweep_mesh(1, devices=devs).size == 1
        assert make_sweep_mesh(2, devices=devs).size == 2
        with pytest.raises(ValueError):
            make_sweep_mesh(2, devices=devs[:1])

    def test_slots_in_rank_order(self):
        mesh = make_sweep_mesh(devices=[(0, "cpu"), (0, "cpu"), (1, "cpu")])
        assert [r for r, _ in mesh.slots] == [0, 0, 1]
        with pytest.raises(ValueError, match="rank order"):
            make_sweep_mesh(devices=[(1, "cpu"), (0, "cpu")])

    def test_use_sweep_mesh_routes_and_restores(self):
        scn = Scenario.paper_default(dists.exponential(), ks=(1, 2))
        kw = dict(n_seeds=2, chunk_size=500, device="cpu")
        un = queueing.run(7, scn, RHOS2, CFG, **kw)
        mesh = cpu_mesh(2)
        with use_sweep_mesh(mesh):
            assert launch_mesh.resolve_mesh() is mesh
            amb = queueing.run(7, scn, RHOS2, CFG, **kw)
        assert launch_mesh.resolve_mesh() is None
        exp = queueing.run(7, scn, RHOS2, CFG, mesh=mesh, **kw)
        assert_bit_equal(un, amb)
        assert_bit_equal(un, exp)

    def test_explicit_beats_ambient_beats_default(self):
        inner, outer, default = cpu_mesh(1), cpu_mesh(2), cpu_mesh(4)
        launch_mesh.set_default_sweep_mesh(default)
        try:
            assert launch_mesh.resolve_mesh() is default
            with use_sweep_mesh(outer):
                with use_sweep_mesh(inner):
                    assert launch_mesh.resolve_mesh() is inner
                    m = cpu_mesh(2)
                    assert launch_mesh.resolve_mesh(m) is m
                assert launch_mesh.resolve_mesh() is outer
            assert launch_mesh.resolve_mesh() is default
        finally:
            launch_mesh.set_default_sweep_mesh(None)
        assert launch_mesh.resolve_mesh() is None

    def test_sharding_rules_place_each_slots_block(self):
        rules = cellplan.make_cell_plan(1, 3, 2, pad_to=3,
                                        device="cpu").sharding_rule(
            cpu_mesh(3))
        assert rules.n_devices == 3 and rules.local_positions() == [0, 1, 2]
        x = torch.arange(6.0)
        assert [b.tolist() for b in rules.put_cells(x)] == [[0, 1], [2, 3],
                                                           [4, 5]]
        assert [b.device for b in rules.put_blocks([x, x, x])] == [CPU] * 3
        assert all(torch.equal(b, x) for b in rules.put_replicated(x))
        with pytest.raises(ValueError, match="multiple"):
            cellplan.make_cell_plan(1, 3, 2, device="cpu").sharding_rule(
                cpu_mesh(4))


class TestPlanParity:
    @pytest.mark.parametrize("n_dev,idx", [
        (4, [0, 0, 1, 1, 2, 2, 0, 2]),
        (2, [0, 2, 1, 1]),
        (3, [0, 0, 0, 1, 1, 1, 2, 3, 0]),
        (8, list(np.random.default_rng(3).integers(0, 9, 64))),
        (1, [4, 1, 1, 0])])
    def test_device_row_maps_equal_jax(self, n_dev, idx):
        idx = np.asarray(idx, np.int32)
        rows, local = cellplan.device_row_maps(idx, n_dev)
        j_rows, j_local = jcellplan.device_row_maps(idx, n_dev)
        assert np.array_equal(rows, j_rows) and rows.dtype == j_rows.dtype
        assert np.array_equal(local, j_local)
        per = idx.size // n_dev
        for c in range(idx.size):
            assert rows[c // per][local[c]] == idx[c]

    def test_device_row_maps_rejects_what_does_not_tile(self):
        for fn in (cellplan.device_row_maps, jcellplan.device_row_maps):
            with pytest.raises(ValueError, match="tile"):
                fn(np.zeros(6, np.int32), 4)

    @pytest.mark.parametrize("shape,pad_to", [
        ((2, 2, 2), 8), ((1, 3, 2), 8), ((2, 3, 5), 4), ((1, 3, 4), 3),
        ((3, 2, 2), 1)])
    def test_make_cell_plan_pad_to_equals_jax(self, shape, pad_to):
        codes = dict(policies=list(range(shape[2])),
                     models=[k % 2 for k in range(shape[2])],
                     dist_ids=[k // 2 for k in range(shape[2])])
        got = cellplan.make_cell_plan(*shape, pad_to=pad_to, device="cpu",
                                      **codes)
        want = jcellplan.make_cell_plan(*shape, pad_to=pad_to, **codes)
        assert (got.n_cells, got.n_padded) == (want.n_cells, want.n_padded)
        assert got.n_padded % pad_to == 0
        for f in ("seed_idx", "load_idx", "k_idx", "valid", "policy_code",
                  "model_code", "dist_id"):
            assert np.array_equal(getattr(got, f).numpy(),
                                  np.asarray(getattr(want, f))), f


class TestRowReducedSampling:
    """``ChunkSampler.rows`` returns the exact bits of those rows of the
    whole block, for every sampler kind."""

    def _check(self, sampler, seed_rows, svc_rows, t=300):
        g, sv, svc = sampler(1, t)
        rg, rsv, rsvc = sampler.rows(1, t, seed_rows, svc_rows)
        sr, vr = list(seed_rows), list(svc_rows)
        assert torch.equal(g[sr], rg)
        assert torch.equal(sv[sr], rsv)
        assert torch.equal(svc[vr], rsvc)

    def test_single(self):
        s = queueing.make_sampler(0, [dists.exponential()], CFG, 2, 4,
                                  with_shared=True, device="cpu")
        assert s.spec.kind == "single"
        self._check(s, (1, 3), (1, 3))
        self._check(s, (0, 1, 2, 3), (0, 1, 2, 3))
        self._check(s, (2,), (2,))

    def test_stacked(self):
        ds = [dists.exponential(), dists.pareto(2.5)]
        s = queueing.make_sampler(1, ds, CFG, 2, 3, with_degr=True,
                                  device="cpu")
        assert s.spec.kind == "stacked"
        # row r of the tiled seed space repeats seed r % n_seeds
        self._check(s, (0, 4), (0, 4))
        self._check(s, (2, 3, 5), (1, 2, 5))

    def test_tables(self):
        ds = [dists.exponential(), dists.two_point(0.9)]
        s = queueing.make_sampler(2, ds, CFG, 3, 2, has_dists=True,
                                  device="cpu")
        assert s.spec.kind == "tables"
        self._check(s, (1,), (1, 2))
        self._check(s, (0, 1), (0, 3))

    def test_numpy_sampler_rows(self):
        rng = np.random.default_rng(0)
        chunk = (rng.random((4, 50), np.float32),
                 rng.integers(0, 5, (4, 50, 2)).astype(np.int32),
                 rng.random((8, 50, 2), np.float32))
        s = interop.NumpySampler([chunk], device="cpu")
        g, sv, svc = s.rows(0, 50, np.asarray([1, 3]), (0, 7))
        assert np.array_equal(g.numpy(), chunk[0][[1, 3]])
        assert np.array_equal(sv.numpy(), chunk[1][[1, 3]])
        assert np.array_equal(svc.numpy(), chunk[2][[0, 7]])
        with pytest.raises(ValueError, match="steps"):
            s.rows(0, 49, [0], [0])


# --- every arm of the JAX package's script, at 1, 2, 3, 4 and 8 slots ----

D = dists.exponential()
MIXED = (Scenario.paper_default(D, ks=(1, 2)),
         Scenario(dists=D, policy=CANCEL_ON_COMPLETE, ks=(2,)),
         Scenario(dists=D, policy=REPLICATE_TO_IDLE, ks=(2,)),
         Scenario(dists=D, service_model=SERVER_DEPENDENT, mix=0.7, ks=(2,)))
HETEROGENEOUS = (Scenario(dists=D, ks=(1, 2)),
                 Scenario(dists=dists.pareto(2.5), ks=(1, 2),
                          client_overhead=0.05))
BISECT = dict(iters=4, n_seeds=2, chunk_size=500, device="cpu")


def _arm(name: str, mesh=None):
    """One arm of the script: ``mesh=None`` is the unsharded run."""
    m = dict(mesh=mesh) if mesh is not None else {}
    shim = dict(device="cpu", **m)
    if name == "divisible":      # 2 seeds x 2 loads x 2 ks = 8 cells
        fn = sweep_shard.sweep_sharded if mesh else queueing.sweep
        return fn(0, D, RHOS2, CFG, ks=(1, 2), n_seeds=2, chunk_size=500,
                  **shim)
    if name == "non_divisible":  # 6 cells, ragged last chunk (1200 % 700)
        fn = sweep_shard.sweep_sharded if mesh else queueing.sweep
        return fn(0, dists.pareto(2.5), RHOS3, CFG, ks=(1, 2), n_seeds=1,
                  chunk_size=700, **shim)
    if name == "unchunked":
        fn = sweep_shard.sweep_sharded if mesh else queueing.sweep
        return fn(0, dists.two_point(0.9), RHOS3, CFG, ks=(1, 2), n_seeds=1,
                  **shim)
    if name == "sweep_dists":    # 2 dists x 1 seed x 3 loads x 2 ks = 12
        fn = sweep_shard.sweep_dists_sharded if mesh else queueing.sweep_dists
        return fn(0, (dists.exponential(), dists.weibull(0.7)), RHOS3, CFG,
                  ks=(1, 2), n_seeds=1, percentiles=(), chunk_size=500,
                  **shim)
    if name == "mixed_policy":   # 1 seed x 3 loads x 5 variants = 15
        return queueing.run(0, MIXED, RHOS3, CFG, n_seeds=1, chunk_size=700,
                            **shim)
    if name == "heterogeneous":  # two systems: 12 cells, svc_idx sharded
        return queueing.run(0, HETEROGENEOUS, RHOS3, CFG, n_seeds=1,
                            chunk_size=700, **shim)
    if name == "bisect_paper":
        return threshold.threshold_bisect(0, D, CFG, **BISECT, **m)
    if name == "bisect_cancel":  # replication helps everywhere: hi
        return threshold.threshold_bisect(
            0, Scenario(dists=D, policy=CANCEL_ON_COMPLETE), CFG, **BISECT,
            **m)
    raise KeyError(name)


ARMS = ("divisible", "non_divisible", "unchunked", "sweep_dists",
        "mixed_policy", "heterogeneous", "bisect_paper", "bisect_cancel")


@functools.lru_cache(maxsize=None)
def unsharded(name: str):
    return _arm(name)


@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("arm", ARMS)
def test_sharded_equals_unsharded(arm, n):
    got, want = _arm(arm, cpu_mesh(n)), unsharded(arm)
    if arm.startswith("bisect"):
        assert got == want
        if arm == "bisect_cancel":
            assert got == 0.499
    else:
        assert_bit_equal(got, want)


def test_arm_shapes():
    assert unsharded("sweep_dists")["mean"].shape == (2, 1, 3, 2)
    assert unsharded("mixed_policy")["mean"].shape == (1, 3, 5)
    assert unsharded("heterogeneous")["mean"].shape == (1, 3, 4)


@pytest.mark.parametrize("n", SLOTS)
def test_pipeline_on_equals_off_while_sharded(n):
    kw = dict(n_seeds=2, chunk_size=400, mesh=cpu_mesh(n), device="cpu")
    scn = Scenario.paper_default(dists.weibull(0.7), ks=(1, 2))
    on = queueing.run(3, scn, RHOS2, CFG, pipeline="on", **kw)
    assert chunkflow.last_stats().enabled
    off = queueing.run(3, scn, RHOS2, CFG, pipeline="off", **kw)
    assert not chunkflow.last_stats().enabled
    assert_bit_equal(on, off)
    assert_bit_equal(on, queueing.run(3, scn, RHOS2, CFG, n_seeds=2,
                                      chunk_size=400, device="cpu"))


def test_each_shard_samples_its_own_rows():
    # 2 dists x 2 seeds: four seed rows, one per slot of a 4-slot mesh;
    # one process owns every slot, so it draws the whole block once
    ds = (dists.exponential(), dists.pareto(2.5))
    sweep_shard.sweep_dists_sharded(0, ds, RHOS2, CFG, n_seeds=2,
                                    chunk_size=600, mesh=cpu_mesh(4),
                                    device="cpu")
    st = chunkflow.stats_provenance()
    assert st["seed_rows_sampled"] == st["seed_rows_total"] == 4
    assert st["n_chunks"] == 2 and st["process_count"] == 1
    assert st["locality_factor"] == 1.0


@pytest.mark.parametrize("fault", ["global_indices", "rotated_rows"])
def test_planted_wrong_remap_is_caught(monkeypatch, fault):
    """A remap that hands each shard the GLOBAL row indices, or another
    shard's rows, must not give the unsharded bits: sweep_dists with 2
    dists at 4 slots, where shards 0-1 read dist 0's row and shards 2-3
    dist 1's. Global indices past a shard's one-row block make torch
    raise IndexError; rotated rows give wrong means."""
    real = cellplan.device_row_maps

    def planted(idx, n_devices):
        rows, local = real(idx, n_devices)
        if fault == "global_indices":
            return rows, np.asarray(idx, np.int32)
        return np.roll(rows, 2, axis=0), local

    monkeypatch.setattr(cellplan, "device_row_maps", planted)
    try:
        got = _arm("sweep_dists", cpu_mesh(4))
    except IndexError:
        assert fault == "global_indices"
        return
    want = unsharded("sweep_dists")
    assert not torch.equal(got["mean"], want["mean"])


class TestChecks:
    def test_mesh_must_be_a_cells_mesh(self):
        with pytest.raises(ValueError, match="cells"):
            queueing.run(0, Scenario.paper_default(D), [0.2], CFG,
                         mesh=object(), device="cpu")

    def test_bare_sampler_callable_rejected(self):
        with pytest.raises(TypeError, match="ChunkSampler"):
            sweep_shard._sweep_cells_sharded(
                lambda c, t: None, 1, [0.2], CFG,
                variants=Scenario.paper_default(D, ks=(1,)).variants(),
                warmup_frac=0.1, percentiles=(), n_bins=64, chunk_size=500,
                mesh=cpu_mesh(1), device=CPU)

    def test_device_type_must_match_the_runs(self):
        mesh = launch_mesh.SweepMesh(((0, torch.device("cuda", 0)),))
        with pytest.raises(ValueError, match="device type"):
            queueing.run(0, Scenario.paper_default(D), [0.2], CFG,
                         mesh=mesh, device="cpu")

    def test_replication_gain_takes_a_mesh(self):
        kw = dict(n_seeds=2, chunk_size=500, device="cpu")
        with pytest.warns(DeprecationWarning):
            un = queueing.replication_gain(1, D, RHOS2, CFG, **kw)
            sh = queueing.replication_gain(1, D, RHOS2, CFG,
                                           mesh=cpu_mesh(3), **kw)
        assert torch.equal(un, sh)

    @pytest.mark.parametrize("fn", ["scenario_gain", "threshold_grid",
                                    "threshold_grid_batch", "policy_table"])
    def test_estimators_take_a_mesh(self, fn):
        kw = dict(n_seeds=1, chunk_size=600, device="cpu")
        rhos = [0.1, 0.3, 0.45]
        target = {"threshold_grid_batch": [D, dists.pareto(2.5)]}.get(fn, D)
        extra = ({"rhos": rhos} if fn != "scenario_gain" else {})
        args = ((1, target, rhos, CFG) if fn == "scenario_gain"
                else (1, target, CFG))
        f = getattr(threshold, fn)
        un = f(*args, **kw, **extra)
        sh = f(*args, mesh=cpu_mesh(2), **kw, **extra)
        with use_sweep_mesh(cpu_mesh(4)):
            amb = f(*args, **kw, **extra)
        if isinstance(un, dict):
            for k in ("tail", "mean"):
                assert np.array_equal(un[k], sh[k]) and \
                    np.array_equal(un[k], amb[k]), k
        else:
            assert np.array_equal(np.asarray(un), np.asarray(sh))
            assert np.array_equal(np.asarray(un), np.asarray(amb))


# --- the JAX package's sharded run on identical draws --------------------

def _reference_chunks(key, dist_list, cfg, k_max, n_seeds, chunk):
    """The JAX package's sampled chunks, as numpy."""
    if len(dist_list) == 1:
        s = jq._sweep_sampler(key, dist_list[0], cfg, k_max, n_seeds, chunk)
    else:
        s = jq._sweep_dists_sampler(key, dist_list, cfg, k_max, n_seeds,
                                    chunk)
    return [tuple(np.asarray(x) for x in s(c, chunk))
            for c in range(math.ceil(cfg.n_arrivals / chunk))]


@pytest.mark.parametrize("grid", ["single", "stacked"])
def test_port_sharded_matches_jax_sharded_on_its_draws(grid):
    chunk, n_seeds, rhos = 1024, 2, np.asarray([0.15, 0.3, 0.45], np.float32)
    cfg_kw = dict(n_servers=8, n_arrivals=3_000)
    j_d = ((jdists.exponential(),) if grid == "single"
           else (jdists.exponential(), jdists.pareto(2.5)))
    p_d = ((dists.exponential(),) if grid == "single"
           else (dists.exponential(), dists.pareto(2.5)))
    key = jax.random.PRNGKey(11)
    want = jq.run(key, jscenario.Scenario.paper_default(
        j_d if len(j_d) > 1 else j_d[0], ks=(1, 2)), jnp.asarray(rhos),
        jq.SimConfig(**cfg_kw), n_seeds=n_seeds, percentiles=(50.0, 99.0),
        n_bins=2048, chunk_size=chunk, mesh=jmesh.make_sweep_mesh(1))
    chunks = _reference_chunks(key, j_d, jq.SimConfig(**cfg_kw), 2, n_seeds,
                               chunk)
    _, wf, variants = scenario_mod.combine(
        Scenario.paper_default(p_d if len(p_d) > 1 else p_d[0], ks=(1, 2)))
    got = sweep_shard._sweep_cells_sharded(
        interop.NumpySampler(chunks, device="cpu"), len(p_d) * n_seeds, rhos,
        queueing.SimConfig(**cfg_kw), variants=variants, warmup_frac=wf,
        percentiles=(50.0, 99.0), n_bins=2048, chunk_size=chunk,
        mesh=cpu_mesh(3), device=CPU)
    if len(p_d) > 1:
        got = {k: (v.reshape((2, n_seeds) + tuple(v.shape[1:]))
                   if isinstance(v, torch.Tensor) else v)
               for k, v in got.items()}
    assert got["count"] == want["count"]
    np.testing.assert_array_equal(got["completed"].numpy(),
                                  np.asarray(want["completed"]))
    np.testing.assert_allclose(got["mean"].numpy(), np.asarray(want["mean"]),
                               rtol=1e-5)
    _, scale = hist_ops.log_scale(2048)
    for p in ("p50", "p99"):
        np.testing.assert_allclose(got[p].numpy(), np.asarray(want[p]),
                                   rtol=math.expm1(1.0 / scale))
