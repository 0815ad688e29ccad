"""The PyTorch port's sweep engine: package rules, plan and spec parity
with the JAX package, whole runs on identical draws, and the port's own
common-random-numbers contract.

Whole runs cannot be held bit for bit: ``torch.cumsum`` on the CPU
accumulates float32 in double while ``jnp.cumsum`` accumulates in
float32, so arrival times differ by a few ULP. Means are therefore held
to rtol 1e-5 and percentiles to one log-bin width.
"""
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cellplan as jcellplan
from repro.core import distributions as jdists
from repro.core import queueing as jq
from repro.core import scenario as jscenario
from repro_torch import interop
from repro_torch.core import cellplan, queueing, scenario
from repro_torch.core import distributions as dists
from repro_torch.core.scenario import (CANCEL_ON_COMPLETE, Degradation,
                                       HEDGE_AFTER_DELAY, REPLICATE_TO_IDLE,
                                       SERVER_DEPENDENT, TIMEOUT_RETRY,
                                       Scenario)
from repro_torch.kernels.cell_update import kernel as cell_kernel
from repro_torch.kernels.hist_sketch import ops as hist_ops

CPU = dict(device="cpu")


def test_import_pulls_in_neither_jax_nor_repro():
    code = ("import sys, repro_torch\n"
            "import repro_torch.core.queueing, repro_torch.core.threshold\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or"
            " m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
            "assert not bad, bad\n"
            "assert 'torch' in sys.modules\n")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src)
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


class TestSpecsAndPlan:
    def test_codes_match_reference(self):
        for name in ("Policy", "ServiceModel"):
            port, ref = getattr(scenario, name), getattr(jscenario, name)
            assert {m.name: int(m) for m in port} == {
                m.name: int(m) for m in ref}

    def test_mixed_grid_lowering_matches_reference(self):
        def grid(mod, d):
            return (mod.Scenario.paper_default(d["exp"], ks=(1, 2)),
                    mod.Scenario(dists=d["par"],
                                 policy=mod.Policy.CANCEL_ON_COMPLETE,
                                 ks=(2, 3)),
                    mod.Scenario(dists=d["exp"],
                                 policy=mod.Policy.TIMEOUT_RETRY, delay=0.5,
                                 service_model=mod.ServiceModel
                                 .SERVER_DEPENDENT, mix=0.3, ks=(2,),
                                 degradation=mod.Degradation(p_fail=0.1)))
        _, wf, pv = scenario.combine(grid(scenario, {
            "exp": dists.exponential(), "par": dists.pareto(2.1)}))
        _, jwf, jv = jscenario.combine(grid(jscenario, {
            "exp": jdists.exponential(), "par": jdists.pareto(2.1)}))
        fields = ("k", "policy", "service_model", "mix", "overhead",
                  "p_slow", "slow_factor", "p_fail", "delay", "dist_id")
        assert wf == jwf
        assert [[getattr(v, f) for f in fields] for v in pv] == \
            [[getattr(v, f) for f in fields] for v in jv]
        assert scenario.variant_codes(pv) == jscenario.variant_codes(jv)
        assert scenario.any_timed(pv) and scenario.any_degraded(pv)

    @pytest.mark.parametrize("shape,pad_to", [((2, 3, 2), 1),
                                              ((3, 5, 3), 8), ((1, 1, 1), 4)])
    def test_plan_matches_reference(self, shape, pad_to):
        K = shape[2]
        kw = dict(pad_to=pad_to, policies=[(i * 2) % 5 for i in range(K)],
                  models=[i % 2 for i in range(K)],
                  dist_ids=[i % 2 for i in range(K)])
        p = cellplan.make_cell_plan(*shape, **kw, **CPU)
        j = jcellplan.make_cell_plan(*shape, **kw)
        assert (p.n_cells, p.n_padded) == (j.n_cells, j.n_padded)
        for f in ("seed_idx", "load_idx", "k_idx", "valid", "policy_code",
                  "model_code", "dist_id"):
            np.testing.assert_array_equal(getattr(p, f).numpy(),
                                          np.asarray(getattr(j, f)), f)
        x = torch.arange(np.prod(shape) * 2, dtype=torch.float32)
        x = x.reshape(*shape, 2)
        assert torch.equal(cellplan.unflatten(p, cellplan.flatten(p, x)), x)
        moved = interop.plan_from_numpy(
            *shape, **{f: np.asarray(getattr(j, f)) for f in (
                "seed_idx", "load_idx", "k_idx", "valid", "policy_code",
                "model_code", "dist_id")}, **CPU)
        assert torch.equal(moved.seed_idx, p.seed_idx)
        assert moved.n_padded == p.n_padded


class TestDistributions:
    @pytest.mark.parametrize("name", [
        "exponential", "deterministic", "pareto(3)", "weibull(0.7)",
        "two_point(0.8)", "discrete", "mixture", "random_discrete"])
    def test_unit_mean_and_closed_form_variance(self, name):
        def build(mod):
            return {
                "exponential": lambda: mod.exponential(),
                "deterministic": lambda: mod.deterministic(),
                "pareto(3)": lambda: mod.pareto(3.0),
                "weibull(0.7)": lambda: mod.weibull(0.7),
                "two_point(0.8)": lambda: mod.two_point(0.8),
                "discrete": lambda: mod.discrete([1, 2, 7], [0.5, 0.3, 0.2]),
                "mixture": lambda: mod.mixture(
                    [mod.exponential(), mod.deterministic()], [0.3, 0.7]),
                "random_discrete": None}[name]
        if name == "random_discrete":
            d = dists.random_discrete(3, 6)
            jvar = None
        else:
            d, jd = build(dists)(), build(jdists)()
            jvar = jd.variance
            assert d.name == jd.name
        if jvar is not None:
            assert d.variance == pytest.approx(jvar, rel=1e-6)
        gen = torch.Generator().manual_seed(0)
        x = d.sample(gen, (400_000,))
        assert x.dtype == torch.float32 and float(x.min()) >= 0.0
        x = x.double()
        assert float(x.mean()) == pytest.approx(1.0, abs=0.01)
        if d.variance:
            assert float(x.var()) == pytest.approx(d.variance, rel=0.05)

    def test_empirical_fit_matches_reference_knots(self):
        s = np.random.default_rng(3).pareto(2.1, 50_000) * 3.7
        d = dists.empirical(s, n_quantiles=256)
        j = jdists.empirical(s, n_quantiles=256)
        assert d.table == j.table and d.scale == j.scale
        assert d.variance == j.variance and d.name == j.name
        assert d.exceedance(10.0) == j.exceedance(10.0)
        x = d.sample(torch.Generator().manual_seed(1), (400_000,))
        assert float(x.double().mean()) == pytest.approx(1.0, abs=0.01)

    def test_from_trace(self, tmp_path):
        p = tmp_path / "trace.txt"
        p.write_text("# ms\n1.0\n2.0\n\n4.0\n8.0\n")
        d = dists.EmpiricalDist.from_trace(p, n_quantiles=4)
        j = jdists.EmpiricalDist.from_trace(p, n_quantiles=4)
        assert d.table == j.table and d.name == j.name == "trace:trace.txt[q4]"


def _reference_chunks(seed, dist_list, cfg, k_max, n_seeds, chunk, *,
                      has_dists=False, with_shared=False, with_degr=False):
    """The JAX package's sampled chunks, as numpy."""
    key = jax.random.PRNGKey(seed)
    kw = dict(with_shared=with_shared, with_degr=with_degr)
    if len(dist_list) == 1:
        s = jq._sweep_sampler(key, dist_list[0], cfg, k_max, n_seeds, chunk,
                              **kw)
    elif has_dists:
        s = jq._dist_table_sampler(key, dist_list, cfg, k_max, n_seeds,
                                   chunk, **kw)
    else:
        s = jq._sweep_dists_sampler(key, dist_list, cfg, k_max, n_seeds,
                                    chunk, **kw)
    n_chunks = math.ceil(cfg.n_arrivals / chunk)
    return [tuple(np.asarray(x) for x in s(c, chunk))
            for c in range(n_chunks)]


class TestWholeRunOnIdenticalDraws:
    @pytest.mark.parametrize("grid", ["paper_default", "mixed"])
    def test_run_engine_matches_reference(self, grid):
        def scenarios(mod, d):
            if grid == "paper_default":
                return mod.Scenario.paper_default(d, ks=(1, 2))
            P = mod.Policy
            return (mod.Scenario.paper_default(d, ks=(1, 2)),
                    mod.Scenario(dists=d, policy=P.CANCEL_ON_COMPLETE,
                                 ks=(2,)),
                    mod.Scenario(dists=d, policy=P.REPLICATE_TO_IDLE,
                                 service_model=mod.ServiceModel
                                 .SERVER_DEPENDENT, mix=0.4, ks=(2,)),
                    mod.Scenario(dists=d, policy=P.HEDGE_AFTER_DELAY,
                                 delay=0.5, ks=(2,),
                                 degradation=mod.Degradation(
                                     p_slow=0.05, slow_factor=4.0,
                                     p_fail=0.05)))
        cfg_kw = dict(n_servers=8, n_arrivals=5_000)
        rhos = np.asarray([0.15, 0.3], np.float32)
        dl, wf, jv = jscenario.combine(scenarios(jscenario,
                                                 jdists.exponential()))
        _, pwf, pv = scenario.combine(scenarios(scenario,
                                                dists.exponential()))
        chunks = _reference_chunks(
            4, dl, jq.SimConfig(**cfg_kw), max(v.k for v in jv), 2, 2048,
            with_shared=jscenario.any_server_dependent(jv),
            with_degr=jscenario.any_degraded(jv))
        kw = dict(warmup_frac=wf, percentiles=(50.0, 99.0),
                  n_bins=2048, chunk_size=2048, pipeline="off")
        want = jq._run_engine(lambda c, t: tuple(map(jnp.asarray,
                                                     chunks[c])),
                              2, jnp.asarray(rhos), jq.SimConfig(**cfg_kw),
                              variants=jv, use_kernel="off", **kw)
        got = queueing._run_engine(interop.NumpySampler(chunks, **CPU), 2,
                                   rhos, queueing.SimConfig(**cfg_kw),
                                   variants=pv, kernel="auto",
                                   device=torch.device("cpu"), **kw)
        assert got["count"] == want["count"]
        np.testing.assert_array_equal(got["completed"].numpy(),
                                      np.asarray(want["completed"]))
        np.testing.assert_allclose(got["mean"].numpy(),
                                   np.asarray(want["mean"]), rtol=1e-5)
        _, scale = hist_ops.log_scale(2048)
        for p in ("p50", "p99"):
            np.testing.assert_allclose(got[p].numpy(), np.asarray(want[p]),
                                       rtol=math.expm1(1.0 / scale))

    def test_summarize_matches_reference(self):
        resp = np.random.default_rng(0).exponential(size=(3, 4000)).astype(
            np.float32)
        cfg = queueing.SimConfig(n_arrivals=4000)
        got = queueing.summarize(torch.from_numpy(resp), cfg, (50.0, 99.0))
        want = jq.summarize(jnp.asarray(resp), jq.SimConfig(n_arrivals=4000),
                            (50.0, 99.0))
        for k in ("mean", "p50", "p99"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5)


class TestCRNContract:
    CFG = queueing.SimConfig(n_servers=8, n_arrivals=2_000)

    def _sample(self, dist_list, k_max, n_seeds=2, c=0, t=512, **kw):
        return queueing.make_sampler(9, dist_list, self.CFG, k_max, n_seeds,
                                     **kw, **CPU)(c, t)

    def test_copy_sets_and_service_columns_nested_across_k(self):
        g2, s2, v2 = self._sample([dists.exponential()], 2)
        g4, s4, v4 = self._sample([dists.exponential()], 4)
        assert torch.equal(g2, g4)
        assert torch.equal(s2, s4[..., :2])
        assert torch.equal(v2, v4[..., :2])
        # distinct servers within a request
        assert bool((torch.sort(s4, dim=-1).values.diff(dim=-1) > 0).all())

    def test_one_arrival_stream_across_dists_and_systems(self):
        e, p = dists.exponential(), dists.pareto(2.5)
        g1, s1, _ = self._sample([e], 2)
        gs, ss, vs = self._sample([e, p], 2)                   # stacked
        gt, st, vt = self._sample([e, p], 2, has_dists=True)   # tables
        assert torch.equal(gs, torch.cat([g1, g1])) and torch.equal(gt, g1)
        assert torch.equal(ss, torch.cat([s1, s1])) and torch.equal(st, s1)
        assert vs.shape[0] == vt.shape[0] == 4
        assert not torch.equal(vs[:2], vs[2:])   # per-dist service tables

    def test_per_seed_and_chunk_streams(self):
        e = [dists.exponential()]
        a = self._sample(e, 2, n_seeds=2, c=3)
        b = self._sample(e, 2, n_seeds=3, c=3)
        for x, y in zip(a, b):
            assert torch.equal(x, y[:2])     # seed rows do not shift
        again = self._sample(e, 2, n_seeds=2, c=3)
        assert all(torch.equal(x, y) for x, y in zip(a, again))
        other = self._sample(e, 2, n_seeds=2, c=4)
        assert not torch.equal(a[0], other[0])
        assert not torch.equal(a[0][0], a[0][1])

    def test_shared_and_degradation_columns_leave_copies_untouched(self):
        e = [dists.exponential()]
        _, _, plain = self._sample(e, 2)
        _, _, sd = self._sample(e, 2, with_shared=True)
        _, _, both = self._sample(e, 2, with_shared=True, with_degr=True)
        _, _, sd3 = self._sample(e, 3, with_shared=True)
        assert torch.equal(sd[..., :2], plain)
        assert torch.equal(both[..., :3], sd)
        assert torch.equal(sd3[..., 3], sd[..., 2])   # shared across k
        u = both[..., 3:]
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0

    def test_healthy_and_paper_cells_keep_bits_in_mixed_grid(self):
        d = dists.pareto(2.2)
        kw = dict(n_seeds=2, percentiles=(50.0, 99.0), chunk_size=700, **CPU)
        pure = queueing.run(2, Scenario.paper_default(d, ks=(1, 2)),
                            [0.1, 0.3], self.CFG, **kw)
        mixed = queueing.run(2, (
            Scenario.paper_default(d, ks=(1, 2)),
            Scenario(dists=d, policy=CANCEL_ON_COMPLETE, ks=(3,),
                     service_model=SERVER_DEPENDENT, mix=0.7),
            Scenario(dists=d, policy=TIMEOUT_RETRY, delay=1.0, ks=(2,),
                     degradation=Degradation(p_slow=0.1, slow_factor=3.0,
                                             p_fail=0.1))),
            [0.1, 0.3], self.CFG, **kw)
        for key in ("mean", "p50", "p99", "completed"):
            assert torch.equal(mixed[key][..., :2], pure[key]), key
        assert bool((mixed["completed"][..., 3] == pure["count"]).all())

    def test_grid_carries_kernel_ready_counts_and_indices(self):
        variants = (Scenario.paper_default(dists.exponential(), ks=(1, 3))
                    .variants()
                    + Scenario(dists=dists.pareto(2.5), policy=HEDGE_AFTER_DELAY,
                               delay=0.5, ks=(2,)).variants())
        grid = queueing._engine_grid(2, [0.1, 0.2], self.CFG, variants,
                                     torch.device("cpu"))
        kw = grid.flags()
        assert kw["k_count"].dtype == torch.int32
        assert torch.equal(kw["k_count"],
                           grid.k_mask.sum(dim=1, dtype=torch.int32))
        assert torch.equal(cell_kernel.prefix_counts(grid.k_mask),
                           kw["k_count"])
        assert grid.seed_idx.dtype == torch.int32
        assert torch.equal(grid.seed_idx.long(), grid.plan.seed_idx)
        assert grid.cell_args()[0] is grid.seed_idx

    def test_pipeline_on_equals_off(self):
        scn = Scenario(dists=dists.weibull(0.5), policy=REPLICATE_TO_IDLE,
                       ks=(1, 2))
        kw = dict(n_seeds=2, percentiles=(99.0,), chunk_size=512, **CPU)
        on = queueing.run(5, scn, [0.2, 0.4], self.CFG, pipeline="on", **kw)
        off = queueing.run(5, scn, [0.2, 0.4], self.CFG, pipeline="off", **kw)
        for key in ("mean", "p99", "completed"):
            assert torch.equal(on[key], off[key]), key

    def test_hedge_delay_zero_is_replicate_all(self):
        d = dists.exponential()
        kw = dict(n_seeds=1, percentiles=(99.0,), chunk_size=1000, **CPU)
        a = queueing.run(6, Scenario.paper_default(d, ks=(2,)), [0.2],
                         self.CFG, **kw)
        b = queueing.run(6, Scenario(dists=d, policy=HEDGE_AFTER_DELAY,
                                     delay=0.0, ks=(2,)), [0.2], self.CFG,
                         **kw)
        assert torch.equal(a["mean"], b["mean"])


class TestRunGuards:
    SCN = Scenario.paper_default(dists.exponential())

    def test_cuda_requested_without_cuda_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            queueing.run(0, self.SCN, [0.2], queueing.SimConfig(), )
        with pytest.raises(RuntimeError, match="CUDA"):
            queueing.run(0, self.SCN, [0.2], queueing.SimConfig(),
                         device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            queueing.make_sampler(0, [dists.exponential()],
                                  queueing.SimConfig(), 1, 1)
        with pytest.raises(RuntimeError, match="CUDA"):
            cellplan.make_cell_plan(1, 2, 2)
        with pytest.raises(RuntimeError, match="CUDA"):
            interop.NumpySampler([])
        with pytest.raises(RuntimeError, match="CUDA"):
            interop.to_tensor(np.zeros(3, np.float32))

    def test_kernel_on_cpu_raises_and_modes_checked(self):
        cfg = queueing.SimConfig(n_servers=4, n_arrivals=64)
        with pytest.raises(RuntimeError, match="CUDA"):
            queueing.run(0, self.SCN, [0.2], cfg, kernel="on", **CPU)
        with pytest.raises(ValueError, match="kernel"):
            queueing.run(0, self.SCN, [0.2], cfg, kernel="interpret", **CPU)
        with pytest.raises(ValueError, match="pipeline"):
            queueing.run(0, self.SCN, [0.2], cfg, pipeline="maybe", **CPU)

    def test_mesh_takes_the_checks_of_the_jax_executor(self):
        # a mesh that is not a 1-D ("cells",) mesh raises ValueError and a
        # bare sampler callable TypeError, as repro.distributed.sweep_shard
        from repro_torch.distributed import sweep_shard
        from repro_torch.launch.mesh import make_sweep_mesh
        with pytest.raises(ValueError, match="cells"):
            queueing.run(0, self.SCN, [0.2], queueing.SimConfig(),
                         mesh=object(), **CPU)
        with pytest.raises(TypeError, match="ChunkSampler"):
            sweep_shard._sweep_cells_sharded(
                lambda c, t: None, 1, [0.2], queueing.SimConfig(),
                variants=self.SCN.variants(), warmup_frac=0.1,
                percentiles=(), n_bins=64, chunk_size=1_000,
                mesh=make_sweep_mesh(devices=("cpu",)),
                device=torch.device("cpu"))
