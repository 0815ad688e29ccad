"""The port's training substrate (``repro_torch.{data,checkpoint,training}``)
on the CPU: the twins of ``tests/test_training.py`` (every class) and of
``test_properties.py``'s data and grad-agg classes, and the port held
against the JAX package on identical numpy inputs.

Tolerances, measured on these inputs:
  * Batches: byte-equal to JAX's (the same numpy code).
  * AdamW, three steps on float32 and bf16 leaves with clipped grads:
    parameters, masters and moments bit-equal to JAX's (measured; the
    port follows the reference's arithmetic operation by operation).
  * Adafactor on the tiny model's JAX leaves (a stacked (R, ...) leaf per
    pattern position), two steps: parameters within one bf16 ulp
    (measured: 3.1e-5 at most, one ulp of a small weight), factored
    moments within 1e-5 relative (measured 2.8e-6). The same update per
    tensor moves the parameters by up to 0.094 (a step is 0.36): the
    grouping matters.
  * The tiny config's ``Trainer`` over 8 steps from JAX's weights:
    losses within ``LOSS_RTOL`` = 1e-3 relative of JAX's at every step,
    the loss tolerance of ``tests/test_torch_train_lm.py`` (JAX's own two
    programs differ by up to 5.4e-4); measured up to 4.7e-4.
  * Crash and resume: bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.data import pipeline as jpipeline
from repro.models import lm as jlm
from repro.training import grad_agg as jgrad_agg
from repro.training import optimizer as jopt
from repro.training.train_loop import Trainer as JaxTrainer
from repro.training.train_loop import TrainerConfig as JaxTrainerConfig
from repro_torch import interop
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import (DataConfig, HedgedPrefetcher,
                                       MarkovSource, UniformSource)
from repro_torch.models import lm
from repro_torch.training import grad_agg
from repro_torch.training.optimizer import (OptConfig, clip_by_global_norm,
                                            make_optimizer)
from repro_torch.training.train_loop import Trainer, TrainerConfig

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need hypothesis")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

SMALL = settings(max_examples=10, deadline=None,
                 suppress_health_check=[HealthCheck.too_slow])
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=2,
            n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64,
            pattern=("global",), tie_embeddings=True, recipe="tp",
            long_context_ok=False)
BF16_ULP = 2.0**-7
LOSS_RTOL = 1e-3


def tiny_cfg() -> ModelConfig:
    return ModelConfig(**TINY)


def quiet(*_):
    pass


def f32(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


class TestData:
    def test_batch_at_deterministic(self):
        cfg = tiny_cfg()
        d = DataConfig(seq_len=16, batch_size=4, seed=3)
        s1, s2 = UniformSource(cfg, d), UniformSource(cfg, d)
        np.testing.assert_array_equal(s1.batch_at(7)["tokens"],
                                      s2.batch_at(7)["tokens"])
        assert not np.array_equal(s1.batch_at(7)["tokens"],
                                  s1.batch_at(8)["tokens"])

    def test_shards_disjoint_streams(self):
        cfg = tiny_cfg()
        a = UniformSource(cfg, DataConfig(seq_len=16, batch_size=4, shard=0,
                                          num_shards=2))
        b = UniformSource(cfg, DataConfig(seq_len=16, batch_size=4, shard=1,
                                          num_shards=2))
        assert not np.array_equal(a.batch_at(0)["tokens"],
                                  b.batch_at(0)["tokens"])

    def test_markov_source_structured(self):
        cfg = tiny_cfg()
        src = MarkovSource(cfg, DataConfig(seq_len=64, batch_size=8))
        toks = src.batch_at(0)["tokens"]
        succ = src.successors
        for b in range(toks.shape[0]):
            for t in range(1, toks.shape[1]):
                assert toks[b, t] in succ[toks[b, t - 1]]

    def test_hedged_prefetcher_identical_batches(self):
        cfg = tiny_cfg()
        src = UniformSource(cfg, DataConfig(seq_len=16, batch_size=4))
        pf = HedgedPrefetcher(src, k=3)
        np.testing.assert_array_equal(pf.get(0)["tokens"],
                                      src.batch_at(0)["tokens"])

    @pytest.mark.parametrize("arch", ["tiny", "musicgen-large",
                                      "llava-next-34b", "gemma2-2b"])
    @pytest.mark.parametrize("source", ["uniform", "markov"])
    def test_batches_byte_equal_jax(self, arch, source):
        """The same config, seed, shard and step give byte-equal batches
        in both packages (audio grids, VLM patches and Markov chains
        included)."""
        if arch == "tiny":
            cfg, jcfg = tiny_cfg(), JaxModelConfig(**TINY)
        else:
            cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
        d = dict(seq_len=24, batch_size=3, seed=11, shard=1, num_shards=2)
        mine = {"uniform": UniformSource, "markov": MarkovSource}[source](
            cfg, DataConfig(**d))
        theirs = {"uniform": jpipeline.UniformSource,
                  "markov": jpipeline.MarkovSource}[source](
            jcfg, jpipeline.DataConfig(**d))
        for step in (0, 5, 123):
            a, b = mine.batch_at(step), theirs.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes(), (k, step)


# ---------------------------------------------------------------------------
# Checkpoint
# ---------------------------------------------------------------------------


class TestCheckpoint:
    def test_roundtrip_bf16(self, tmp_path):
        tree = {"a": torch.ones((4, 3), dtype=torch.bfloat16) * 1.5,
                "b": [torch.arange(5, dtype=torch.float32),
                      torch.tensor(7, dtype=torch.int32)]}
        ckpt.save(tmp_path, 3, tree)
        out = ckpt.restore(tmp_path, 3, tree)
        assert out["a"].dtype == torch.bfloat16
        assert torch.equal(out["a"], tree["a"])
        assert torch.equal(out["b"][0], tree["b"][0])
        assert int(out["b"][1]) == 7

    def test_latest_and_cleanup(self, tmp_path):
        tree = {"x": torch.zeros(2)}
        for s in (1, 2, 3, 4):
            ckpt.save(tmp_path, s, tree, keep_last=2)
        assert ckpt.latest_step(tmp_path) == 4
        assert not (tmp_path / "step_00000001").exists()
        assert (tmp_path / "step_00000003").exists()

    def test_async_checkpointer(self, tmp_path):
        c = ckpt.AsyncCheckpointer(tmp_path)
        x = torch.ones(3)
        c.save(5, {"x": x})
        x.add_(1.0)  # the snapshot was taken on this thread, before
        c.wait()
        out = ckpt.restore(tmp_path, 5, {"x": torch.zeros(3)})
        assert torch.equal(out["x"], torch.ones(3))

    def test_async_error_raised_at_next_wait(self, tmp_path):
        (tmp_path / "f").write_text("")  # a file where the dir must go
        c = ckpt.AsyncCheckpointer(tmp_path / "f" / "ckpt")
        with pytest.raises(OSError):
            c.save(1, {"x": torch.ones(2)})
            c.wait()
        c.wait()  # raised once

    def test_stale_temporary_is_swept_and_latest_kept(self, tmp_path):
        """A save that died mid-write leaves a ``.tmp_step`` directory; the
        latest published step is untouched and the next save sweeps it."""
        ckpt.save(tmp_path, 1, {"x": torch.ones(2)})
        (tmp_path / ".tmp_step_00000002").mkdir()
        assert ckpt.latest_step(tmp_path) == 1
        ckpt.save(tmp_path, 3, {"x": torch.ones(2)})
        assert not (tmp_path / ".tmp_step_00000002").exists()

    def test_layout_equals_jax(self, tmp_path):
        """Either package restores the other's checkpoint of the same
        tree: the same keys (``"||"``-joined paths), uint16 bf16 and
        dtypes."""
        rng = np.random.default_rng(0)
        a = rng.standard_normal((4, 3)).astype(np.float32)
        b = rng.standard_normal(5).astype(np.float32)
        jtree = {"a": jnp.asarray(a, jnp.bfloat16),
                 "b": [jnp.asarray(b), jnp.int32(7)]}
        ttree = {"a": interop.to_tensor(np.asarray(jtree["a"]), "cpu"),
                 "b": [torch.from_numpy(b), torch.tensor(7, dtype=torch.int32)]}
        jckpt.save(tmp_path / "j", 2, jtree)
        ckpt.save(tmp_path / "t", 2, ttree)
        mine = ckpt.restore(tmp_path / "j", 2, ttree)
        theirs = jckpt.restore(tmp_path / "t", 2, jtree)
        assert torch.equal(mine["a"], ttree["a"])
        assert torch.equal(mine["b"][0], ttree["b"][0])
        np.testing.assert_array_equal(f32(theirs["a"]), f32(jtree["a"]))
        assert int(theirs["b"][1]) == 7
        for d in ("j", "t"):
            with np.load(tmp_path / d / "step_00000002" / "arrays.npz") as z:
                assert sorted(z.files) == ["a", "b||0", "b||1"]
                assert z["a"].dtype == np.uint16


# ---------------------------------------------------------------------------
# Fault tolerance and the trainer against JAX's
# ---------------------------------------------------------------------------


def make_trainer(tdir, fail_at=None, async_ckpt=False):
    return Trainer(tiny_cfg(), DataConfig(seq_len=16, batch_size=4, seed=1),
                   TrainerConfig(ckpt_dir=str(tdir), ckpt_every=3,
                                 async_ckpt=async_ckpt, log_every=100,
                                 fail_at_step=fail_at),
                   log_fn=quiet, device="cpu")


class TestFaultTolerance:
    @pytest.mark.parametrize("async_ckpt", [False, True])
    def test_crash_resume_bitwise_identical(self, tmp_path, async_ckpt):
        straight = make_trainer(tmp_path / "a", None, async_ckpt).run(8)
        crashed = make_trainer(tmp_path / "b", 5, async_ckpt)
        with pytest.raises(RuntimeError, match="injected failure"):
            crashed.run(8, seed=0)
        resumed = make_trainer(tmp_path / "b", None, async_ckpt).run(8)
        a = dict(straight["model"].named_parameters())
        b = dict(resumed["model"].named_parameters())
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
        for part in ("m", "v", "master"):
            for k in a:
                assert torch.equal(straight["opt"][part][k],
                                   resumed["opt"][part][k]), (part, k)
        assert resumed["history"][-1]["loss"] == \
            straight["history"][-1]["loss"]

    def test_loss_decreases_on_markov_data(self, tmp_path):
        tr = Trainer(tiny_cfg(), DataConfig(seq_len=32, batch_size=8, seed=2),
                     TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=1000,
                                   log_every=5, async_ckpt=False),
                     log_fn=quiet, device="cpu")
        hist = tr.run(40, seed=0)["history"]
        assert hist[-1]["loss"] < hist[0]["loss"] - 0.3

    def test_no_checkpoint_when_ckpt_every_is_zero(self, tmp_path):
        tr = Trainer(tiny_cfg(), DataConfig(seq_len=8, batch_size=2),
                     TrainerConfig(ckpt_dir=str(tmp_path / "c"),
                                   ckpt_every=0),
                     log_fn=quiet, device="cpu")
        tr.run(2)
        assert not (tmp_path / "c").exists()

    def test_trainer_losses_match_jax(self, tmp_path):
        """Both trainers from JAX's weights on the same Markov batches for
        8 steps (AdamW, lr 1e-3): every step's loss within LOSS_RTOL."""
        jcfg = JaxModelConfig(**TINY)
        dcfg = dict(seq_len=16, batch_size=4, seed=1)
        jtr = JaxTrainer(jcfg, jpipeline.DataConfig(**dcfg),
                         JaxTrainerConfig(ckpt_dir=str(tmp_path / "j"),
                                          ckpt_every=1000, log_every=1,
                                          async_ckpt=False),
                         log_fn=quiet)
        jout = jtr.run(8, seed=0)
        params = jax.device_get(jlm.init(jax.random.PRNGKey(0), jcfg))

        class Carried(Trainer):
            def init_state(self, seed=0):
                model, _, _ = super().init_state(seed)
                model.load_state_dict(interop.lm_params_from_numpy(
                    params, self.cfg, "cpu"), strict=True)
                opt_state = self.opt.init(dict(model.named_parameters()),
                                          lm.leaf_groups(model))
                return model, opt_state, 0

        tr = Carried(tiny_cfg(), DataConfig(**dcfg),
                     TrainerConfig(ckpt_dir=str(tmp_path / "t"),
                                   ckpt_every=0, log_every=1),
                     log_fn=quiet, device="cpu")
        out = tr.run(8, seed=0)
        mine = [h["loss"] for h in out["history"]]
        theirs = [h["loss"] for h in jout["history"]]
        assert len(mine) == len(theirs) == 8
        np.testing.assert_allclose(mine, theirs, rtol=LOSS_RTOL)
        assert mine[-1] < mine[0]


# ---------------------------------------------------------------------------
# Grad aggregation
# ---------------------------------------------------------------------------


class TestGradAgg:
    def test_masked_mean_renormalizes(self):
        g = {"w": torch.stack([torch.ones((2, 2)), 3 * torch.ones((2, 2)),
                               100 * torch.ones((2, 2))])}
        mask = torch.tensor([1.0, 1.0, 0.0])  # third microbatch straggled
        out = grad_agg.masked_grad_mean(g, mask)
        assert torch.equal(out["w"], torch.full((2, 2), 2.0))

    def test_first_m_mask(self):
        order = torch.tensor([2, 0, 3, 1])
        np.testing.assert_array_equal(
            grad_agg.first_m_mask(order, 2).numpy(), [0, 1, 0, 1])

    def test_backup_microbatch_unbiased(self):
        g = {"w": torch.randn((4, 3, 3), generator=torch.Generator()
                              .manual_seed(0))}
        full = grad_agg.masked_grad_mean(g, torch.ones(4))
        torch.testing.assert_close(full["w"], g["w"].mean(0), rtol=1e-6,
                                   atol=1e-7)

    def test_masked_mean_equals_jax(self):
        rng = np.random.default_rng(4)
        g = rng.standard_normal((5, 3, 7)).astype(np.float32)
        mask = np.asarray([1, 0, 1, 1, 0], np.float32)
        mine = grad_agg.masked_grad_mean({"w": torch.from_numpy(g)},
                                         torch.from_numpy(mask))["w"]
        theirs = jgrad_agg.masked_grad_mean({"w": jnp.asarray(g)},
                                            jnp.asarray(mask))["w"]
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=1e-6, atol=1e-7)

    def test_accumulate_microbatch_grads_one_backward_each(self):
        """Each microbatch's stacked grads equal that microbatch's own
        backward bit for bit, an unused parameter's as zeros, on the
        tiny model; the straggler-masked mean of them too."""
        model = lm.init(torch.Generator().manual_seed(0),
                        tiny_cfg()).requires_grad_(True)
        params = dict(model.named_parameters())
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, 64, (3, 2, 9)).astype(np.int32))

        def loss_fn(p, mb):
            return lm.loss_fn(model, mb)

        stack, losses = grad_agg.accumulate_microbatch_grads(
            loss_fn, params, {"tokens": toks}, 3)
        assert losses.shape == (3,)
        for i in range(3):
            for p in params.values():
                p.grad = None
            lm.loss_fn(model, {"tokens": toks[i]})[0].backward()
            for k, p in params.items():
                assert torch.equal(stack[k][i], p.grad), (i, k)
        mean = grad_agg.masked_grad_mean(
            stack, grad_agg.first_m_mask(torch.tensor([0, 2, 1]), 2))
        for k in params:
            want = ((stack[k][0].float() + stack[k][2].float())
                    / 2).to(stack[k].dtype)
            assert torch.equal(mean[k], want), k


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


class TestOptimizers:
    def test_adamw_first_step_is_lr_sized(self):
        params = {"w": torch.zeros(4)}
        opt = make_optimizer("adamw", lr=0.1, weight_decay=0.0)
        state = opt.init(params)
        new_p, _, _ = opt.update(params, {"w": torch.ones(4)}, state, 0)
        torch.testing.assert_close(new_p["w"], torch.full((4,), -0.1),
                                   rtol=1e-4, atol=0)

    def test_adafactor_factored_states_shapes(self):
        params = {"w": torch.zeros((8, 4)), "b": torch.zeros(4)}
        state = make_optimizer("adafactor", lr=0.01).init(params)
        assert state["v_row"]["w"].shape == (8,)
        assert state["v_col"]["w"].shape == (4,)
        assert state["v_col"]["b"].shape == (4,)

    def test_adafactor_reduces_loss_direction(self):
        params = {"w": torch.tensor([10.0, -10.0])}
        opt = make_optimizer("adafactor", lr=0.1, weight_decay=0.0)
        state = opt.init(params)
        new_p, _, _ = opt.update(params, {"w": torch.tensor([1.0, -1.0])},
                                 state, 0)
        assert float(new_p["w"][0]) < 10.0
        assert float(new_p["w"][1]) > -10.0

    def test_grad_clip(self):
        clipped, norm = clip_by_global_norm({"w": torch.full((4,), 100.0)},
                                            1.0)
        assert float(norm) == pytest.approx(200.0)
        total = float(torch.sqrt(torch.sum(torch.square(clipped["w"]))))
        assert total == pytest.approx(1.0, rel=1e-4)

    def test_adamw_matches_jax(self):
        """Three steps on float32 and bf16 leaves with grads large enough
        to clip: parameters, masters and moments bit-equal to JAX's, the
        grad norm within 1e-6."""
        rng = np.random.default_rng(5)
        p_np = {"a": rng.standard_normal((6, 5)).astype(np.float32),
                "b": rng.standard_normal(7).astype(np.float32)}
        jparams = {"a": jnp.asarray(p_np["a"]),
                   "b": jnp.asarray(p_np["b"], jnp.bfloat16)}
        params = {"a": torch.from_numpy(p_np["a"].copy()),
                  "b": interop.to_tensor(np.asarray(jparams["b"]), "cpu")}
        cfg = OptConfig(lr=1e-2)
        jo, opt = jopt.Optimizer(jopt.OptConfig(lr=1e-2)), make_optimizer(
            "adamw", lr=1e-2)
        jstate, state = jo.init(jparams), opt.init(params)
        for step in range(3):
            g_np = {k: (3 * rng.standard_normal(v.shape)).astype(np.float32)
                    for k, v in p_np.items()}
            jg = {"a": jnp.asarray(g_np["a"]),
                  "b": jnp.asarray(g_np["b"], jnp.bfloat16)}
            g = {k: interop.to_tensor(np.asarray(v), "cpu")
                 for k, v in jg.items()}
            _, jn = jopt.clip_by_global_norm(jg, cfg.grad_clip)
            jparams, jstate = jo.update(jparams, jg, jstate, jnp.int32(step))
            _, state, norm = opt.update(params, g, state, step)
            assert float(norm) == pytest.approx(float(jn), rel=1e-6)
        for k in p_np:
            for part in ("m", "v", "master"):
                np.testing.assert_array_equal(state[part][k].numpy(),
                                              f32(jstate[part][k]))
            np.testing.assert_array_equal(params[k].float().numpy(),
                                          f32(jparams[k]))

    def test_adafactor_matches_jax_on_stacked_leaves(self):
        """Adafactor on the tiny model (two layers stacked into each
        ``blocks/pos0`` leaf, as JAX keeps them), grouped by JAX leaf:
        parameters and factored moments equal JAX's to rounding; per
        tensor instead (no groups), the stacked norm scales are not
        factored and the update clip sees each layer alone, and the
        parameters move elsewhere."""
        cfg, jcfg = tiny_cfg(), JaxModelConfig(**TINY)
        jparams = jax.device_get(jlm.init(jax.random.PRNGKey(0), jcfg))
        rng = np.random.default_rng(6)
        jgrads = jax.tree.map(
            lambda x: jnp.asarray(rng.standard_normal(np.shape(x)) * 0.02,
                                  x.dtype), jparams)
        jo = jopt.make_optimizer("adafactor", lr=0.05)
        jstate = jo.init(jparams)
        jparams2 = jparams
        for step in range(2):
            jparams2, jstate = jo.update(jparams2, jgrads, jstate,
                                         jnp.int32(step))

        def port(grouped):
            model = lm.init(torch.Generator().manual_seed(0), cfg)
            model.load_state_dict(interop.lm_params_from_numpy(
                jax.device_get(jlm.init(jax.random.PRNGKey(0), jcfg)), cfg,
                "cpu"), strict=True)
            params = dict(model.named_parameters())
            grads = interop.lm_params_from_numpy(jax.device_get(jgrads), cfg,
                                                 "cpu")
            groups = lm.leaf_groups(model) if grouped else None
            opt = make_optimizer("adafactor", lr=0.05)
            state = opt.init(params, groups)
            for step in range(2):
                opt.update(params, grads, state, step, groups)
            return params, state

        params, state = port(True)
        want = interop.lm_params_from_numpy(jax.device_get(jparams2), cfg,
                                            "cpu")
        for k, p in params.items():
            np.testing.assert_allclose(p.float().numpy(),
                                       want[k].float().numpy(),
                                       rtol=BF16_ULP, atol=1e-6)
        jst = interop.opt_state_from_numpy(jax.device_get(jstate), cfg,
                                           "cpu")
        assert jst["v_row"]["blocks.pos0.mlp_norm.scale"].shape == (2,)
        for part in ("v_row", "v_col"):
            assert state[part].keys() == jst[part].keys()
            for k in state[part]:
                w = jst[part][k].numpy()
                np.testing.assert_allclose(state[part][k].numpy(), w,
                                           rtol=1e-5,
                                           atol=1e-5 * float(np.abs(w).max()))
        loose, _ = port(False)
        moved = max(float((loose[k].float() - want[k].float()).abs().max())
                    for k in params)
        assert moved > 10 * BF16_ULP * 0.05

    def test_adamw_state_crosses_interop(self):
        cfg, jcfg = tiny_cfg(), JaxModelConfig(**TINY)
        jparams = jax.device_get(jlm.init(jax.random.PRNGKey(0), jcfg))
        jstate = jax.device_get(jopt.make_optimizer("adamw").init(jparams))
        st = interop.opt_state_from_numpy(jstate, cfg, "cpu")
        model = lm.init(torch.Generator().manual_seed(0), cfg)
        names = {n for n, _ in model.named_parameters()}
        assert set(st) == {"m", "v", "master"}
        assert all(set(st[k]) == names for k in st)
        assert all(t.dtype == torch.float32 for k in st
                   for t in st[k].values())


# ---------------------------------------------------------------------------
# Property twins (test_properties.py)
# ---------------------------------------------------------------------------


class TestDataInvariants:
    @SMALL
    @given(step=st.integers(min_value=0, max_value=10_000),
           seed=st.integers(min_value=0, max_value=2**31 - 1))
    def test_batch_pure_function_of_step(self, step, seed):
        cfg = get_smoke_config("nemotron-4-15b")
        d = DataConfig(seq_len=8, batch_size=2, seed=seed)
        a = UniformSource(cfg, d).batch_at(step)["tokens"]
        b = UniformSource(cfg, d).batch_at(step)["tokens"]
        np.testing.assert_array_equal(a, b)
        assert a.min() >= 0 and a.max() < cfg.vocab_size


class TestGradAggInvariants:
    @SMALL
    @given(n=st.integers(min_value=1, max_value=6),
           m=st.integers(min_value=1, max_value=6),
           seed=st.integers(min_value=0, max_value=2**31 - 1))
    def test_masked_mean_bounded_by_extremes(self, n, m, seed):
        m = min(m, n)
        g = {"w": torch.randn((n, 4), generator=torch.Generator()
                              .manual_seed(seed))}
        order = torch.from_numpy(np.random.default_rng(seed).permutation(n))
        out = grad_agg.masked_grad_mean(g, grad_agg.first_m_mask(order, m))
        assert bool((out["w"] >= g["w"].min(0).values - 1e-5).all())
        assert bool((out["w"] <= g["w"].max(0).values + 1e-5).all())


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def test_train_cli_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", "mamba2-370m", "--smoke", "--steps", "3",
                      "--seq-len", "16", "--batch", "2", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                      "--log-every", "1"])
    assert len(out["history"]) == 3
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in out["history"])
    assert ckpt.latest_step(tmp_path) == 3
    assert "[train] done" in capsys.readouterr().out


def test_train_100m_example_config_equals_jax():
    """The port's example trains the JAX example's 105M model."""
    import importlib.util
    from repro_torch.examples import train_100m
    spec = importlib.util.spec_from_file_location(
        "jax_train_100m", "examples/train_100m.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    mine, theirs = train_100m.model_100m(), jmod.model_100m()
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def test_train_100m_example_runs_on_the_cpu(tmp_path, monkeypatch):
    """The example's ``main`` end to end on a narrowed model (its own
    105M model takes seconds a step on the CPU), resuming after an
    injected failure."""
    from repro_torch.examples import train_100m
    small = dataclasses.replace(train_100m.model_100m(), n_layers=2,
                                d_model=64, n_heads=2, n_kv_heads=2,
                                head_dim=32, d_ff=128, vocab_size=512)
    monkeypatch.setattr(train_100m, "model_100m", lambda: small)
    args = ["--steps", "6", "--seq-len", "16", "--batch", "2", "--device",
            "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "1"]
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        train_100m.main(args + ["--fail-at-step", "3"])
    out = train_100m.main(args)
    assert out["history"][0]["step"] == 2  # resumed from step 2
    assert ckpt.latest_step(tmp_path) == 6



def test_chip_smoke_phase17_runs_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s phase 17 (``training``: evaluation losses,
    ``launch.train.main``, the example's crash and bitwise resume) end to
    end at the smoke configs on the CPU, with the kernels' plain versions
    standing in for the kernels, the card's clock and memory calls and
    the profiler stubbed, and the example's model narrowed: every gate
    holds."""
    import importlib.util
    import os

    from repro_torch.examples import train_100m
    from repro_torch.kernels import dispatch
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_rehearsal17",
                                                  path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(dispatch, "resolve", lambda kernel, device: "off")
    monkeypatch.setattr(cs, "traced", lambda fn, top=4: fn() and {
        "idle_share": None})
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    monkeypatch.setattr(cs, "TRAIN_SMOKE", True)
    monkeypatch.setattr(cs, "TRAIN_RUNS", (("gemma2-2b", 24, 1),
                                           ("mamba2-370m", 20, 2)))
    monkeypatch.setattr(cs, "EXAMPLE_ARGS", ["--seq-len", "16", "--batch",
                                             "4"])
    small = dataclasses.replace(train_100m.model_100m(), n_layers=2,
                                d_model=64, n_heads=2, n_kv_heads=2,
                                head_dim=32, d_ff=128, vocab_size=256)
    monkeypatch.setattr(train_100m, "model_100m", lambda: small)
    out = cs.training(torch.device("cpu"))
    assert set(out["train"]) == {"gemma2-2b", "mamba2-370m"}
    assert out["example"]["resumed_bit_equal"]
    assert out["example"]["loss_first"] - out["example"]["loss_last"] >= 0.3
    text = capsys.readouterr().out
    assert "crashed as injected: injected failure at step 30" in text
    assert "[17] phase 17:" in text
