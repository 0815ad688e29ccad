"""The port's served LM path (gemma2-2b) against the JAX package, on the CPU.

Weights come from JAX ``lm.init`` and are carried into the port bit for
bit (``interop.lm_params_from_numpy``); the same numpy prompt goes through
JAX ``decode.prefill``/``decode_step`` — under both ``impl="ref"`` and
``impl="pallas"`` (interpret mode) — and through the port's plain path.

Tolerance on logits: 0.21, under twice the gap between JAX's own two
paths (0.106 on a 40-token gemma2-2b smoke prompt, logits up to 27.5
under the final softcap of 30). The paths round bf16 intermediates at
different points, and so does the port: eager PyTorch rounds every op's
bf16 output, where XLA keeps excess precision inside its fusions. The
largest gap these tests meet is 0.202, between the port and the Pallas
path at the full head shape (decode step 1, logits near the softcap of
30; JAX's own paths differ by 0.083 there). Caches: positions exactly,
keys and values (bf16, magnitudes of a few units) to 0.05, two bf16
roundings of 2**-8.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import decode as jdec
from repro.models import lm as jlm
from repro_torch import interop
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import decode, layers, lm

LOGIT_TOL = 0.21
KV_TOL = 0.05
MAX_LEN = 64


def carried(jcfg, cfg, seed=0):
    params = jax.device_get(jlm.init(jax.random.PRNGKey(seed), jcfg))
    model = lm.init(torch.Generator("cpu").manual_seed(seed), cfg)
    model.load_state_dict(interop.lm_params_from_numpy(params, cfg, "cpu"),
                          strict=True, assign=True)
    return params, model


@pytest.fixture(scope="module")
def smoke():
    jcfg, cfg = jax_smoke_config("gemma2-2b"), get_smoke_config("gemma2-2b")
    params, model = carried(jcfg, cfg)
    return jcfg, cfg, params, model


def prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (1, n)).astype(
        np.int32)


def assert_caches_close(port_cache, jax_cache, cfg):
    got = interop.lm_cache_to_numpy(port_cache, cfg)
    for i in range(len(cfg.pattern)):
        g, w = got["blocks"][f"pos{i}"], jax_cache["blocks"][f"pos{i}"]
        np.testing.assert_array_equal(g["pos"], np.asarray(w["pos"]))
        for key in ("k", "v"):
            assert g[key].dtype == np.asarray(w[key]).dtype
            np.testing.assert_allclose(np.asarray(g[key], np.float32),
                                       np.asarray(w[key], np.float32),
                                       rtol=0, atol=KV_TOL)


def run_both(jcfg, cfg, params, model, toks, n_steps, impl):
    """Prefill then ``n_steps`` teacher-forced decode steps in both
    packages; yields (step, port logits, JAX logits, port cache, JAX
    cache) with step -1 for the prefill."""
    s = toks.shape[1]
    jpre = jax.jit(lambda p, b: jdec.prefill(p, jcfg, b, MAX_LEN, impl=impl))
    jstep = jax.jit(lambda p, c, t, pos: jdec.decode_step(p, jcfg, c, t, pos,
                                                          impl=impl))
    jl, jc = jpre(params, {"tokens": jnp.asarray(toks)})
    pl, pc = decode.prefill(model, torch.from_numpy(toks), MAX_LEN)
    yield -1, pl, jl, pc, jax.device_get(jc)
    nxt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                            (n_steps, 1, 1)).astype(np.int32)
    for i in range(n_steps):
        jl, jc = jstep(params, jc, jnp.asarray(nxt[i]), jnp.int32(s + i))
        pl, pc = decode.decode_step(model, pc, torch.from_numpy(nxt[i]), s + i)
        yield i, pl, jl, pc, jax.device_get(jc)


def test_params_carried_bit_for_bit(smoke):
    jcfg, cfg, params, model = smoke
    state = model.state_dict()
    assert len(state) == 2 + cfg.n_layers * 11  # 11 leaves a block
    table = np.asarray(params["embed"]["table"])
    assert table.dtype.name == "bfloat16"
    np.testing.assert_array_equal(
        state["embed.table"].view(torch.int16).numpy(), table.view(np.int16))
    # blocks/pos{i}[r] is layer r * len(pattern) + i
    wq = np.asarray(params["blocks"]["pos1"]["mixer"]["wq"]["w"])
    for r in range(cfg.repeats):
        layer = r * len(cfg.pattern) + 1
        assert model.blocks[layer].kind == "global"
        np.testing.assert_array_equal(
            state[f"blocks.{layer}.mixer.wq.w"].view(torch.int16).numpy(),
            wq[r].view(np.int16))
    assert state["final_norm.scale"].dtype == torch.float32


def test_bf16_round_trip_keeps_every_bit():
    bits = np.random.default_rng(0).integers(0, 2**16, 4096).astype(np.uint16)
    x = np.asarray(jnp.asarray(bits.view(jnp.bfloat16)))
    t = interop.to_tensor(x, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.uint16).numpy(), bits)
    back = interop.to_numpy(t)
    assert back.dtype == x.dtype
    np.testing.assert_array_equal(back.view(np.uint16), bits)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_prefill_and_decode_match_jax(smoke, impl):
    """A 40-token prompt, longer than the smoke window of 16, wraps the
    local layers' ring buffer in prefill and again over 8 teacher-forced
    decode steps."""
    jcfg, cfg, params, model = smoke
    toks = prompt(0, 40, cfg.vocab_size)
    for step, pl, jl, pc, jc in run_both(jcfg, cfg, params, model, toks, 8,
                                         impl):
        assert pl.dtype == torch.float32 and pl.shape == (1, cfg.vocab_size)
        err = np.abs(pl.numpy() - np.asarray(jl)).max()
        assert err <= LOGIT_TOL, (step, err)
        assert_caches_close(pc, jc, cfg)
    # the local ring has wrapped: it holds the last 16 positions only
    assert sorted(pc[0]["pos"].tolist()) == list(range(48 - 16, 48))


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_full_head_shape_matches_jax(impl):
    """gemma2-2b's attention widths (8 heads over 4 KV heads, head_dim
    256) with 2 layers, a narrower residual and a reduced vocabulary."""
    kw = dict(n_layers=2, d_model=256, d_ff=512, vocab_size=1024,
              n_heads=8, n_kv_heads=4, head_dim=256, window=16)
    full = get_config("gemma2-2b")
    assert (full.n_heads, full.n_kv_heads, full.head_dim) == (8, 4, 256)
    jcfg = dataclasses.replace(jax_smoke_config("gemma2-2b"), **kw)
    cfg = dataclasses.replace(get_smoke_config("gemma2-2b"), **kw)
    params, model = carried(jcfg, cfg, seed=3)
    toks = prompt(2, 24, cfg.vocab_size)
    for step, pl, jl, pc, jc in run_both(jcfg, cfg, params, model, toks, 3,
                                         impl):
        err = np.abs(pl.numpy() - np.asarray(jl)).max()
        assert err <= LOGIT_TOL, (step, err)
        assert_caches_close(pc, jc, cfg)


def test_decode_from_empty_cache_matches_jax(smoke):
    """Decode from position 0 on an empty cache: the port's
    ``decode.init_cache`` equals JAX's carried across, and 4 steps agree."""
    jcfg, cfg, params, model = smoke
    jc = jax.device_get(jdec.init_cache(jcfg, 1, MAX_LEN))
    pc = decode.init_cache(cfg, 1, MAX_LEN, "cpu")
    carried_cache = interop.lm_cache_from_numpy(jc, cfg, "cpu")
    for mine, theirs in zip(pc, carried_cache):
        for key in ("k", "v", "pos"):
            assert torch.equal(mine[key], theirs[key]), key
    assert [c["k"].shape[1] for c in pc] == [16, MAX_LEN] * 2
    toks = prompt(4, 4, cfg.vocab_size)
    jstep = jax.jit(lambda p, c, t, pos: jdec.decode_step(p, jcfg, c, t, pos))
    for i in range(4):
        t = toks[:, i:i + 1]
        jl, jc = jstep(params, jc, jnp.asarray(t), jnp.int32(i))
        pl, pc = decode.decode_step(model, pc, torch.from_numpy(t), i)
        assert np.abs(pl.numpy() - np.asarray(jl)).max() <= LOGIT_TOL
    assert_caches_close(pc, jax.device_get(jc), cfg)


def test_full_config_counts():
    cfg = get_config("gemma2-2b")
    assert cfg.param_count == 2_614_099_968
    assert cfg.layer_kinds == ("local", "global") * 13
    assert (cfg.vocab_padded, cfg.window) == (256_000, 4096)


def test_own_init_draws_reference_distributions():
    cfg = get_smoke_config("gemma2-2b")
    model = lm.init(torch.Generator("cpu").manual_seed(5), cfg)
    w = model.blocks[0].mlp.up.w.float() * cfg.d_model**0.5
    assert w.dtype == torch.float32 and float(w.abs().max()) <= 2.0
    # std of a standard normal truncated to [-2, 2]
    assert abs(float(w.std()) - 0.8796) < 0.02
    assert float(model.final_norm.scale.abs().max()) == 0.0
    assert model.embed.table.dtype == layers.DEFAULT_PARAM_DTYPE


@pytest.mark.parametrize("kind", ["ssd", "rec", "mla", "global_moe"])
def test_unported_kinds_raise(kind):
    cfg = dataclasses.replace(get_smoke_config("gemma2-2b"), pattern=(kind,),
                              n_layers=2)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        lm.init(torch.Generator("cpu").manual_seed(0), cfg)


def test_dense_cache_overflow_raises(smoke):
    _, cfg, _, model = smoke
    toks = torch.from_numpy(prompt(3, 8, cfg.vocab_size))
    _, cache = decode.prefill(model, toks, 8)
    with pytest.raises(ValueError, match="max_len"):
        decode.decode_step(model, cache, toks[:, :1], 8)


def test_new_modules_import_neither_jax_nor_repro():
    mods = ["repro_torch.configs", "repro_torch.models.decode",
            "repro_torch.core.hedging", "repro_torch.serving.engine",
            "repro_torch.serving.scheduler", "repro_torch.launch.serve",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.decode_attention.ops"]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or"
            " m.startswith(('jax.', 'jaxlib', 'repro.', 'ml_dtypes')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(
        os.path.join(os.path.dirname(__file__), os.pardir, "src"))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
