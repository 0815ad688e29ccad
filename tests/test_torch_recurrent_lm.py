"""The port's served recurrent LMs (mamba2-370m, recurrentgemma-9b) against
the JAX package, on the CPU.

Weights come from JAX ``lm.init`` of each smoke config and are carried
into the port bit for bit (``interop.lm_params_from_numpy``); the same
odd-length numpy prompt (21 tokens: mamba2's chunks of 8 end in a padded
one, recurrentgemma's local window of 16 wraps) and 8 teacher-forced
tokens go through JAX ``decode.prefill``/``decode_step`` — under both
``impl="ref"`` and ``impl="pallas"`` (interpret mode) — and through the
port's plain path.

Tolerance. JAX's two paths give no floor here: on mamba2's smoke model
its ``ref`` and ``pallas`` logits are identical. So the yardstick is the
port's own bf16 noise: the same model widened to float32 (``.float()``,
which makes the port compute in float32) against the bf16 port. Logits
and each cache leaf (conv states, ``h``, attention keys and values) must
lie within twice that distance of JAX's, the largest over the prefill and
the 8 steps: the rule ``chip_smoke.py`` applies on the card. Measured at
these sizes: mamba2 logits (up to 39) port vs JAX 0.52, float32 vs bf16
0.38; recurrentgemma (up to 62) 0.14 and 0.18. Greedy tokens must agree
wherever JAX's top-2 margin exceeds twice the logit tolerance; slot
positions exactly.
"""
import copy

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
from repro_torch.models import decode, lm

ARCHS = ("mamba2-370m", "recurrentgemma-9b")
PROMPT = 21
STEPS = 8
MAX_LEN = 64


def flat(tree, prefix=""):
    """(dotted path, leaf) pairs of nested dicts and lists."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from flat(sub, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from flat(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def f32(x):
    return np.asarray(x, np.float32)


_RUNS: dict = {}


def runs(arch):
    """Per arch, computed once: the carried model and, for the JAX paths
    ``ref``/``pallas`` and the port's bf16 (``port``) and float32
    (``port32``) plain paths, the logits (prefill, then each step) and
    the caches as JAX trees with numpy leaves."""
    if arch in _RUNS:
        return _RUNS[arch]
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    params = jax.device_get(jlm.init(jax.random.PRNGKey(0), jcfg))
    model = lm.init(torch.Generator("cpu").manual_seed(0), cfg)
    model.load_state_dict(interop.lm_params_from_numpy(params, cfg, "cpu"),
                          strict=True, assign=True)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PROMPT + STEPS)).astype(np.int32)
    out = {}
    for impl in ("ref", "pallas"):
        pre = jax.jit(lambda p, b, impl=impl: jdec.prefill(
            p, jcfg, b, MAX_LEN, impl=impl))
        step = jax.jit(lambda p, c, t, pos, impl=impl: jdec.decode_step(
            p, jcfg, c, t, pos, impl=impl))
        logits, cache = pre(params, {"tokens": jnp.asarray(toks[:, :PROMPT])})
        seq = [(f32(logits), jax.device_get(cache))]
        for i in range(STEPS):
            t = PROMPT + i
            logits, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.int32(t))
            seq.append((f32(logits), jax.device_get(cache)))
        out[impl] = seq
    for name, m in (("port", model), ("port32", copy.deepcopy(model).float())):
        logits, cache = decode.prefill(m, torch.from_numpy(toks[:, :PROMPT]),
                                       MAX_LEN)
        seq = [(logits.numpy(), interop.lm_cache_to_numpy(cache, cfg))]
        for i in range(STEPS):
            t = PROMPT + i
            logits, cache = decode.decode_step(
                m, cache, torch.from_numpy(toks[:, t:t + 1]), t)
            seq.append((logits.numpy(), interop.lm_cache_to_numpy(cache, cfg)))
        out[name] = seq
    _RUNS[arch] = dict(jcfg=jcfg, cfg=cfg, params=params, model=model,
                       toks=toks, **out)
    return _RUNS[arch]


def distance(a, b):
    """Largest |a - b| of the logits and of each cache leaf over the run."""
    d = {"logits": max(float(np.abs(x[0] - y[0]).max())
                       for x, y in zip(a, b))}
    for (xl, xc), (yl, yc) in zip(a, b):
        ys = dict(flat(yc))
        for path, leaf in flat(xc):
            d[path] = max(d.get(path, 0.0),
                          float(np.abs(f32(leaf) - f32(ys[path])).max()))
    return d


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carried_bit_for_bit(arch):
    r = runs(arch)
    cfg, params, model = r["cfg"], r["params"], r["model"]
    state = model.state_dict()
    n_leaves = sum(np.asarray(leaf).shape[0] if path.startswith("blocks.")
                   else 1 for path, leaf in flat(params))
    assert len(state) == n_leaves
    # blocks/pos{i}[r] is layer r * len(pattern) + i, suffix[j] follows
    n_pat = len(cfg.pattern)
    for path, leaf in flat(params):
        leaf = np.asarray(leaf)
        if path.startswith("blocks."):
            _, pos, rest = path.split(".", 2)
            i = int(pos[len("pos"):])
            pairs = [(f"blocks.{r * n_pat + i}.{rest}", leaf[r])
                     for r in range(cfg.repeats)]
        elif path.startswith("suffix."):
            _, j, rest = path.split(".", 2)
            pairs = [(f"blocks.{cfg.repeats * n_pat + int(j)}.{rest}", leaf)]
        else:
            pairs = [(path, leaf)]
        for key, want in pairs:
            got = state[key]
            if want.dtype.name == "bfloat16":
                assert got.dtype == torch.bfloat16, key
                np.testing.assert_array_equal(
                    got.view(torch.int16).numpy(), want.view(np.int16))
            else:
                assert got.dtype == torch.float32, key
                np.testing.assert_array_equal(got.numpy(), want)
    kinds = {b.kind for b in model.blocks}
    assert kinds == ({"ssd"} if arch.startswith("mamba") else
                     {"rec", "local"})
    assert all(hasattr(b, "mlp") == (b.kind != "ssd") for b in model.blocks)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, impl):
    r = runs(arch)
    cfg = r["cfg"]
    floor = distance(r["port32"], r["port"])
    gap = distance(r["port"], r[impl])
    assert set(floor) == set(gap)
    for key, d in gap.items():
        if key.endswith(".pos"):  # slot positions of the local layers
            assert d == 0.0, key
            continue
        assert 0.0 < floor[key] < 1.0, (key, floor[key])
        assert d <= 2 * floor[key], (key, d, floor[key])
    tol = 2 * floor["logits"]
    checked = 0
    for (pl, _), (jl, _) in zip(r["port"], r[impl]):
        assert pl.shape == (1, cfg.vocab_size) and np.isfinite(pl).all()
        top2 = np.sort(jl[0])[-2:]
        if top2[1] - top2[0] > 2 * tol:
            assert pl.argmax() == jl.argmax()
            checked += 1
    assert checked >= 1


def test_local_ring_wraps_in_recurrentgemma():
    """21 prompt tokens and 8 steps through a window of 16: the local
    layers' ring holds the last 16 positions only."""
    r = runs("recurrentgemma-9b")
    cache = r["port"][-1][1]
    assert r["cfg"].window == 16
    for i, kind in enumerate(r["cfg"].pattern):
        if kind == "local":
            pos = cache["blocks"][f"pos{i}"]["pos"]
            for row in pos:
                assert sorted(row.tolist()) == list(range(
                    PROMPT + STEPS - 16, PROMPT + STEPS))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_round_trip_through_interop(arch):
    """The port's prefill cache crosses to a JAX-shaped tree and back bit
    for bit, and that tree has the JAX cache's paths, shapes and dtypes."""
    r = runs(arch)
    cfg, model = r["cfg"], r["model"]
    _, cache = decode.prefill(model, torch.from_numpy(r["toks"][:, :PROMPT]),
                              MAX_LEN)
    tree = interop.lm_cache_to_numpy(cache, cfg)
    want = dict(flat(r["ref"][0][1]))
    got = dict(flat(tree))
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert leaf.shape == np.asarray(want[path]).shape, path
        assert leaf.dtype == np.asarray(want[path]).dtype, path
    back = interop.lm_cache_from_numpy(tree, cfg, "cpu")
    assert len(back) == len(cache) == cfg.n_layers
    for mine, theirs in zip(cache, back):
        a, b = dict(flat(mine)), dict(flat(theirs))
        assert set(a) == set(b)
        for key in a:
            assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_empty_cache_matches_jax(arch):
    """Decode from position 0: the port's ``decode.init_cache`` equals
    JAX's carried across, and 4 steps agree within the logit tolerance."""
    r = runs(arch)
    jcfg, cfg, params, model = r["jcfg"], r["cfg"], r["params"], r["model"]
    jc = jax.device_get(jdec.init_cache(jcfg, 1, MAX_LEN))
    pc = decode.init_cache(cfg, 1, MAX_LEN, "cpu")
    carried = interop.lm_cache_from_numpy(jc, cfg, "cpu")
    for mine, theirs in zip(pc, carried):
        a, b = dict(flat(mine)), dict(flat(theirs))
        assert set(a) == set(b)
        for key in a:
            assert torch.equal(a[key], b[key]), key
    tol = 2 * distance(r["port32"], r["port"])["logits"]
    jstep = jax.jit(lambda p, c, t, pos: jdec.decode_step(p, jcfg, c, t, pos))
    toks = r["toks"]
    for i in range(4):
        t = toks[:, i:i + 1]
        jl, jc = jstep(params, jc, jnp.asarray(t), jnp.int32(i))
        pl, pc = decode.decode_step(model, pc, torch.from_numpy(t), i)
        assert np.abs(pl.numpy() - f32(jl)).max() <= tol


@pytest.mark.parametrize("arch, count, kinds", [
    ("mamba2-370m", 367_632_384, ("ssd",) * 48),
    ("recurrentgemma-9b", 8_523_571_200,
     ("rec", "rec", "local") * 12 + ("rec", "rec")),
])
def test_full_config_counts(arch, count, kinds):
    cfg = get_config(arch)
    assert cfg.param_count == count
    assert cfg.layer_kinds == kinds
