"""The port's serving path for the seven architectures beyond gemma2-2b,
mamba2-370m and recurrentgemma-9b, against the JAX package, on the CPU:
gemma3-12b, nemotron-4-15b, command-r-35b (dense), musicgen-large
(audio: four codebooks in, four heads out), llava-next-34b (patch
embeddings before the text), granite-moe-3b-a800m (MoE) and
deepseek-v3-671b (MLA and MoE), each at its smoke config.

Weights come from JAX ``lm.init`` and are carried into the port bit for
bit (``interop.lm_params_from_numpy``); the same numpy prompt and 8
teacher-forced tokens go through JAX ``decode.prefill``/``decode_step``,
under ``impl="ref"`` and ``impl="pallas"`` (interpret mode; MLA's
attention is plain under both, so deepseek runs ``"ref"`` only), and
through the port's plain path.

Tolerances. Caches: slot positions exactly, keys, values and MLA latents
to ``KV_TOL`` = 0.05, as in tests/test_torch_lm.py. Logits: that file's
``LOGIT_TOL`` = 0.21 for gemma3-12b and granite-moe-3b-a800m, and 0.08
for the other five, whose logits stay under 4 here. Measured on these
runs (largest over the prefill and 8 steps, port against JAX ``ref`` /
``pallas``, beside JAX's own two paths): gemma3 0.196 / 0.204 (0.187),
granite 0.145 / 0.184 (0.171), nemotron 0.026 / 0.024 (0.024), command-r
0.024 / 0.025 (0.020), musicgen 0.018 / 0.015 (0.014), llava 0.019 /
0.022 (0.015), deepseek 0.041 (``ref`` only). gemma3 and granite tie an
unsoftcapped head to a standard-normal embedding, so their smoke logits
reach 54, twice gemma2-2b's under its softcap of 30: 0.21 is at their
bf16 noise (on five other prompts JAX's own two paths differed by up to
0.233 on gemma3 and the port by up to 0.268 from JAX).

MoE routing is discrete: a near-tie in a token's top-k can pick another
expert when its input moves by one bf16 ulp, which moves the logits far
more than any tolerance. So the MoE runs record the JAX package's expert
choices (``jax.debug.callback`` around ``repro.models.moe.route``) and
the port replays them (``moe.router_logits`` and ``moe.combine`` at the
recorded indices: the combine weights, queue positions and drops are the
port's own); the share of the port's own choices that agree with JAX's
is asserted beside.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_cfgbase
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import decode as jdec
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import interop
from repro_torch.configs import base as cfgbase
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import decode, lm, moe
from repro_torch.serving.engine import InferenceEngine

NEW_ARCHS = ("gemma3-12b", "nemotron-4-15b", "command-r-35b",
             "musicgen-large", "llava-next-34b", "granite-moe-3b-a800m",
             "deepseek-v3-671b")
LOGIT_TOL = 0.21  # tests/test_torch_lm.py
KV_TOL = 0.05
TOL = {arch: 0.08 for arch in NEW_ARCHS}
TOL.update({"gemma3-12b": LOGIT_TOL, "granite-moe-3b-a800m": LOGIT_TOL})
# the smallest share of (token, slot) expert choices of the port that
# must equal JAX's on the same run (measured: 0.990 granite, 1.0
# deepseek)
ROUTE_AGREE = 0.95
PROMPT = 40    # past gemma3's smoke window of 16: its ring wraps
STEPS = 8
MAX_LEN = 64


def f32(x):
    return np.asarray(x, np.float32)


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


@contextlib.contextmanager
def jax_routes_recorded(record: list):
    """Every ``repro.models.moe.route`` traced inside appends its top-k
    indices (numpy) to ``record`` when the program runs, in call order."""
    orig = jmoe.route

    def route(router_w, xt, cfg):
        out = orig(router_w, xt, cfg)
        jax.debug.callback(lambda idx: record.append(np.asarray(idx)),
                           out[0], ordered=True)
        return out

    jmoe.route = route
    try:
        yield
    finally:
        jmoe.route = orig


@contextlib.contextmanager
def port_routes_replayed(record: list, agree: list):
    """Every ``repro_torch.models.moe.route`` inside takes the next
    indices of ``record`` instead of its own top-k, and appends to
    ``agree`` (matching choices, choices) of its own against them."""
    orig = moe.route
    queue = list(record)

    def route(router_w, xt, cfg):
        own = orig(router_w, xt, cfg)[0]
        idx = torch.from_numpy(queue.pop(0).astype(np.int64))
        assert idx.shape == own.shape
        agree.append((int((own == idx).sum()), idx.numel()))
        logits = moe.router_logits(router_w, xt, cfg)
        return (idx, *moe.combine(logits, idx, cfg))

    moe.route = route
    try:
        yield
    finally:
        moe.route = orig
        assert not queue, f"{len(queue)} recorded routes not replayed"


def carried(arch, seed=0):
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    params = jax.device_get(jlm.init(jax.random.PRNGKey(seed), jcfg))
    model = lm.init(torch.Generator("cpu").manual_seed(seed), cfg)
    model.load_state_dict(interop.lm_params_from_numpy(params, cfg, "cpu"),
                          strict=True, assign=True)
    return jcfg, cfg, params, model


def inputs(cfg, seed=0, n=PROMPT + STEPS):
    """Token ids (1, n) — audio (1, n, K) — and, for a VLM, float32
    patch embeddings (1, P, E), from numpy."""
    rng = np.random.default_rng(seed)
    shape = (1, n, cfg.n_codebooks) if cfg.family == "audio" else (1, n)
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    patches = None
    if cfg.patch_stub is not None:
        patches = rng.standard_normal(
            (1, cfg.patch_stub.n_patches,
             cfg.patch_stub.embed_dim)).astype(np.float32)
    return toks, patches


_RUNS: dict = {}


def runs(arch):
    """Per arch, computed once: the carried model, the inputs and, for
    each JAX path and the port, the logits and cache trees (numpy) of the
    prefill and each decode step; the port's routing agreement."""
    if arch in _RUNS:
        return _RUNS[arch]
    jcfg, cfg, params, model = carried(arch)
    toks, patches = inputs(cfg)
    n_patch = 0 if patches is None else patches.shape[1]
    batch = {"tokens": jnp.asarray(toks[:, :PROMPT])}
    if patches is not None:
        batch["patches"] = jnp.asarray(patches)
    is_moe = cfg.moe is not None
    out = {"jcfg": jcfg, "cfg": cfg, "params": params, "model": model,
           "toks": toks, "patches": patches, "n_patch": n_patch}
    for impl in ("ref",) if cfg.mla is not None else ("ref", "pallas"):
        record: list = []
        ctx = jax_routes_recorded(record) if is_moe else \
            contextlib.nullcontext()
        with ctx:
            pre = jax.jit(lambda p, b, impl=impl: jdec.prefill(
                p, jcfg, b, MAX_LEN, impl=impl))
            step = jax.jit(lambda p, c, t, pos, impl=impl: jdec.decode_step(
                p, jcfg, c, t, pos, impl=impl))
            logits, cache = pre(params, batch)
            seq = [(f32(logits), jax.device_get(cache))]
            for i in range(STEPS):
                t = PROMPT + i
                logits, cache = step(params, cache,
                                     jnp.asarray(toks[:, t:t + 1]),
                                     jnp.int32(n_patch + t))
                seq.append((f32(logits), jax.device_get(cache)))
            jax.effects_barrier()
        agree: list = []
        ctx = port_routes_replayed(record, agree) if is_moe else \
            contextlib.nullcontext()
        with ctx:
            pt = None if patches is None else torch.from_numpy(patches)
            logits, cache = decode.prefill(
                model, torch.from_numpy(toks[:, :PROMPT]), MAX_LEN,
                patches=pt)
            mine = [(logits.numpy(), interop.lm_cache_to_numpy(cache, cfg))]
            for i in range(STEPS):
                t = PROMPT + i
                logits, cache = decode.decode_step(
                    model, cache, torch.from_numpy(toks[:, t:t + 1]),
                    n_patch + t)
                mine.append((logits.numpy(),
                             interop.lm_cache_to_numpy(cache, cfg)))
        out[impl] = seq
        out[f"port_{impl}"] = mine
        out[f"agree_{impl}"] = agree
    _RUNS[arch] = out
    return out


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_carried_bit_for_bit(arch):
    """Every leaf of the JAX tree (the untied heads, the codebook tables,
    ``patch_proj``, the MoE and MLA weights, deepseek's ``mtp``) lands
    under its own path, bit for bit, and the port has no other."""
    jcfg, cfg, params, model = carried(arch)
    state = model.state_dict()
    n_pat, n_pre = len(cfg.pattern), len(cfg.prefix)
    want = {}
    for path, leaf in flat(params):
        leaf = np.asarray(leaf)
        group, rest = path.split(".", 1)
        if group == "blocks":
            pos, rest = rest.split(".", 1)
            i = int(pos[len("pos"):])
            for r in range(cfg.repeats):
                want[f"blocks.{n_pre + r * n_pat + i}.{rest}"] = leaf[r]
        elif group == "prefix":
            j, rest = rest.split(".", 1)
            want[f"blocks.{j}.{rest}"] = leaf
        else:
            want[path] = leaf
    assert set(state) == set(want)
    for key, leaf in want.items():
        got = state[key]
        if leaf.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, key
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          leaf.view(np.int16), err_msg=key)
        else:
            assert got.dtype == torch.float32, key
            np.testing.assert_array_equal(got.numpy(), leaf, err_msg=key)


@pytest.mark.parametrize("arch, impl", [
    (arch, impl) for arch in NEW_ARCHS for impl in ("ref", "pallas")
    if not (arch == "deepseek-v3-671b" and impl == "pallas")])
def test_prefill_and_decode_match_jax(arch, impl):
    """Prefill of the 40-token prompt (after the patches, for llava) and 8
    teacher-forced decode steps: logits within the arch's tolerance at
    every step, caches within ``KV_TOL``, slot positions exact."""
    r = runs(arch)
    cfg = r["cfg"]
    want_shape = ((1, cfg.n_codebooks, cfg.vocab_size)
                  if cfg.family == "audio" else (1, cfg.vocab_size))
    for step, ((pl, pc), (jl, jc)) in enumerate(zip(r[f"port_{impl}"],
                                                     r[impl])):
        assert pl.dtype == np.float32 and pl.shape == want_shape
        err = float(np.abs(pl - jl).max())
        assert err <= TOL[arch], (step - 1, err)
        got = dict(flat(pc))
        assert set(got) == {p for p, _ in flat(jc)}
        for path, leaf in flat(jc):
            g = got[path]
            assert g.shape == np.shape(leaf), path
            if path.endswith(".pos"):
                np.testing.assert_array_equal(g, np.asarray(leaf))
            else:
                assert g.dtype == np.asarray(leaf).dtype, path
                np.testing.assert_allclose(f32(g), f32(leaf), rtol=0,
                                           atol=KV_TOL, err_msg=path)
    if cfg.moe is not None:
        agree = r[f"agree_{impl}"]
        # one route per MoE layer in the prefill and in each step
        n_moe = sum(kind.endswith("moe") for kind in cfg.layer_kinds)
        assert len(agree) == n_moe * (1 + STEPS)
        share = sum(a for a, _ in agree) / sum(n for _, n in agree)
        assert share >= ROUTE_AGREE, share


def test_gemma3_ring_and_llava_positions():
    """gemma3's local ring (window 16) holds the last 16 of 48 positions;
    llava's dense caches hold the 8 patches and the 48 text positions."""
    r = runs("gemma3-12b")
    cache = r["port_ref"][-1][1]
    for i, kind in enumerate(r["cfg"].pattern):
        if kind == "local":
            row = cache["blocks"][f"pos{i}"]["pos"][0]
            assert sorted(row.tolist()) == list(range(48 - 16, 48))
    r = runs("llava-next-34b")
    pos = r["port_ref"][-1][1]["blocks"]["pos0"]["pos"][0]
    assert pos.tolist() == list(range(8 + 48)) + [-1] * (MAX_LEN - 56)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_plus_decode_matches_longer_prefill(arch):
    """Prefill of S+1 tokens gives the logits of prefill of S then one
    decode step (the twin of the JAX package's
    ``test_prefill_plus_decode_matches_forward``, at its tolerance)."""
    _, cfg, _, model = carried(arch)
    toks, patches = inputs(cfg, seed=3, n=33)
    pt = None if patches is None else torch.from_numpy(patches)
    n_patch = 0 if patches is None else patches.shape[1]
    full, _ = decode.prefill(model, torch.from_numpy(toks), MAX_LEN,
                             patches=pt)
    _, cache = decode.prefill(model, torch.from_numpy(toks[:, :32]), MAX_LEN,
                              patches=pt)
    step, _ = decode.decode_step(model, cache,
                                 torch.from_numpy(toks[:, 32:33]),
                                 n_patch + 32)
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=5e-2,
                               atol=5e-2)


def test_registry_holds_every_jax_architecture():
    """All ten architectures, each full config equal to JAX's field for
    field, with the same ``param_count``."""
    names = cfgbase.list_architectures()
    assert names == jax_cfgbase.list_architectures() and len(names) == 10
    for name in names:
        mine, theirs = get_config(name), jax_cfgbase.get_config(name)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs), name
        assert mine.param_count == theirs.param_count, name
        smoke = get_smoke_config(name)
        assert dataclasses.asdict(smoke) == dataclasses.asdict(
            jax_smoke_config(name)), name


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_smoke_model_holds_param_count_weights(arch):
    """The port's smoke model holds ``param_count``'s weights
    (``lm.counted_params``: every weight but norm scales, biases, padded
    vocabulary rows and experts, and deepseek's MTP block)."""
    cfg = get_smoke_config(arch)
    model = lm.init(torch.Generator("cpu").manual_seed(0), cfg)
    assert lm.counted_params(model) == cfg.param_count


def test_untied_head_is_a_view():
    """The untied head is read through a transposed view of ``lm_head.w``
    (D, V): no copy of the table is made for the logits."""
    _, cfg, _, model = carried("nemotron-4-15b")
    table = lm._head_table(model)
    assert table.shape == (cfg.vocab_padded, cfg.d_model)
    assert table.data_ptr() == model.lm_head.w.data_ptr()
    _, cfg, _, model = carried("musicgen-large")
    assert lm._head_table(model).shape == (cfg.n_codebooks, cfg.vocab_size,
                                           cfg.d_model)


def test_logits_widen_the_head_a_block_at_a_time(monkeypatch):
    """``logits_from_hidden`` over blocks of rows equals one product over
    the whole table, bit for bit on the CPU."""
    from repro_torch.models import layers
    g = torch.Generator().manual_seed(0)
    table = torch.randn((1000, 48), generator=g).to(torch.bfloat16)
    h = torch.randn((2, 48), generator=g).to(torch.bfloat16)
    whole = layers.logits_from_hidden(table, h, 30.0)
    monkeypatch.setattr(layers, "LOGIT_CHUNK_ELEMS", 48 * 96)
    blocks = layers.logits_from_hidden(table, h, 30.0)
    assert torch.equal(whole, blocks)


@pytest.mark.parametrize("arch", ["musicgen-large", "llava-next-34b"])
def test_engine_serves_token_prompts_only(arch):
    """The JAX engine feeds (1, S) token prompts, which neither an audio
    model nor a VLM takes; the port's engine refuses them at once."""
    cfg = get_smoke_config(arch)
    model = lm.init(torch.Generator("cpu").manual_seed(0), cfg)
    with pytest.raises(ValueError, match="token"):
        InferenceEngine(cfg, model, device="cpu")


@pytest.mark.parametrize("arch", ["gemma3-12b", "nemotron-4-15b",
                                  "command-r-35b", "granite-moe-3b-a800m",
                                  "deepseek-v3-671b"])
def test_serve_main_serves_token_archs(arch, capsys):
    out = serve.main(["--arch", arch, "--smoke", "--replicas", "2",
                      "--requests", "3", "--max-k", "2", "--device", "cpu"])
    assert out["latency_s"].shape == (3,)
    assert out["stats"]["total"] == 3
    assert "[serve] n=3" in capsys.readouterr().out


def test_engine_tokens_equal_repeated_prefill():
    """The engine's greedy tokens on granite (MoE; decode runs with one
    slot per expert) equal the argmax of prefill over the growing
    prompt."""
    cfg = get_smoke_config("granite-moe-3b-a800m")
    model = lm.init(torch.Generator("cpu").manual_seed(1), cfg)
    eng = InferenceEngine(cfg, model, max_len=64, device="cpu")
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, 12)
    out = eng.generate(prompt, max_new_tokens=4)
    cur = list(prompt)
    for tok in out:
        logits, _ = decode.prefill(model, torch.tensor([cur]), 64)
        assert int(logits.argmax(-1)[0]) == int(tok)
        cur.append(int(tok))


def test_chip_smoke_phase16_runs_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s phase 16 (``zoo_models``, ``lm_full``, the MoE
    route replay) end to end at the smoke configs on the CPU, with the
    kernels' plain versions standing in for the kernels and the card's
    clock and memory calls stubbed: every model passes its gates, and the
    replayed runs of the MoE models route as the plain run did."""
    import importlib.util
    import os

    from repro_torch.kernels import dispatch
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_rehearsal",
                                                  path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cut = cs.zoo_config("deepseek-v3-671b")  # the full width, depth 3
    assert cut.layer_kinds == ("mla", "mla_moe", "mla_moe")
    assert cut.param_count == 25_451_364_352
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(dispatch, "resolve", lambda kernel, device: "off")

    def smoke(arch):
        cfg = get_smoke_config(arch)
        if arch == "deepseek-v3-671b":  # the phase's depth cut
            cfg = dataclasses.replace(cfg, n_layers=3, prefix=("mla",),
                                      moe=dataclasses.replace(
                                          cfg.moe, first_dense=1))
        return cfg

    monkeypatch.setattr(cs, "zoo_config", smoke)
    monkeypatch.setattr(cs, "ZOO_RUNS", tuple(
        (arch, 16 if arch == "llava-next-34b" else 24)
        for arch, _ in cs.ZOO_RUNS))
    out = cs.zoo_models(torch.device("cpu"), None)
    assert set(out["model_launches"]) == set(NEW_ARCHS)
    text = capsys.readouterr().out
    assert text.count("engine greedy tokens") == 5  # the token-prompt archs
    assert '"checked": 1.0' in text  # replayed routes equal the recorded
