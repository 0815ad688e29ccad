"""Sharded serving (``repro_torch.models.decode`` under a ``ShardCtx``) on
the CPU: spawned gloo worlds against the port unsharded and the JAX
package's own sharded serving.

Every config runs B = 2 rows of a 32-token prompt into a cache of 64
slots, then 3 teacher-forced decode steps, on the JAX package's weights
(``lm.init(PRNGKey(0))``) carried into the port; MoE models with the
capacity raised (no token dropped) and the JAX run's expert choices
replayed in the port's runs (by call and row: a near-tie a bf16 ulp flips
would move the logits past any tolerance).

World A, 4 ranks on a (data 2, model 2) mesh (``make_test_mesh``), under
the layouts of ``sharding.make_layout``:
  1. all ten smoke configs: the prefill layout (the sequence over
     ``model`` for the fsdp recipe — gemma2-2b, granite-moe-3b-a800m,
     llava-next-34b, whose patches and text split together — the batch
     over ``data`` for tp), weights under the training rules gathered at
     their use; then the decode layout (KV slots over ``model``) on the
     prefill model's shards moved to the inference rules' blocks
     (``ShardedModel.reshard``), read in place;
  2. five configs widened (the same overrides on both sides, ``WIDE``) so
     that the inference rules split weights of every kind: a contracted
     split, an output split, the vocabulary (lookup and head) and the
     experts (``test_inference_splits_happen`` counts each in the decode);
  3. a B = 1 decode with the KV slots over (data, model) on the cache of
     an unsharded prefill (JAX's own sharded prefill of deepseek refuses
     B = 1): a prompt of 8 in 64 slots, 16 a rank, so three of the four
     ranks start with no live dense slot;
  4. the cache a sharded prefill returns (its block under the decode
     layout) feeds the sharded decode, beside the run that starts from
     the unsharded prefill's cache.
World B, 8 ranks on (pod 2, data 2, model 2): the widened gemma2-2b under
the two-pod layouts (prefill's sequence over (pod, model), a B = 1 decode
over (pod, data, model)) against the port unsharded (case 5).

The gates (``PREFILL_MULT``, ``DECODE_MULT``), each distance measured live
in this run: the sharded prefill's logits and gathered cache within the
larger of twice the JAX package's own sharded-vs-unsharded distance on the
same values and 1e-5 of the largest value; each decode step's logits within
twice the larger of JAX's sharded-vs-unsharded distance and the port
unsharded's distance from JAX unsharded (the spread of the reference's
own sharded decode, 0.04-0.17 of logits up to 60, is the yardstick, not an
exact match). JAX runs in two subprocesses with 4 host devices on an
``Auto`` mesh (``JAX_SCRIPT``): the unsharded runs (the weights, the
caches and the expert choices the worlds take) and the sharded ones. The
file imports no JAX.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import collectives, multihost, sharding, tp
from repro_torch.distributed.ctx import batch_axes
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import decode, lm, moe

SRC = Path(__file__).resolve().parent.parent / "src"
ARCHS = ("gemma2-2b", "gemma3-12b", "nemotron-4-15b", "command-r-35b",
         "musicgen-large", "llava-next-34b", "granite-moe-3b-a800m",
         "deepseek-v3-671b", "mamba2-370m", "recurrentgemma-9b")
# widths past the inference rules' threshold (a weight of 65,536 elements
# or more is split), the same on both sides
WIDE = {
    "gemma2-2b": dict(d_model=256, n_heads=4, head_dim=64, d_ff=1024),
    "granite-moe-3b-a800m": dict(d_model=256, n_heads=4, head_dim=64,
                                 moe=dict(d_expert=1024)),
    "deepseek-v3-671b": dict(d_model=256, d_ff=1024,
                             moe=dict(d_expert=256, d_shared=1024)),
    "mamba2-370m": dict(d_model=256),
    "recurrentgemma-9b": dict(d_model=256, d_ff=1024,
                              rglru=dict(lru_width=1024)),
}
B, PROMPT, MAX_LEN, STEPS = 2, 32, 64, 3
B1_PROMPT = 8
B1 = (("gemma2-2b", False), ("deepseek-v3-671b", False),
      ("mamba2-370m", False), ("gemma2-2b", True))
PREFILL_MULT = DECODE_MULT = 2.0
PREFILL_REL = 1e-5
WORLD_LIMIT_S = 300.0


@dataclasses.dataclass(frozen=True)
class Case:
    key: str
    arch: str
    wide: bool
    batch: int
    prompt: int


CASES = ([Case(a, a, False, B, PROMPT) for a in ARCHS]
         + [Case(f"{a}+wide", a, True, B, PROMPT) for a in WIDE]
         + [Case(f"{a}{'+wide' if w else ''}+b1", a, w, 1, B1_PROMPT)
            for a, w in B1])
BY_KEY = {c.key: c for c in CASES}
TWO_POD = BY_KEY["gemma2-2b+wide"]
TWO_POD_B1 = BY_KEY["gemma2-2b+wide+b1"]


def overrides(case: Case) -> dict:
    """The config's overrides: the widths of ``WIDE`` and, for MoE, the
    capacity raised so that no token is dropped."""
    over = dict(WIDE[case.arch]) if case.wide else {}
    m = get_smoke_config(case.arch).moe
    if m is not None:
        over["moe"] = dict(over.get("moe", {}),
                           capacity_factor=m.n_experts / m.top_k)
    return over


def config(case: Case):
    cfg = get_smoke_config(case.arch)
    kw = {k: dataclasses.replace(getattr(cfg, k), **v)
          if isinstance(v, dict) else v for k, v in overrides(case).items()}
    return dataclasses.replace(cfg, **kw)


def inputs(cfg, case: Case):
    """Tokens (batch, prompt + STEPS[, K]) and a VLM's patches."""
    rng = np.random.default_rng(1)
    shape = (case.batch, case.prompt + STEPS) + (
        (cfg.n_codebooks,) if cfg.family == "audio" else ())
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    patches = None
    if cfg.patch_stub is not None:
        patches = rng.standard_normal(
            (case.batch, cfg.patch_stub.n_patches,
             cfg.patch_stub.embed_dim)).astype(np.float32)
    return toks, patches


def n_patches(cfg) -> int:
    return cfg.patch_stub.n_patches if cfg.patch_stub is not None else 0


def n_moe(cfg) -> int:
    return sum(lm._mixer_mlp(k)[1] == "moe" for k in cfg.layer_kinds)


# ---------------------------------------------------------------------------
# The JAX side (subprocesses)
# ---------------------------------------------------------------------------

JAX_SCRIPT = r"""
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType

from repro.configs import get_smoke_config
from repro.distributed import sharding
from repro.models import decode as dec
from repro.models import lm, moe

mode, in_path, out_path = sys.argv[1:4]
spec = pickle.load(open(in_path, "rb"))
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
routes = []
if mode == "one":
    orig = moe.route

    def route(router_w, xt, cfg):
        out = orig(router_w, xt, cfg)
        jax.debug.callback(lambda idx: routes.append(np.asarray(idx)),
                           out[0], ordered=True)
        return out

    moe.route = route
out = {}
for c in spec["cases"]:
    cfg = get_smoke_config(c["arch"])
    cfg = dataclasses.replace(cfg, **{
        k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
        else v for k, v in c["over"].items()})
    params = lm.init(jax.random.PRNGKey(0), cfg)
    toks, b, prompt = c["tokens"], c["batch"], c["prompt"]
    batch = {"tokens": jnp.asarray(toks[:, :prompt])}
    if c["patches"] is not None:
        batch["patches"] = jnp.asarray(c["patches"])
    n_p = cfg.patch_stub.n_patches if cfg.patch_stub else 0
    max_len, steps = spec["max_len"], spec["steps"]
    rec = {}
    if mode == "one" or b == 1:
        routes.clear()
        logits, cache = jax.jit(lambda p, bt: dec.prefill(
            p, cfg, bt, max_len))(params, batch)
    else:
        pl = sharding.make_layout(cfg, "prefill", False, b)
        pctx = sharding.make_ctx(cfg, mesh, pl)
        p_sh = sharding.param_shardings(cfg, mesh, params, inference=False,
                                        ep_axes=pl.ep_axes)
        b_sh = sharding.batch_shardings(cfg, mesh, pl, batch)
        logits, cache = jax.jit(lambda p, bt: dec.prefill(
            p, cfg, bt, max_len, ctx=pctx))(jax.device_put(params, p_sh),
                                            jax.device_put(batch, b_sh))
    rec["cache"] = jax.device_get(cache)
    outs = [logits]
    if mode == "one":
        step = jax.jit(lambda p, cc, t, pos: dec.decode_step(p, cfg, cc, t,
                                                             pos))
        p_in = params
    else:
        dl = sharding.make_layout(cfg, "decode", False, b)
        dctx = sharding.make_ctx(cfg, mesh, dl)
        p_in = jax.device_put(params, sharding.param_shardings(
            cfg, mesh, params, inference=True, ep_axes=dl.ep_axes))
        c_sh = sharding.cache_shardings(cfg, mesh, dl, cache)
        cache = jax.device_put(cache, c_sh)
        step = jax.jit(lambda p, cc, t, pos: dec.decode_step(
            p, cfg, cc, t, pos, ctx=dctx), out_shardings=(None, c_sh))
    for i in range(steps):
        logits, cache = step(p_in, cache,
                             jnp.asarray(toks[:, prompt + i:prompt + i + 1]),
                             jnp.int32(n_p + prompt + i))
        outs.append(logits)
    jax.effects_barrier()
    rec["logits"] = [np.asarray(x, np.float32) for x in outs]
    if mode == "one":
        rec["params"] = jax.device_get(params)
        rec["routes"] = list(routes)
    out[c["key"]] = rec
with open(out_path, "wb") as f:
    pickle.dump(out, f)
print("JAX_DONE")
"""


def jax_spec() -> dict:
    cases = []
    for c in CASES:
        cfg = config(c)
        toks, patches = inputs(cfg, c)
        cases.append(dict(key=c.key, arch=c.arch, over=overrides(c),
                          batch=c.batch, prompt=c.prompt, tokens=toks,
                          patches=patches))
    return {"cases": cases, "max_len": MAX_LEN, "steps": STEPS}


def start_jax(mode: str, tmp: Path) -> tuple[subprocess.Popen, Path]:
    out = tmp / f"jax_{mode}.pkl"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, mode,
                             str(tmp / "spec.pkl"), str(out)], env=env,
                            text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    return proc, out


def finish_jax(proc: subprocess.Popen, out: Path) -> dict:
    try:
        _, stderr = proc.communicate(timeout=WORLD_LIMIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# The port's runs
# ---------------------------------------------------------------------------


def replayed(queue: list):
    """``moe.route`` takes the next choice of ``queue`` (by call), its
    weights from this run's router logits."""
    import contextlib

    @contextlib.contextmanager
    def cm():
        orig, q = moe.route, list(queue)

        def route(router_w, xt, cfg):
            idx = torch.from_numpy(np.asarray(q.pop(0)).astype(np.int64))
            if idx.shape[0] != xt.shape[0]:
                raise AssertionError(f"a replayed choice of {idx.shape[0]} "
                                     f"tokens for {xt.shape[0]}")
            logits = moe.router_logits(router_w, xt, cfg)
            return (idx, *moe.combine(logits, idx, cfg))

        moe.route = route
        try:
            yield
        finally:
            moe.route = orig

    return cm()


def rows_queue(records: list, rows: torch.Tensor, batch: int) -> list:
    """Each recorded choice (batch x S tokens) cut to ``rows``."""
    return [r.reshape(batch, -1, r.shape[-1])[rows.numpy()].reshape(
        -1, r.shape[-1]) for r in records]


def carried(cfg, params: dict) -> lm.LM:
    model = lm.init(lm.layers.MetaGenerator(), cfg)
    model.load_state_dict(params, strict=True, assign=True)
    return model


def run_one(cfg, case: Case, params: dict, routes: list):
    """The port unsharded on JAX's weights and choices: (logits of the
    prefill and each step, float32; the prefill's cache)."""
    model = carried(cfg, params)
    toks, patches = (torch.from_numpy(x) if x is not None else None
                     for x in inputs(cfg, case))
    k = n_moe(cfg)
    with replayed(routes[:k]):
        logits, cache = decode.prefill(model, toks[:, :case.prompt], MAX_LEN,
                                       patches=patches)
    prefill_cache = interop.lm_cache_to_numpy(cache, cfg)
    out = [logits]
    with replayed(routes[k:]):
        for i in range(STEPS):
            logits, cache = decode.decode_step(
                model, cache, toks[:, case.prompt + i:case.prompt + i + 1],
                n_patches(cfg) + case.prompt + i)
            out.append(logits)
    return [x.float() for x in out], prefill_cache


# ---------------------------------------------------------------------------
# The worlds
# ---------------------------------------------------------------------------


class Kinds:
    """Counts, during a decode, the products of ``tp`` by kind: a
    contracted split, a split kept in the output, the vocabulary lookup
    and head."""

    def __init__(self):
        self.n = {"contracted": 0, "kept": 0, "vocab_lookup": 0,
                  "vocab_head": 0}

    def __enter__(self):
        self.saved = (tp.einsum, tp.rows, tp.logits)
        einsum, rows, logits = self.saved

        def counted_einsum(eq, x, w):
            out = eq.split("->")[1]
            c = eq.split("->")[0].split(",")[1][w.dim]
            self.n["kept" if c in out else "contracted"] += 1
            return einsum(eq, x, w)

        def counted_rows(table, ids):
            self.n["vocab_lookup"] += 1
            return rows(table, ids)

        def counted_logits(table, h, cap):
            self.n["vocab_head"] += 1
            return logits(table, h, cap)

        tp.einsum, tp.rows, tp.logits = (counted_einsum, counted_rows,
                                         counted_logits)
        return self

    def __exit__(self, *exc):
        tp.einsum, tp.rows, tp.logits = self.saved


def whole_like(cfg, batch: int) -> list[dict]:
    """The whole cache's shapes on the meta device (for ``cache_specs``)."""
    return decode.init_cache(cfg, batch, MAX_LEN, torch.device("meta"))


def serve(mesh, case: Case, one: dict, multi_pod: bool = False) -> dict:
    """One case on this rank: the sharded prefill (B > 1) and decode runs
    from each starting cache; every logit and cache gathered whole. Two
    pods' decode layout splits a batch of 2 nowhere (its batch axes are 4
    ranks), so there B = 2 runs the prefill alone."""
    cfg = config(case)
    params = interop.lm_params_from_numpy(one["params"], cfg, "cpu")
    toks, patches = (torch.from_numpy(x) if x is not None else None
                     for x in inputs(cfg, case))
    routes, k = one["routes"], n_moe(cfg)
    b = case.batch
    dl = sharding.make_layout(cfg, "decode", multi_pod, b)
    dctx = sharding.make_ctx(cfg, mesh, dl)
    dspecs = sharding.cache_specs(cfg, mesh, dl, whole_like(cfg, b))
    res: dict = {"layouts": {"decode": dataclasses.asdict(dl)}}
    every = torch.arange(b)
    with replayed(routes[:k]):
        _, whole = decode.prefill(carried(cfg, params), toks[:, :case.prompt],
                                  MAX_LEN, patches=patches)
    res["unsharded cache"] = interop.lm_cache_to_numpy(whole, cfg)
    starts = {"unsharded": sharding.cache_blocks(whole, dspecs, mesh)}
    if b > 1:
        pl = sharding.make_layout(cfg, "prefill", multi_pod, b)
        pctx = sharding.make_ctx(cfg, mesh, pl)
        assert not set(pl.ep_axes) & set(pl.batch or ())
        sm = sharding.ShardedModel.from_full(cfg, pctx, params, "cpu")
        batch = {"tokens": toks[:, :case.prompt]}
        if patches is not None:
            batch["patches"] = patches
        rows = sharding.batch_rows(batch, pctx)
        mine = sharding.batch_rows({"r": every}, pctx)["r"]
        with replayed(rows_queue(routes[:k], mine, b)):
            logits, blocks = decode.prefill(sm, rows["tokens"], MAX_LEN,
                                            patches=rows.get("patches"),
                                            ctx=pctx)
        res["layouts"]["prefill"] = dataclasses.asdict(pl)
        res["prefill"] = collectives.all_gather(logits, mesh,
                                                batch_axes(pctx), 0)
        res["cache"] = interop.lm_cache_to_numpy(
            sharding.gather_cache(blocks, dspecs, mesh), cfg)
        starts["sharded"] = blocks
        if multi_pod:
            return res
        dsm = sm.reshard(dctx, inference=True)
    else:
        dsm = sharding.ShardedModel.from_full(
            cfg, dctx, params, "cpu", sharding.port_param_specs(
                lm.init(lm.layers.MetaGenerator(), cfg), cfg, inference=True,
                ep_axes=dl.ep_axes), in_place=True)
    mine = sharding.batch_rows({"r": every}, dctx)["r"]
    drows = sharding.batch_rows({"t": toks}, dctx)["t"]
    assert not set(dl.ep_axes) & set(dl.batch or ())
    for name, cache in starts.items():
        out = []
        bytes0 = dict(collectives.BYTES)
        calls0 = dict(collectives.CALLS)
        with replayed(rows_queue(routes[k:], mine, b)), Kinds() as kinds:
            for i in range(STEPS):
                logits, cache = decode.decode_step(
                    dsm, cache, drows[:, case.prompt + i:case.prompt + i + 1],
                    n_patches(cfg) + case.prompt + i, ctx=dctx)
                out.append(collectives.all_gather(logits, mesh,
                                                  batch_axes(dctx), 0))
        res[f"decode from {name}"] = out
        res["kinds"] = kinds.n
        res["decode calls"] = {op: (collectives.CALLS[op] - calls0.get(op, 0))
                               / STEPS for op in collectives.CALLS}
        res["decode bytes"] = sum(collectives.BYTES.values()) \
            - sum(bytes0.values())
    res["gathered_at_use"] = sorted(dsm.gathered_at_use)
    res["expert_split"] = [n for n, s in dsm.specs.items()
                           if n.endswith("w_up") and sharding.spec_axes(s)]
    return res


def _units(mesh) -> dict:
    """``tp``'s products of a block against the whole weight: each split
    kind (a contracted dim, a kept output dim, a shared dim, the
    vocabulary lookup and head)."""
    gen = torch.Generator().manual_seed(7)
    out = {}
    x = torch.randn(3, 8, generator=gen)
    for name, eq, wshape, xs in (
            ("linear, contracted", "ti,io->to", (8, 6), x),
            ("linear, output", "ti,io->to", (8, 6), x),
            ("heads, output", "bshd,hdm->bsm", (4, 2, 6),
             torch.randn(2, 3, 4, 2, generator=gen)),
            ("block-diagonal, contracted", "tnb,nbc->tnc", (2, 4, 6),
             torch.randn(3, 2, 4, generator=gen)),
            ("block-diagonal, shared", "tnb,nbc->tnc", (2, 4, 6),
             torch.randn(3, 2, 4, generator=gen))):
        w = torch.randn(*wshape, generator=gen)
        dim = {"linear, contracted": 0, "linear, output": 1,
               "heads, output": 2, "block-diagonal, contracted": 1,
               "block-diagonal, shared": 0}[name]
        spec = tuple(("model",) if d == dim else None
                     for d in range(w.dim()))
        split = tp.Split(sharding.local_shard(w, spec, mesh), dim,
                         ("model",), mesh, w.shape)
        out[name] = (tp.einsum(eq, xs, split), torch.einsum(eq, xs, w))
    table = torch.randn(16, 8, generator=gen)
    ids = torch.tensor([[0, 7, 8, 15], [3, 3, 12, 9]])
    h = torch.randn(2, 8, generator=gen)
    for dim in (0, 1):
        spec = tuple(("data", "model") if d == dim else None
                     for d in range(2))
        split = tp.Split(sharding.local_shard(table, spec, mesh), dim,
                         ("data", "model"), mesh, table.shape)
        out[f"lookup, dim {dim}"] = (tp.rows(split, ids), table[ids])
        out[f"head, dim {dim}"] = (tp.logits(split, h, 3.0),
                                   lm.layers.logits_from_hidden(table, h,
                                                                3.0))
    return out


def _world_a(rank: int, store: str, one_path: str, out_dir: str) -> None:
    from repro_torch.launch.mesh import make_test_mesh

    torch.set_num_threads(1)   # the ranks share the host with other tests
    multihost.initialize(f"file://{store}", 4, rank, device="cpu",
                         set_default_mesh=False, timeout_s=120.0)
    try:
        with open(one_path, "rb") as f:
            one = pickle.load(f)
        mesh = make_test_mesh(2, 2)
        out = {"units": _units(mesh)}
        for case in CASES:
            out[case.key] = serve(mesh, case, one[case.key])
        torch.save(out, f"{out_dir}/a{rank}.pt")
    finally:
        multihost.shutdown()


def _world_b(rank: int, store: str, one_path: str, out_dir: str) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", 8, rank, device="cpu",
                         set_default_mesh=False, timeout_s=120.0)
    try:
        with open(one_path, "rb") as f:
            one = pickle.load(f)
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                          mesh_dim_names=("pod", "data", "model"))
        out = {c.key: serve(mesh, c, one[c.key], multi_pod=True)
               for c in (TWO_POD, TWO_POD_B1)}
        torch.save(out, f"{out_dir}/b{rank}.pt")
    finally:
        multihost.shutdown()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's unsharded and sharded runs (two subprocesses), the port's
    unsharded runs, and worlds A and B (spawned once each)."""
    import time

    tmp = tmp_path_factory.mktemp("sharded_serving")
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(jax_spec(), f)
    t0 = time.monotonic()
    sharded_proc, sharded_out = start_jax("sharded", tmp)
    one_proc, one_out = start_jax("one", tmp)
    try:
        one = finish_jax(one_proc, one_out)
        t_jax = time.monotonic() - t0
        secs_a = multihost.spawn(_world_a, 4, (str(tmp / "store_a"),
                                               str(one_out), str(tmp)),
                                 WORLD_LIMIT_S)
        secs_b = multihost.spawn(_world_b, 8, (str(tmp / "store_b"),
                                               str(one_out), str(tmp)),
                                 WORLD_LIMIT_S)
        port = {}
        for c in CASES:
            cfg = config(c)
            params = interop.lm_params_from_numpy(one[c.key]["params"], cfg,
                                                  "cpu")
            port[c.key] = run_one(cfg, c, params, one[c.key]["routes"])
        sharded = finish_jax(sharded_proc, sharded_out)
    finally:
        for p in (one_proc, sharded_proc):
            if p.poll() is None:
                p.kill()
    print(f"\nJAX unsharded {t_jax:.1f}s, world A {secs_a:.1f}s, world B "
          f"{secs_b:.1f}s, all {time.monotonic() - t0:.1f}s")
    return {"one": one, "sharded": sharded, "port": port,
            "a": [torch.load(tmp / f"a{r}.pt", weights_only=False)
                  for r in range(4)],
            "b": [torch.load(tmp / f"b{r}.pt", weights_only=False)
                  for r in range(8)]}


# ---------------------------------------------------------------------------
# Measures
# ---------------------------------------------------------------------------


def dist(a, b) -> float:
    return float((torch.as_tensor(np.asarray(a, np.float32))
                  - torch.as_tensor(np.asarray(b, np.float32))).abs().max())


def cache_leaves(tree) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in interop._flat(tree)}


def prefill_gate(runs, key: str, got, got_cache, yardstick: str = None):
    """The prefill's logits and cache against the port unsharded, within
    the larger of PREFILL_MULT x JAX's sharded-vs-unsharded distance on
    the same values (``yardstick``'s case) and PREFILL_REL of the largest
    value. Returns the lines printed."""
    y = yardstick or key
    one, sharded = runs["one"][y], runs["sharded"][y]
    want, want_cache = runs["port"][key]
    jax_d = dist(sharded["logits"][0], one["logits"][0])
    scale = float(want[0].abs().max())
    bound = max(PREFILL_MULT * jax_d, PREFILL_REL * scale)
    d = dist(got, want[0])
    lines = [f"{key} prefill logits: |sharded - unsharded| {d}, JAX's own "
             f"{jax_d}, bound {bound} (largest |logit| {scale})"]
    assert d <= bound, lines
    jc, oc = cache_leaves(sharded["cache"]), cache_leaves(one["cache"])
    for leaf, w in cache_leaves(want_cache).items():
        jd = dist(jc[leaf], oc[leaf]) if y == key else 0.0
        bound = max(PREFILL_MULT * jd, PREFILL_REL * float(np.abs(w).max()))
        d = dist(cache_leaves(got_cache)[leaf], w)
        lines.append(f"  cache {leaf}: {d} (JAX's own {jd}, bound {bound})")
        assert d <= bound, lines
    return lines


def decode_gate(runs, key: str, got: list, yardstick: str = None):
    """Each decode step's logits against JAX unsharded within DECODE_MULT
    x the larger of JAX's sharded-vs-unsharded distance and the port
    unsharded's distance from JAX unsharded (``yardstick``'s case for the
    first). Returns (per-step lines, the worst share of the bound)."""
    y = yardstick or key
    one, sharded = runs["one"][key], runs["sharded"][y]
    want, _ = runs["port"][key]
    lines, worst = [], 0.0
    for i in range(STEPS):
        jax_spread = dist(sharded["logits"][i + 1],
                          runs["one"][y]["logits"][i + 1])
        port_one = dist(want[i + 1], one["logits"][i + 1])
        d = dist(got[i], one["logits"][i + 1])
        bound = DECODE_MULT * max(jax_spread, port_one)
        vs_sharded = (dist(got[i], sharded["logits"][i + 1]) if y == key
                      else None)
        worst = max(worst, d / bound)
        lines.append(f"{key} step {i}: port sharded vs JAX unsharded {d}; "
                     f"JAX sharded vs unsharded {jax_spread}; port "
                     f"unsharded vs JAX unsharded {port_one}; bound {bound}; "
                     f"port sharded vs JAX sharded {vs_sharded}")
    return lines, worst


# ---------------------------------------------------------------------------
# Cases 1-4 (world A)
# ---------------------------------------------------------------------------

B2 = [c.key for c in CASES if c.batch > 1]


@pytest.mark.parametrize("key", B2)
def test_sharded_prefill_matches_unsharded(runs, key):
    r = runs["a"][0][key]
    lines = prefill_gate(runs, key, r["prefill"], r["cache"])
    print("\n" + "\n".join(lines))
    for other in runs["a"][1:]:      # every rank has the last position
        assert torch.equal(other[key]["prefill"], r["prefill"])


@pytest.mark.parametrize("key", [c.key for c in CASES])
def test_sharded_decode_matches_jax(runs, key):
    r = runs["a"][0][key]
    start = "sharded" if BY_KEY[key].batch > 1 else "unsharded"
    lines, worst = decode_gate(runs, key, r[f"decode from {start}"])
    print("\n" + "\n".join(lines) + f"\n  worst {worst} of the bound; "
          f"collectives a step (rank 0) {r['decode calls']}")
    assert worst <= 1.0, lines
    assert r["gathered_at_use"] == []


@pytest.mark.parametrize("key", B2)
def test_prefill_cache_continues_into_decode(runs, key):
    """Case 4: the sharded decode from the blocks the sharded prefill
    returned, against the sharded decode from the blocks of the port's
    unsharded prefill cache: bit for bit where the two caches are (the
    prefill test holds them), else under the decode gate."""
    r = runs["a"][0][key]
    same_cache = all(np.array_equal(a, b) for a, b in zip(
        cache_leaves(r["cache"]).values(),
        cache_leaves(r["unsharded cache"]).values()))
    got, want = r["decode from sharded"], r["decode from unsharded"]
    d = max(dist(a, b) for a, b in zip(got, want))
    lines, worst = decode_gate(runs, key, want)
    print(f"\n{key}: caches bit-equal {same_cache}; decode from the sharded "
          f"prefill's blocks vs from the unsharded prefill's: {d}; the "
          f"latter at {worst} of the decode bound")
    assert worst <= 1.0, lines
    if same_cache:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        assert decode_gate(runs, key, got)[1] <= 1.0


def test_layouts_under_test(runs):
    """The fsdp archs' prefill splits the sequence over model, the tp
    archs' the batch; every B = 2 decode splits the KV slots over model,
    every B = 1 over (data, model)."""
    r = runs["a"][0]
    for c in CASES:
        lay = r[c.key]["layouts"]
        fsdp = config(c).recipe == "fsdp"
        if c.batch > 1:
            assert tuple(lay["prefill"]["seq"] or ()) == (
                ("model",) if fsdp else ()), c.key
            assert tuple(lay["decode"]["kv_seq"]) == ("model",), c.key
        else:
            assert tuple(lay["decode"]["kv_seq"]) == ("data", "model")


def test_inference_splits_happen(runs):
    """At smoke width only the vocabulary is split (a weight under 65,536
    elements stays whole); widened, the decode reads contracted and kept
    splits in place, and the experts are split."""
    r = runs["a"][0]
    for arch in ARCHS:
        kinds = r[arch]["kinds"]
        assert kinds["vocab_lookup"] > 0 and kinds["vocab_head"] > 0, arch
    seen = {k: 0 for k in r["gemma2-2b"]["kinds"]}
    for arch in WIDE:
        kinds = r[f"{arch}+wide"]["kinds"]
        print(f"\n{arch} widened, products of one rank's decode by kind: "
              f"{kinds}")
        assert kinds["contracted"] > 0, arch
        for k, n in kinds.items():
            seen[k] += n
    assert all(n > 0 for n in seen.values()), seen
    for arch in ("granite-moe-3b-a800m", "deepseek-v3-671b"):
        assert r[f"{arch}+wide"]["expert_split"], arch


def test_tp_products_equal_whole(runs):
    """Case 6: each split kind of ``tp`` against the whole product."""
    for r in runs["a"]:
        for name, (got, want) in r["units"].items():
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                       msg=name)


# ---------------------------------------------------------------------------
# Case 5 (world B): two pods
# ---------------------------------------------------------------------------


def test_two_pod_layouts_match_unsharded(runs):
    """The widened gemma2-2b on (pod 2, data 2, model 2): the prefill's
    sequence over (pod, model), a B = 1 decode over (pod, data, model),
    held against the port unsharded by case 1's gates (the JAX distances
    of the same configs on the one-pod mesh)."""
    r = runs["b"][0]
    pre = r[TWO_POD.key]
    assert tuple(pre["layouts"]["prefill"]["seq"]) == ("pod", "model")
    lines = prefill_gate(runs, TWO_POD.key, pre["prefill"], pre["cache"])
    dec = r[TWO_POD_B1.key]
    assert tuple(dec["layouts"]["decode"]["kv_seq"]) == ("pod", "data",
                                                         "model")
    more, worst = decode_gate(runs, TWO_POD_B1.key,
                              dec["decode from unsharded"])
    print("\n" + "\n".join(lines + more) + f"\n  worst {worst}")
    assert worst <= 1.0, more
    for other in runs["b"][1:]:
        assert torch.equal(other[TWO_POD.key]["prefill"], pre["prefill"])


# ---------------------------------------------------------------------------
# Case 6: the plain versions (no world)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 7])
def test_flash_ref_q_offset_is_rows_of_the_whole(dtype, window):
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 40, n, 16, generator=gen).to(dtype)
               for n in (4, 2, 2))
    whole = flash_attention_ref(q, k, v, window=window, softcap=5.0)
    for off, n in ((0, 40), (13, 27), (16, 8), (39, 1)):
        part = flash_attention_ref(q[:, off:off + n], k[:, :off + n],
                                   v[:, :off + n], window=window,
                                   softcap=5.0, q_offset=off)
        assert torch.equal(part, whole[:, off:off + n]), (off, n)
    with pytest.raises(ValueError, match="causal prefix"):
        flash_attention_ref(q[:, 10:20], k, v, q_offset=10)


@pytest.mark.parametrize("n_slices", [1, 2, 3, 4])
@pytest.mark.parametrize("ring", [False, True])
def test_decode_ref_lse_combines_to_the_whole(n_slices, ring):
    """Slices of the cache, each with its own float32 output and
    log-sum-exp, combined by ``tp.combine`` equal the whole call (float32,
    rtol 1e-6), slices with no live slot included."""
    gen = torch.Generator().manual_seed(n_slices)
    length, pos, window = 48, 20, (16 if ring else None)
    q = torch.randn(2, 1, 4, 16, generator=gen)
    k, v = (torch.randn(2, length, 2, 16, generator=gen) for _ in range(2))
    s = torch.arange(length, dtype=torch.int32)
    slots = torch.where(s <= pos, s, -1)       # slots past pos are empty
    whole = decode_attention_ref(q, k, v, slots, pos, window=window,
                                 softcap=30.0)
    bounds = np.linspace(0, length, n_slices + 1).astype(int)
    outs, lses = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        o, lse = decode_attention_ref(q, k[:, lo:hi], v[:, lo:hi],
                                      slots[lo:hi], pos, window=window,
                                      softcap=30.0, return_lse=True)
        if not bool(((slots[lo:hi] >= 0) & (slots[lo:hi] <= pos)).any()):
            assert torch.isneginf(lse).all() and not o.any()
        outs.append(o)
        lses.append(lse)
    if n_slices > 2:
        assert any(torch.isneginf(x).all() for x in lses)
    got = tp.combine(torch.stack(outs), torch.stack(lses), torch.float32)
    torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-7)
    one, lse = decode_attention_ref(q, k, v, slots, pos, window=window,
                                    softcap=30.0, return_lse=True)
    torch.testing.assert_close(one, whole, rtol=1e-6, atol=1e-7)
    assert torch.isfinite(lse).all()


def test_decode_ref_lse_of_an_empty_cache():
    q = torch.randn(1, 1, 2, 16)
    k = v = torch.randn(1, 8, 1, 16, dtype=torch.bfloat16)
    out, lse = decode_attention_ref(q.bfloat16(), k, v,
                                    torch.full((8,), -1, dtype=torch.int32),
                                    3, return_lse=True)
    assert out.dtype == torch.float32 and not out.any()
    assert torch.isneginf(lse).all()


def test_chip_smoke_phase19_runs_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s phase 19 (``sharded_serving``: the unsharded
    references, four spawned ranks, every gate) end to end on the CPU at
    gemma2-2b's smoke config and small shapes, the kernels' plain versions
    standing in for the kernels (no launch expected)."""
    root = os.path.join(os.path.dirname(__file__), os.pardir)
    monkeypatch.syspath_prepend(root)   # the spawned ranks import it too
    import chip_smoke as cs

    for name, value in (("SERVE_MP_SMOKE", True), ("SERVE_MP_DEPTH", 4),
                        ("SERVE_MP_PROMPT", 32), ("SERVE_MP_LEN", 48),
                        ("SERVE_MP_STEPS", 3), ("SERVE_MP_B1", (8, 2))):
        monkeypatch.setattr(cs, name, value)
    out = cs.sharded_serving(torch.device("cpu"), Path(root).resolve()
                             / "src")
    assert len(out["ranks"]) == 4 and sum(out["launches"].values()) == 0
    text = capsys.readouterr().out
    assert "[19] phase 19:" in text and "gate failed" not in text


def test_chip_smoke_phase20_runs_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s phase 20 (training under the two-pod layout,
    inside phase 18's world of four spawned ranks: the unsharded run and
    its float32 copy, every gate) end to end on the CPU at granite's
    smoke config and small shapes, phase 18's own settings as its
    rehearsal takes them (``tests/test_torch_training.py``); the kernels'
    plain versions stand in for the kernels (no launch expected)."""
    root = os.path.join(os.path.dirname(__file__), os.pardir)
    monkeypatch.syspath_prepend(root)   # the spawned ranks import it too
    import chip_smoke as cs

    for name, value in (("MP_SMOKE", True), ("MP_SEQ", 16),
                        ("MP_PIPE", (2, 4, 3, 8)), ("MP_HIER_SHAPE", (6, 10)),
                        ("MP_NORM_RTOL", 2e-3), ("SEQ_LEN", 32)):
        monkeypatch.setattr(cs, name, value)
    out = cs.model_parallel(torch.device("cpu"), Path(root).resolve()
                            / "src")
    assert out["seq"]["eval_launches"] == 0
    assert len(out["seq"]["history"]) == cs.SEQ_STEPS
    text = capsys.readouterr().out
    assert "[20] phase 20:" in text and "gate failed" not in text


def test_chip_smoke_phase21_runs_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s phase 21 (the dry run's subprocesses, its
    gates and roofline rows) on the CPU: the full-size mamba2-370m
    ``decode_32k`` cell and gemma2-2b's smoke one-device step."""
    root = os.path.join(os.path.dirname(__file__), os.pardir)
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs

    monkeypatch.setattr(cs, "DRY_CELLS",
                        (("mamba2-370m", "decode_32k", "single"),))
    monkeypatch.setattr(cs, "DRY_ONE", ("gemma2-2b", 64, 1))
    monkeypatch.setattr(cs, "DRY_SMOKE", True)
    out = cs.dry_run(torch.device("cpu"), Path(root).resolve() / "src")
    rec = out["cells"]["mamba2-370m_decode_32k_single"]
    assert rec["ok"] and rec["devices"] == 256
    assert out["one_device"]["ok"]
    text = capsys.readouterr().out
    assert "[21] roofline/mamba2-370m_decode_32k_single: compute_s=" in text
    assert "[21] phase 21:" in text and "gate failed" not in text
