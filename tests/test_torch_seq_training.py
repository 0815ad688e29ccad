"""Training under the sequence-sharded layout on the CPU: the fsdp
recipe's train layout with two pods (``make_layout(cfg, "train",
multi_pod=True)``: the batch over ``("data", "model")``, the sequence
over ``pod``, experts over ``model``) on a spawned gloo world of 8 ranks,
a (pod 2, data 2, model 2) mesh, for the three archs that take it:
gemma2-2b (rows of 64 positions, so that the smoke window of 16 crosses
the pod boundary), granite-moe-3b-a800m (32) and llava-next-34b (8 smoke
patches and 8 text positions: the first pod rank holds only patch rows,
every mask entry 0, as at full size under ``train_4k``).

On JAX's weights carried into the port, JAX's expert choices replayed
(a near-tie flipped by a bf16 ulp moves a loss past any tolerance):
  * the sharded loss and per-parameter gradients against the port's
    one-device loss and gradients on the whole batch, with the capacity
    raised so that no token drops and the aux weight 0: the loss within
    ``LOSS_RTOL``, each gradient within twice the port's own bf16 floor
    (``tests/test_torch_model_parallel.py``'s rule and tolerances for
    the batch-split layouts);
  * a planted fault, the K/V gather without autograd, fails that
    gradient test (gemma2-2b);
  * the sharded cross entropy against the JAX package's own sharded
    loss under the same layout (a subprocess with 8 host devices and an
    ``Auto`` mesh), within ``JAX_LOSS_RTOL``;
  * granite's aux loss, with its weight, against the mean over the
    routing groups (a data row's two ranks' rows x a pod rank's block of
    positions, as the JAX package's ``_run_moe`` routes them) of the
    one-device router on the same tokens, within ``AUX_RTOL``; JAX's
    sharded aux (its first group's, as ``P()`` out of the ``shard_map``
    takes it) against the first group's;
  * two sharded ``Trainer`` steps against the one-device ``Trainer``
    on the same batches: each step's loss and grad norm within
    ``TRAIN_RTOL`` and its gathered gradients within twice the float32
    floor (the one-device ``Trainer`` in float32 on the same choices).
    The parameters after the steps are not held to that floor: AdamW
    moves an element by about lr whatever its gradient, so a near-zero
    gradient element of a zero-initialised norm scale flips the sign of
    its update on a rounding (one such element of gemma2-2b's 64 read 8.7
    times the floor, where the step's gradients read 0.34 of theirs).
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_model_parallel as mp
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, MarkovSource, UniformSource
from repro_torch.distributed import collectives, multihost, sharding
from repro_torch.models import lm, moe
from repro_torch.training.train_loop import Trainer, TrainerConfig

SRC = Path(__file__).resolve().parent.parent / "src"
ARCHS = ("gemma2-2b", "granite-moe-3b-a800m", "llava-next-34b")
# the embedded sequence of each arch (llava: patches + text)
SEQ = {"gemma2-2b": 64, "granite-moe-3b-a800m": 32, "llava-next-34b": 16}
BATCH = 4                       # a row a (data, model) rank
MESH = (2, 2, 2)                # (pod, data, model)
TRAIN_STEPS = 2
WORLD_LIMIT_S = 400.0
LOSS_RTOL = mp.LOSS_RTOL
JAX_LOSS_RTOL = mp.JAX_LOSS_RTOL
GRAD_FLOOR_MULT = mp.GRAD_FLOOR_MULT
TRAIN_RTOL = mp.TRAIN_RTOL
AUX_RTOL = 1e-5                 # float32 router sums, in another order
JAX_AUX_RTOL = mp.JAX_AUX_RTOL


def n_patches(cfg) -> int:
    return cfg.patch_stub.n_patches if cfg.patch_stub is not None else 0


def config(arch, aux: bool = False):
    """The smoke config, the capacity raised so that no token drops; the
    aux weight 0 unless ``aux``."""
    cfg = get_smoke_config(arch)
    m = cfg.moe
    if m is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k,
        aux_loss_weight=m.aux_loss_weight if aux else 0.0))


def inputs(arch) -> dict:
    """The batch: tokens (BATCH, text + 1) and a VLM's patches."""
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(1)
    text = SEQ[arch] - n_patches(cfg)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, text + 1))
           .astype(np.int32)}
    if cfg.patch_stub is not None:
        out["patches"] = rng.standard_normal(
            (BATCH, cfg.patch_stub.n_patches,
             cfg.patch_stub.embed_dim)).astype(np.float32)
    return out


def source(cfg, dcfg):
    """The trainers' batches: Markov tokens (a VLM's source draws no
    patches, so llava-next-34b takes uniform tokens and patches)."""
    kind = UniformSource if cfg.patch_stub is not None else MarkovSource
    return kind(cfg, dcfg)


class Recording:
    """The trainers' AdamW (lr 1e-3, the ``Trainer``'s default), each
    step's gradients recorded whole (a sharded model's gathered)."""

    def __init__(self, cfg):
        from repro_torch.training.optimizer import make_optimizer

        self.opt = make_optimizer(cfg.optimizer, lr=1e-3)
        self.grads: list[dict] = []

    def init(self, *args, **kw):
        return self.opt.init(*args, **kw)

    def update(self, params, grads, state, step, groups=None, sharded=None):
        self.grads.append({n: (g if sharded is None else sharding.gather_full(
            g, sharded.specs[n], sharded.mesh)).float().clone()
            for n, g in grads.items()})
        return self.opt.update(params, grads, state, step, groups, sharded)


def torch_batch(arch) -> dict:
    return {k: torch.from_numpy(v) for k, v in inputs(arch).items()}


def group_slices(arch, group: tuple[int, int]):
    """(rows, positions) of routing group (data d, pod p): the data row's
    two ranks' rows (gathered over ``model``), the pod rank's block."""
    d, p = group
    half = SEQ[arch] // MESH[0]
    rows = BATCH // MESH[1]
    return slice(d * rows, (d + 1) * rows), slice(p * half, (p + 1) * half)


def group_queue(arch, records: list, group) -> list:
    """Each choice recorded on the whole batch (BATCH x S tokens) cut to
    the group's tokens, in their order."""
    rows, pos = group_slices(arch, group)
    return [r.reshape(BATCH, SEQ[arch], -1)[rows, pos].reshape(
        -1, r.shape[-1]) for r in records]


# ---------------------------------------------------------------------------
# The JAX side (a subprocess with 8 host devices)
# ---------------------------------------------------------------------------

JAX_SCRIPT = r"""
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType

from repro.configs import get_smoke_config
from repro.distributed import sharding
from repro.models import lm, moe

in_path, out_path = sys.argv[1:3]
spec = pickle.load(open(in_path, "rb"))
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(AxisType.Auto,) * 3)
routes = []
orig = moe.route


def route(router_w, xt, cfg):
    out = orig(router_w, xt, cfg)
    jax.debug.callback(lambda idx: routes.append(np.asarray(idx)), out[0],
                       ordered=True)
    return out


out = {}
for arch, batch in spec.items():
    cfg = get_smoke_config(arch)
    if cfg.moe is not None:
        m = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k))
    params = lm.init(jax.random.PRNGKey(0), cfg)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    routes.clear()
    moe.route = route
    _, one = jax.jit(lambda p, b: lm.loss_fn(p, cfg, b))(params, batch)
    jax.effects_barrier()
    moe.route = orig
    rec = {"one": {k: float(v) for k, v in one.items()},
           "routes": list(routes), "params": jax.device_get(params)}
    layout = sharding.make_layout(cfg, "train", True, len(batch["tokens"]))
    ctx = sharding.make_ctx(cfg, mesh, layout)
    try:
        p_sh = sharding.param_shardings(cfg, mesh, params, inference=False,
                                        ep_axes=layout.ep_axes)
        b_sh = sharding.batch_shardings(cfg, mesh, layout, batch)
        total, m = jax.jit(lambda p, b: lm.loss_fn(p, cfg, b, ctx=ctx))(
            jax.device_put(params, p_sh), jax.device_put(batch, b_sh))
        rec["sharded"] = {k: float(v) for k, v in m.items()}
        rec["sharded"]["total"] = float(total)
        rec["layout"] = [layout.batch, layout.seq, layout.ep_axes]
    except Exception as exc:
        rec["sharded_error"] = f"{type(exc).__name__}: {exc}"
    out[arch] = rec
with open(out_path, "wb") as f:
    pickle.dump(out, f)
print("JAX_DONE")
"""


def run_jax(tmp: Path) -> subprocess.Popen:
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump({a: inputs(a) for a in ARCHS}, f)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", JAX_SCRIPT,
                             str(tmp / "spec.pkl"), str(tmp / "jax.pkl")],
                            env=env, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


# ---------------------------------------------------------------------------
# The world: 8 ranks, (pod 2, data 2, model 2)
# ---------------------------------------------------------------------------


def make_ctx(cfg, mesh):
    return sharding.make_ctx(cfg, mesh, sharding.make_layout(
        cfg, "train", True, BATCH))


def sharded_loss(arch, cfg, mesh, params, routes, coords) -> dict:
    """The sharded loss on this rank's rows, its group's choices replayed:
    the global metrics and the gathered gradients."""
    ctx = make_ctx(cfg, mesh)
    sm = sharding.ShardedModel.from_full(cfg, ctx, params, "cpu")
    queue = group_queue(arch, routes, (coords["data"], coords["pod"]))
    with mp.routes_replayed(queue):
        total, metrics = sm.loss(sharding.batch_rows(torch_batch(arch), ctx))
        total.backward()
    grads = sm.take_grads()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: sharding.gather_full(g, sm.specs[n], mesh)
                      for n, g in grads.items()},
            "layout": [ctx.batch, ctx.seq, tuple(ctx.ep_axes)]}


def _world(rank: int, store: str, inputs_path: str, out_dir: str) -> None:
    from repro_torch.launch.mesh import make_test_mesh

    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", 8, rank, device="cpu",
                         set_default_mesh=False, timeout_s=120.0)
    try:
        inp = torch.load(inputs_path, weights_only=False)
        mesh = make_test_mesh(*MESH[1:], n_pod=MESH[0])
        coords = collectives.mesh_coords(mesh)
        out: dict = {"loss": {}, "aux": {}, "train": {}}
        for arch in ARCHS:
            params, routes = inp["params"][arch], inp["routes"][arch]
            out["loss"][arch] = sharded_loss(arch, config(arch), mesh,
                                             params, routes, coords)
            if get_smoke_config(arch).moe is not None:
                out["aux"][arch] = sharded_loss(
                    arch, config(arch, aux=True), mesh, params, routes,
                    coords)["metrics"]
        # the planted fault: K and V gathered without autograd (their
        # gather's result has no history: every gradient to them is lost)
        orig = collectives.gather

        def planted(x, mesh_, axes, dim=0):
            if dim == 1:
                return collectives.all_gather(x.detach(), mesh_, axes, dim)
            return orig(x, mesh_, axes, dim)

        collectives.gather = planted
        try:
            arch = "gemma2-2b"
            out["planted"] = sharded_loss(arch, config(arch), mesh,
                                          inp["params"][arch], [], coords)
        finally:
            collectives.gather = orig
        for arch in ARCHS:
            cfg = config(arch)
            ctx = make_ctx(cfg, mesh)
            queue = group_queue(arch, inp["train_routes"][arch],
                                (coords["data"], coords["pod"]))
            dcfg = DataConfig(seq_len=SEQ[arch] - n_patches(cfg),
                              batch_size=BATCH)
            opt = Recording(cfg)
            with mp.routes_replayed(queue):
                res = Trainer(cfg, dcfg, TrainerConfig(
                    ckpt_dir=f"{out_dir}/ck_{arch}", ckpt_every=0,
                    log_every=1), opt=opt, source=source(cfg, dcfg),
                    device="cpu", ctx=ctx,
                    log_fn=lambda s: None).run(TRAIN_STEPS)
            out["train"][arch] = {"history": res["history"],
                                  "grads": opt.grads}
        out["bytes"] = dict(collectives.BYTES)
        torch.save(out, f"{out_dir}/r{rank}.pt")
    finally:
        multihost.shutdown()


def one_device_loss(arch, params, routes, widen: bool = False):
    """The port's one-device loss on the whole batch, JAX's choices
    replayed: (metrics, grads float32)."""
    cfg = config(arch)
    model = lm.init(lm.layers.MetaGenerator(), cfg)
    model.load_state_dict({n: t.clone() for n, t in params.items()},
                          strict=True, assign=True)
    model = (model.float() if widen else model).requires_grad_(True)
    with mp.routes_replayed(routes):
        total, metrics = lm.loss_fn(model, torch_batch(arch))
        total.backward()
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).float()
             for n, p in model.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, grads


def group_aux(arch, params, routes) -> dict:
    """The aux loss (with its weight) the sharded loss takes, from the
    one-device model: each MoE layer's input recorded on the whole batch
    (no grad: no recompute), the router's aux over each routing group's
    tokens with the replayed choices; per group the sum over the layers,
    and their mean."""
    cfg = config(arch, aux=True)
    model = lm.init(lm.layers.MetaGenerator(), cfg)
    model.load_state_dict(params, strict=True, assign=True)
    seen, orig = [], lm._run_moe

    def run_moe(p, x, cfg_, capacity=None, ctx=None):
        seen.append((p.router.w.detach(), x.detach().float()))
        return orig(p, x, cfg_, capacity, ctx)

    lm._run_moe = run_moe
    try:
        with torch.no_grad(), mp.routes_replayed(routes):
            lm.loss_fn(model, torch_batch(arch))
    finally:
        lm._run_moe = orig
    per = {}
    for d in range(MESH[1]):
        for p in range(MESH[0]):
            rows, pos = group_slices(arch, (d, p))
            total = 0.0
            for (w, x), r in zip(seen, routes):
                xt = x[rows, pos].reshape(-1, x.shape[-1])
                idx = torch.from_numpy(r.reshape(BATCH, SEQ[arch], -1)[
                    rows, pos].reshape(-1, r.shape[-1]).astype(np.int64))
                logits = moe.router_logits(w, xt, cfg.moe)
                total += float(moe.combine(logits, idx, cfg.moe)[2])
            per[d, p] = total
    return {"groups": per, "mean": float(np.mean(list(per.values())))}


def unsharded_trainer(arch, tmp: Path, routes: list | None = None):
    """The one-device ``Trainer`` on the same batches, its expert choices
    recorded; with ``routes`` those replayed and the model in float32.
    The result has each step's gradients (``grads``)."""
    cfg = config(arch)
    record: list = []
    kind = Trainer if routes is None else mp._Widened
    dcfg = DataConfig(seq_len=SEQ[arch] - n_patches(cfg), batch_size=BATCH)
    opt = Recording(cfg)
    with (mp.routes_recorded(record) if routes is None
          else mp.routes_replayed(routes)):
        res = kind(cfg, dcfg, TrainerConfig(
            ckpt_dir=str(tmp / f"one_{arch}"), ckpt_every=0, log_every=1),
            opt=opt, source=source(cfg, dcfg), device="cpu",
            log_fn=lambda s: None).run(TRAIN_STEPS)
    return dict(res, grads=opt.grads), record


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from repro_torch import interop

    tmp = tmp_path_factory.mktemp("seq_world")
    proc = run_jax(tmp)
    try:
        _, stderr = proc.communicate(timeout=WORLD_LIMIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    with open(tmp / "jax.pkl", "rb") as f:
        jax_out = pickle.load(f)
    params = {a: interop.lm_params_from_numpy(
        jax_out[a]["params"], config(a), "cpu") for a in ARCHS}
    routes = {a: jax_out[a]["routes"] for a in ARCHS}
    train = {a: unsharded_trainer(a, tmp) for a in ARCHS}
    train32 = {a: unsharded_trainer(a, tmp, r)[0]
               for a, (_, r) in train.items()}
    inputs_path = tmp / "inputs.pt"
    torch.save({"params": params, "routes": routes,
                "train_routes": {a: r for a, (_, r) in train.items()}},
               inputs_path)
    secs = multihost.spawn(_world, 8, (str(tmp / "store"), str(inputs_path),
                                       str(tmp)), WORLD_LIMIT_S)
    ranks = [torch.load(tmp / f"r{r}.pt", weights_only=False)
             for r in range(8)]
    return {"ranks": ranks, "jax": jax_out, "params": params,
            "routes": routes, "train": train, "train32": train32,
            "seconds": secs}


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_grads_match_one_device(world, arch):
    r = world["ranks"][0]["loss"][arch]
    assert r["layout"] == [("data", "model"), ("pod",), ("model",)]
    for other in world["ranks"][1:]:           # the metrics are global
        assert other["loss"][arch]["metrics"] == r["metrics"]
    params, routes = world["params"][arch], world["routes"][arch]
    want, grads = one_device_loss(arch, params, routes)
    _, grads32 = one_device_loss(arch, params, routes, widen=True)
    for key, w in want.items():
        got = r["metrics"][key]
        assert abs(got - w) <= LOSS_RTOL * max(abs(w), 1e-2), \
            (arch, key, got, w)
    floor, _ = mp.worst_rel(grads, grads32)
    err, name = mp.worst_rel(r["grads"], grads)
    print(f"{arch}: loss {r['metrics']['loss']} vs {want['loss']}; worst "
          f"grad {name} {err} against a floor of {floor}")
    assert err <= GRAD_FLOOR_MULT * floor, (arch, name, err, floor)


def test_planted_gather_without_autograd_fails_the_gradient_test(world):
    """K and V gathered with ``collectives.all_gather`` (no backward): the
    keys' and values' gradients are lost, and the gradient test fails
    (the loss, a forward value, is unchanged)."""
    arch = "gemma2-2b"
    r = world["ranks"][0]["planted"]
    params, routes = world["params"][arch], world["routes"][arch]
    want, grads = one_device_loss(arch, params, routes)
    _, grads32 = one_device_loss(arch, params, routes, widen=True)
    assert abs(r["metrics"]["loss"] - want["loss"]) <= LOSS_RTOL * abs(
        want["loss"])
    floor, _ = mp.worst_rel(grads, grads32)
    err, name = mp.worst_rel(r["grads"], grads)
    print(f"planted: worst grad {name} {err}, {err / floor} of the floor")
    assert err > GRAD_FLOOR_MULT * floor, (name, err, floor)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_matches_jax_sharded(world, arch):
    """The port's cross entropy under the layout against the JAX
    package's own sharded loss on the same weights and batch (its
    one-device loss beside it within its test's 2e-3)."""
    rec = world["jax"][arch]
    assert "sharded_error" not in rec, rec.get("sharded_error")
    assert rec["layout"] == [("data", "model"), ("pod",), ("model",)]
    got = world["ranks"][0]["loss"][arch]["metrics"]["loss"]
    want = rec["sharded"]["loss"]
    print(f"{arch}: port {got}, JAX sharded {want}, JAX one device "
          f"{rec['one']['loss']}")
    assert abs(got - want) <= JAX_LOSS_RTOL * abs(want), (arch, got, want)
    assert abs(want - rec["one"]["loss"]) <= 2e-3 * abs(rec["one"]["loss"])


def test_aux_loss_is_each_routing_groups(world):
    """granite's aux loss under the layout: the mean over the (data row x
    pod block) routing groups of the router's aux on the group's tokens;
    JAX's sharded aux is its first group's."""
    arch = "granite-moe-3b-a800m"
    want = group_aux(arch, world["params"][arch], world["routes"][arch])
    for r in world["ranks"]:
        got = r["aux"][arch]["aux_loss"]
        assert abs(got - want["mean"]) <= AUX_RTOL * want["mean"], \
            (got, want)
    jax_aux = world["jax"][arch]["sharded"]["aux_loss"]
    first = want["groups"][0, 0]
    print(f"aux: port {got}, groups {json.dumps({str(k): v for k, v in want['groups'].items()})}, "
          f"JAX sharded {jax_aux}")
    assert abs(jax_aux - first) <= JAX_AUX_RTOL * first, (jax_aux, first)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_trainer_matches_one_device(world, arch):
    got = world["ranks"][0]["train"][arch]
    want, _ = world["train"][arch]
    for h, w in zip(got["history"], want["history"], strict=True):
        for key in ("loss", "grad_norm"):
            assert np.isfinite(h[key])
            assert abs(h[key] - w[key]) <= TRAIN_RTOL * abs(w[key]), \
                (arch, h, w)
    want32 = world["train32"][arch]
    for step, (g, w, w32) in enumerate(zip(got["grads"], want["grads"],
                                           want32["grads"], strict=True)):
        floor, _ = mp.worst_rel(w, w32)
        err, name = mp.worst_rel(g, w)
        print(f"{arch} step {step}: worst grad {name} {err}, floor {floor}")
        assert err <= GRAD_FLOOR_MULT * floor, (arch, step, name, err, floor)
    for other in world["ranks"][1:]:
        assert other["train"][arch]["history"] == got["history"]


def test_keys_and_values_cross_the_pod_boundary(world):
    """The sequence split moved K and V between the pod ranks (the
    all-gathers of attention) and their gradients back (reduce-scatters)."""
    for r in world["ranks"]:
        assert r["bytes"]["all_gather"] > 0
        assert r["bytes"]["reduce_scatter"] > 0


def test_train_launcher_on_a_multi_pod_mesh(tmp_path):
    """``launch.train --mesh 1 1 --multi-pod``: two spawned ranks, the
    sequence split over ``pod``, the same losses as the one-device
    launcher on the same batches (within ``TRAIN_RTOL``)."""
    from repro_torch.launch import train

    argv = ["--arch", "gemma2-2b", "--smoke", "--steps", "2", "--seq-len",
            "32", "--batch", "2", "--device", "cpu", "--ckpt-every", "0",
            "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    got = train.main(argv + ["--mesh", "1", "1", "--multi-pod"])
    want = train.main(argv)["history"]
    assert got["ranks"] == 2
    for h, w in zip(got["history"], want, strict=True):
        for key in ("loss", "grad_norm"):
            assert abs(h[key] - w[key]) <= TRAIN_RTOL * abs(w[key]), (h, w)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("softcap", [None, 5.0])
def test_flash_ref_differentiable_at_an_offset(window, softcap):
    """The plain attention at ``q_offset`` (a pod rank's block of rows
    over its causal prefix) passes ``torch.autograd.gradcheck`` in
    float64: the in-place mask acts on the softcap's product, which no
    backward reads."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 3, 4, 4, generator=gen, dtype=torch.float64)
    k = torch.randn(1, 7, 2, 4, generator=gen, dtype=torch.float64)
    v = torch.randn(1, 7, 2, 4, generator=gen, dtype=torch.float64)
    for t in (q, k, v):
        t.requires_grad_(True)

    def fn(q, k, v):
        return flash_attention_ref(q, k, v, window=window, softcap=softcap,
                                   q_offset=4)

    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-5)


def test_check_seq_refuses_a_recurrent_layer():
    from repro_torch.distributed import ctx as ctx_mod

    ctx = ctx_mod.ShardCtx(mesh=None, batch=("data",), seq=("pod",))
    ctx_mod.check_seq(ctx, "local")
    ctx_mod.check_seq(None, "ssd")
    for kind in ("ssd", "rec", "mla"):
        with pytest.raises(NotImplementedError, match="only attention"):
            ctx_mod.check_seq(ctx, kind)
