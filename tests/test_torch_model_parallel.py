"""The port's model-parallel layer on the CPU: spawned gloo worlds of 4
and 8 ranks (``repro_torch.distributed``), against the port unsharded
and the JAX package's sharded loss.

World A, 4 ranks on a (data 2, model 2) mesh (``make_test_mesh``):
  * the sharded smoke loss and per-leaf grads of deepseek-v3-671b (tp
    recipe: the batch over ``data``, experts over ``model``, tokens
    replicated over ``model``) and granite-moe-3b-a800m (under the JAX
    test's tp ctx, and under its own fsdp layout: the batch over
    ``("data", "model")``, tokens gathered over ``model``), on JAX's
    weights carried into the port, replaying JAX's expert choices:
    - against the JAX package's sharded loss on an ``Auto``-axis mesh of
      the same shape (a subprocess with 4 host devices;
      ``tests/test_distributed_exec.py``'s script, whose ``Explicit``
      mesh of jax 0.9 the reference's own test trips on): the cross
      entropy within ``JAX_LOSS_RTOL`` (measured 1.2e-4 deepseek, 1.1e-4
      granite; the MTP loss 1.9e-4);
    - against the port unsharded on the same function: each EP group
      (a ``data`` row) routes, drops past its capacity and takes its aux
      loss on its own tokens, as in JAX, so the reference is the mean
      over the groups of the one-device loss on the group's rows. Loss
      within ``LOSS_RTOL`` (measured 1e-7); grads, per parameter the
      largest |sharded - unsharded| over the largest |unsharded|, within
      twice the port's own bf16 floor (the same measure between the
      reference and its float32 copy), the rule of
      ``tests/test_torch_train_lm.py`` (measured 0.57 and 0.91 of the
      floor);
  * the sharded ``Trainer`` (granite 4 steps with AdamW, deepseek 2
    with Adafactor, whose factored means and RMS clip sum over the
    shards) against the one-device ``Trainer`` on the same Markov
    batches, expert choices replayed, capacity raised so nothing drops
    and the aux weight 0 (the aux loss is each group's, held above):
    losses and grad norms within ``TRAIN_RTOL`` (measured 3.1e-4 and
    2.3e-4), parameters and optimizer state after the last step, each
    leaf's distance within ``PARAM_FLOOR_MULT`` times its float32 floor
    (phase 18's measure, ``param_share``); the optimizer on shards against the
    whole-leaf update on the same gradients (``OPT_*``: parameters
    measured equal, Adafactor's state 1.3e-7);
    its gathered checkpoint equals its state bit for bit and a second
    sharded ``Trainer`` restores it (``ckpt.restore(shardings=)``) bit
    for bit; its init draws ``lm.init``'s weights bit for bit;
  * ``pipeline_apply`` with 2 stages on a (pod 2, data 2) mesh against
    the stages applied in turn (JAX's tolerance, 1e-5).
World B, 8 ranks: ``hierarchical_grad_reduce`` on (pod 2, data 2, model
2) against the flat mean (rtol 1e-6, JAX's) and a mean over ``data``
without a pod axis; a checkpoint saved from a (4, 2) mesh restored onto
(2, 2) (ranks 0-3) and onto one device through ``reshard_state``, bit
for bit: the JAX test's 8 x 8 array and granite's smoke model.

Each world is spawned once (a module fixture) and every case asserts on
what its ranks saved; a rank that raises fails its world
(``multihost.spawn``: joined with a deadline). The file imports no JAX
at module level: the spawned processes import it.
"""
import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import collectives, elastic, multihost
from repro_torch.distributed import pipeline, sharding
from repro_torch.distributed.ctx import ShardCtx
from repro_torch.models import lm, moe
from repro_torch.training.train_loop import Trainer, TrainerConfig

SRC = Path(__file__).resolve().parent.parent / "src"
MOE_ARCHS = ("deepseek-v3-671b", "granite-moe-3b-a800m")
BATCH, SEQ = 4, 16
N_DATA = 2                 # EP groups: the mesh's data rows
TRAIN_STEPS = {"granite-moe-3b-a800m": 4, "deepseek-v3-671b": 2}
WORLD_LIMIT_S = 300.0
# the ctxs each arch runs under: the JAX test's ("tp": batch over data,
# experts over model) and, for granite, its own fsdp layout
CTXS = {"deepseek-v3-671b": ("tp",),
        "granite-moe-3b-a800m": ("tp", "fsdp")}
LOSS_RTOL = 1e-3
JAX_LOSS_RTOL = 1e-3
JAX_AUX_RTOL = 1e-2
GRAD_FLOOR_MULT = 2.0
TRAIN_RTOL = 2e-3
# parameters after the last step, per leaf: the norm of (sharded -
# unsharded) over the unsharded one's norm within PARAM_FLOOR_MULT times
# the same measure between the unsharded run and its float32 copy (the
# model's own bf16 floor; chip_smoke.py's phase 18 gate). A share of the
# leaf's largest value will not do: AdamW and Adafactor move an element
# by about lr whatever its gradient, so a bf16-level difference flips
# the sign of a near-zero gradient's update. Measured: 0.41 of the bound
# (granite, AdamW, 4 steps; final_norm.scale 6.9e-5 against a floor of
# 8.5e-5), 0.63 (deepseek, Adafactor, 2 steps; mtp.h_norm.scale 8.3e-3
# against 6.6e-3). The optimizer's float32 state by the same measure
# within STATE_FLOOR_MULT: measured 1.10 times its floor (granite, AdamW's
# master copy of blocks.0.mixer.wk.w) and 1.81 (deepseek, Adafactor's
# second moment of prefix.0.mixer.kv_norm.scale); Adafactor's factored
# means summed over this rank's block alone, not over the shards, read
# 246 times the floor (lm_head.w's row means).
PARAM_FLOOR_MULT = 2.0
STATE_FLOOR_MULT = 4.0
# the sharded optimizer update on the unsharded update's gradients:
# parameters (bf16) within one bf16 ulp of the leaf's largest value,
# the float32 state within OPT_RTOL of its largest value
OPT_PARAM_TOL = 2.0**-7
OPT_RTOL = 1e-5


# ---------------------------------------------------------------------------
# Expert choices, recorded and replayed (no JAX)
# ---------------------------------------------------------------------------


def _key(xt: torch.Tensor):
    x = xt.detach().contiguous()
    return tuple(x.shape), x.view(-1).view(torch.uint8).numpy().tobytes()


@contextlib.contextmanager
def routes_recorded(record: list):
    """Record the port's choice for every new input of ``moe.route``
    (a recompute of a rematerialised repeat sees its input again)."""
    orig, seen = moe.route, set()

    def route(router_w, xt, cfg):
        out = orig(router_w, xt, cfg)
        key = _key(xt)
        if key not in seen:
            seen.add(key)
            record.append(out[0].numpy().copy())
        return out

    moe.route = route
    try:
        yield
    finally:
        moe.route = orig


@contextlib.contextmanager
def routes_replayed(queue: list, agree: list | None = None):
    """Each new input of ``moe.route`` takes the next choice of
    ``queue``; an input seen before takes the choice it took.
    ``agree`` collects (matching, total) of the port's own choices."""
    orig, queue, taken = moe.route, list(queue), {}

    def route(router_w, xt, cfg):
        key = _key(xt)
        if key not in taken:
            taken[key] = torch.from_numpy(queue.pop(0).astype(np.int64))
            if agree is not None:
                with torch.no_grad():
                    own = orig(router_w, xt, cfg)[0]
                agree.append((int((own == taken[key]).sum()), own.numel()))
        idx = taken[key]
        logits = moe.router_logits(router_w, xt, cfg)
        return (idx, *moe.combine(logits, idx, cfg))

    moe.route = route
    try:
        yield
    finally:
        moe.route = orig


@contextlib.contextmanager
def blocks_held(sm, held: list):
    """At each block's forward (and recompute), ``held`` gets the blocks
    of ``sm.model`` whose weights are gathered (off the meta device)."""
    orig = lm.block_forward

    def block_forward(p, *args, **kw):
        held.append([i for i, b in enumerate(sm.model.blocks)
                     if b.pre_norm.scale.device.type != "meta"])
        return orig(p, *args, **kw)

    lm.block_forward = block_forward
    try:
        yield
    finally:
        lm.block_forward = orig


def group_queue(records: list, groups, rows: int) -> list:
    """The replay queue of EP groups ``groups`` from choices recorded on
    the whole batch: per record, in order, each group's ``rows`` x SEQ
    tokens."""
    t = rows * SEQ
    return [r[g * t:(g + 1) * t] for r in records for g in groups]


# ---------------------------------------------------------------------------
# Configs and batches
# ---------------------------------------------------------------------------


def tokens(cfg) -> np.ndarray:
    rng = np.random.default_rng(1)
    return rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)


def train_cfg(arch):
    """The smoke config with the capacity raised so no token drops and
    the aux weight 0."""
    cfg = get_smoke_config(arch)
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k, aux_loss_weight=0.0))


def make_ctx(cfg, mesh, kind: str) -> ShardCtx:
    """``"tp"``: the ctx of ``tests/test_distributed_exec.py``; anything
    else: the arch's own train layout (granite's is fsdp)."""
    if kind == "tp":
        return ShardCtx(mesh=mesh, batch=("data",), ep_axes=("model",),
                        recipe="tp")
    return sharding.make_ctx(cfg, mesh, sharding.make_layout(
        cfg, "train", False, BATCH))


# ---------------------------------------------------------------------------
# World A: 4 ranks, (data 2, model 2)
# ---------------------------------------------------------------------------


def _world_a(rank: int, store: str, inputs: str, out_dir: str) -> None:
    from repro_torch.launch.mesh import make_test_mesh
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)   # the ranks share the host with other tests
    multihost.initialize(f"file://{store}", 4, rank, device="cpu",
                         set_default_mesh=False, timeout_s=120.0)
    try:
        inp = torch.load(inputs, weights_only=False)
        mesh = make_test_mesh(N_DATA, 2)
        coords = collectives.mesh_coords(mesh)
        out: dict = {"loss": {}, "train": {}}
        for arch in MOE_ARCHS:
            cfg = get_smoke_config(arch)
            for kind in CTXS[arch]:
                ctx = make_ctx(cfg, mesh, kind)
                sm = sharding.ShardedModel.from_full(
                    cfg, ctx, inp["params"][arch], "cpu")
                full = {"tokens": torch.from_numpy(tokens(cfg))}
                agree, held = [], []
                queue = group_queue(inp["jax_routes"][arch],
                                    [coords["data"]], BATCH // N_DATA)
                with routes_replayed(queue, agree), blocks_held(sm, held):
                    total, metrics = sm.loss(sharding.batch_rows(full, ctx))
                    total.backward()
                grads = sm.take_grads()
                out["loss"][arch, kind] = {
                    "held": held, "meta_after": all(
                        functools.reduce(getattr, n.split("."), sm.model)
                        .device.type == "meta" for n in sm.specs),
                    "metrics": {k: float(v) for k, v in metrics.items()},
                    "grads": {n: sharding.gather_full(g, sm.specs[n], mesh)
                              for n, g in grads.items()},
                    "agree": agree, "specs": dict(sm.specs)}
        out["opt"] = {arch: _opt_case(arch, mesh) for arch in MOE_ARCHS}
        for arch in MOE_ARCHS:
            cfg = train_cfg(arch)
            ctx = make_ctx(cfg, mesh, "layout")
            ckdir = f"{out_dir}/ckpt_{arch}"
            queue = group_queue(inp["train_routes"][arch], [coords["data"]],
                                BATCH // N_DATA)
            log: list = []

            def trainer():
                return Trainer(cfg, DataConfig(seq_len=SEQ, batch_size=BATCH),
                               TrainerConfig(ckpt_dir=ckdir, ckpt_every=1,
                                             async_ckpt=False, log_every=1),
                               device="cpu", ctx=ctx, log_fn=log.append)

            first = sharding.ShardedModel.init(cfg, ctx, 0, "cpu")
            init = first.full_params()
            with routes_replayed(queue):
                res = trainer().run(TRAIN_STEPS[arch])
            sm = res["model"]
            again = trainer().run(TRAIN_STEPS[arch])   # restores the last
            out["train"][arch] = {
                "init": init, "history": res["history"],
                "params": sm.full_params(),
                "opt": sharding.gather_tree(res["opt"], sm.opt_specs(
                    res["opt"]), mesh),
                "restored_equal": all(
                    torch.equal(again["model"].shards[n], s)
                    for n, s in sm.shards.items()) and all(
                    torch.equal(again["opt"][h][k], v)
                    for h in res["opt"] for k, v in res["opt"][h].items()),
                "resumed": log[-1]}
        # the pipeline: 2 stages on a (pod 2, data 2) mesh
        pmesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                           mesh_dim_names=("pod", "data"))
        w, x = inp["pipeline"]
        out["pipeline"] = pipeline.pipeline_apply(
            lambda p, h: torch.tanh(h @ p["w"]), {"w": w}, x, pmesh)
        out["bytes"] = dict(collectives.BYTES)
        torch.save(out, f"{out_dir}/a{rank}.pt")
    finally:
        multihost.shutdown()


def _opt_case(arch: str, mesh) -> dict:
    """Two optimizer updates (the arch's: deepseek Adafactor under the tp
    rules, granite AdamW under fsdp) on the same gradients, once on the
    whole parameters and once on this rank's shards: the worst
    difference of the gathered parameters and state."""
    from repro_torch.training.optimizer import make_optimizer

    cfg = get_smoke_config(arch)
    ctx = make_ctx(cfg, mesh, "layout")
    model = lm.init(torch.Generator("cpu").manual_seed(0), cfg)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    model.requires_grad_(True)
    total, _ = lm.loss_fn(model, {"tokens": torch.from_numpy(tokens(cfg))})
    total.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    opt = make_optimizer(cfg.optimizer, lr=1e-3)
    groups = lm.leaf_groups(model)
    whole = {n: t.clone() for n, t in start.items()}
    state = opt.init(whole, groups)
    sm = sharding.ShardedModel.from_full(cfg, ctx, start, "cpu")
    sstate = opt.init(sm.shards, sm.groups, sharded=sm)
    sgrads = {n: sharding.local_shard(g, sm.specs[n], mesh).contiguous()
              for n, g in grads.items()}
    norms = []
    for step in range(2):
        _, _, norm = opt.update(whole, grads, state, step, groups)
        _, _, snorm = opt.update(sm.shards, sgrads, sstate, step, sm.groups,
                                 sharded=sm)
        norms.append((float(norm), float(snorm)))
    params = sm.full_params()
    sstate = sharding.gather_tree(sstate, sm.opt_specs(sstate), mesh)

    def worst(a, b):
        return max(float((a[k].float() - b[k].float()).abs().max())
                   / max(float(b[k].float().abs().max()), 1e-30) for k in b)

    return {"params": worst(params, whole),
            "state": max(worst(sstate[h], state[h]) for h in state),
            "norms": norms,
            "sharded_leaves": sum(s.numel() < whole[n].numel()
                                  for n, s in sm.shards.items())}


# ---------------------------------------------------------------------------
# World B: 8 ranks
# ---------------------------------------------------------------------------


def _world_b(rank: int, store: str, out_dir: str) -> None:
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch.mesh import make_test_mesh
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", 8, rank, device="cpu",
                         set_default_mesh=False, timeout_s=120.0)
    try:
        out: dict = {}
        # hierarchical reduce: per-(pod, data) gradients, model replicas
        m3 = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                        mesh_dim_names=("pod", "data", "model"))
        c = collectives.mesh_coords(m3)
        p, d = c["pod"], c["data"]
        grads = {"w": torch.full((3, 5), float(p * 10 + d)),
                 "b": torch.arange(7, dtype=torch.float32) * (p + d + 1)}
        out["hier"] = collectives.hierarchical_grad_reduce(grads, m3)
        m42 = make_test_mesh(4, 2)
        d4 = collectives.mesh_coords(m42)["data"]
        out["flat"] = collectives.hierarchical_grad_reduce(
            {"w": torch.full((3, 5), float(d4))}, m42)
        # a checkpoint saved from (4, 2), restored onto (2, 2) (a mesh of
        # ranks 0-3, made after every group over more ranks: see
        # collectives.axes_group) and onto one device
        x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
        spec = ("data", "model")
        full = sharding.gather_full(sharding.local_shard(x, spec, m42), spec,
                                    m42)
        cfg = get_smoke_config("granite-moe-3b-a800m")
        ctx = sharding.make_ctx(cfg, m42, sharding.make_layout(
            cfg, "train", False, BATCH))
        params = sharding.ShardedModel.init(cfg, ctx, 0, "cpu").full_params()
        if rank == 0:
            ckpt.save(out_dir, 1, {"x": full})
            ckpt.save(out_dir, 2, params)
        collectives.all_reduce(torch.zeros(1), m42, ("data", "model"))
        mesh_b = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                            mesh_dim_names=("data", "model"))
        if rank < 4:
            sh = sharding.NamedSharding(mesh_b, ("model", None))
            blk = ckpt.restore(out_dir, 1, {"x": torch.empty(0)},
                               shardings={"x": sh})["x"]
            out["x_block"] = blk
            out["x_gathered"] = sh.gather(blk)
            like = {n: torch.empty(0, dtype=t.dtype)
                    for n, t in params.items()}
            blocks = elastic.reshard_state(cfg, out_dir, 2, like, mesh_b)
            specs = sharding.port_param_specs(
                sharding.ShardedModel(cfg, ctx, "cpu").meta, cfg)
            out["model_equal"] = all(
                torch.equal(sharding.gather_full(blocks[n], specs[n], mesh_b),
                            params[n]) for n in params)
            out["model_sharded"] = sum(
                blocks[n].numel() < params[n].numel() for n in params)
        if rank == 0:
            whole = elastic.reshard_state(cfg, out_dir, 2, like, None)
            out["whole_equal"] = all(torch.equal(whole[n], params[n])
                                     for n in params)
        out["x"] = x
        torch.save(out, f"{out_dir}/b{rank}.pt")
    finally:
        multihost.shutdown()


# ---------------------------------------------------------------------------
# The JAX side
# ---------------------------------------------------------------------------

JAX_SHARDED = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

from repro.configs import get_smoke_config
from repro.distributed.ctx import ShardCtx
from repro.models import lm

mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for arch in sys.argv[1:]:
    cfg = get_smoke_config(arch)
    params = lm.init(jax.random.PRNGKey(0), cfg)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (%(batch)d, %(seq)d + 1)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    ctx = ShardCtx(mesh=mesh, batch=("data",), seq=None, kv_seq=None,
                   ep_axes=("model",), recipe="tp")

    def spec_of(path, leaf):
        names = [str(getattr(p, "key", "")) for p in path]
        if any(n in ("w_up", "w_gate", "w_out") for n in names):
            s = [None] * leaf.ndim
            s[1 if "blocks" in names else 0] = "model"
            return NamedSharding(mesh, P(*s))
        return NamedSharding(mesh, P())

    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    shardings = jax.tree_util.tree_unflatten(
        treedef, [spec_of(p, l) for p, l in flat])
    loss, metrics = jax.jit(lambda p, b: lm.loss_fn(p, cfg, b, ctx=ctx))(
        jax.device_put(params, shardings),
        jax.device_put(batch, NamedSharding(mesh, P("data", None))))
    out[arch] = {k: float(v) for k, v in metrics.items()}
    out[arch]["total"] = float(loss)
print("JAX_SHARDED " + json.dumps(out))
""" % {"batch": BATCH, "seq": SEQ}


@contextlib.contextmanager
def jax_routes_recorded(record: list):
    import jax
    from repro.models import moe as jmoe

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


def jax_unsharded(arch):
    """JAX's one-device loss of the smoke model (seed 0) on ``tokens``,
    its expert choices, and its weights as the port's parameters."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import lm as jlm
    from repro_torch import interop

    jcfg = jax_smoke_config(arch)
    params = jax.device_get(jlm.init(jax.random.PRNGKey(0), jcfg))
    record: list = []
    with jax_routes_recorded(record):
        loss, metrics = jax.jit(lambda p, b: jlm.loss_fn(p, jcfg, b))(
            params, {"tokens": jnp.asarray(tokens(jcfg))})
        jax.effects_barrier()
    return {"loss": float(metrics["loss"]), "total": float(loss),
            "routes": record,
            "params": interop.lm_params_from_numpy(
                params, get_smoke_config(arch), "cpu")}


# ---------------------------------------------------------------------------
# The port's references
# ---------------------------------------------------------------------------


def carried_model(arch, params):
    model = lm.init(torch.Generator("cpu").manual_seed(0),
                    get_smoke_config(arch))
    model.load_state_dict(params, strict=True, assign=False)
    return model.requires_grad_(True)


def group_mean(model, records) -> tuple[float, dict, dict]:
    """The one-device counterpart of the sharded loss: the mean over the
    EP groups (``N_DATA`` blocks of rows) of ``lm.loss_fn`` on the
    group's rows, JAX's choices replayed. (total, metrics, grads)."""
    rows = BATCH // N_DATA
    full = torch.from_numpy(tokens(model.cfg))
    for p in model.parameters():
        p.grad = None
    total, metrics = 0.0, {}
    queue = [r[g * rows * SEQ:(g + 1) * rows * SEQ]
             for g in range(N_DATA) for r in records]
    with routes_replayed(queue):
        for g in range(N_DATA):
            t, m = lm.loss_fn(model, {"tokens": full[g * rows:(g + 1)
                                                     * rows]})
            total = total + t / N_DATA
            for k, v in m.items():
                metrics[k] = metrics.get(k, 0.0) + float(v) / N_DATA
        total.backward()
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).float()
             for n, p in model.named_parameters()}
    return float(total), metrics, grads


def worst_rel(got: dict, want: dict) -> tuple[float, str]:
    out = []
    for name, w in want.items():
        scale = float(w.abs().max())
        err = float((got[name].float() - w.float()).abs().max())
        out.append((err / scale if scale else (0.0 if err == 0
                                               else float("inf")), name))
    return max(out)


class _Widened(Trainer):
    """The one-device ``Trainer`` with its model in float32."""

    def init_state(self, seed: int = 0):
        model, _, start = super().init_state(seed)
        model = model.float()
        return model, self.opt.init(dict(model.named_parameters()),
                                    lm.leaf_groups(model)), start


def param_share(p, want, want32, mult: float = PARAM_FLOOR_MULT
                ) -> tuple[float, float, float]:
    """(err / (mult x floor), err, floor): ``err`` the norm of ``p -
    want`` over ``want``'s, ``floor`` that of ``want32 - want``."""
    def rel(a, b):
        a, b = a.detach().float(), b.detach().float()
        return float(torch.linalg.vector_norm(a - b)) / max(
            float(torch.linalg.vector_norm(b)), 1e-30)

    err, floor = rel(p, want), rel(want32, want)
    if floor == 0:
        return (0.0 if err == 0 else float("inf")), err, floor
    return err / (mult * floor), err, floor


def unsharded_trainer(arch, tmp: Path, routes: list | None = None):
    """The one-device ``Trainer`` on the same batches, its expert
    choices recorded; with ``routes``, those choices replayed and the
    model in float32 (the yardstick of the parameters' bf16 floor)."""
    cfg = train_cfg(arch)
    record: list = []
    kind = Trainer if routes is None else _Widened
    with (routes_recorded(record) if routes is None
          else routes_replayed(routes)):
        res = kind(cfg, DataConfig(seq_len=SEQ, batch_size=BATCH),
                   TrainerConfig(ckpt_dir=str(tmp / f"one_{arch}"),
                                 ckpt_every=0, log_every=1),
                   device="cpu", log_fn=lambda s: None
                   ).run(TRAIN_STEPS[arch])
    return res, record


# ---------------------------------------------------------------------------
# Fixtures: each world once
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world_a(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world_a")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_SHARDED,
                                 *MOE_ARCHS], env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
    try:
        jax_one = {arch: jax_unsharded(arch) for arch in MOE_ARCHS}
        one_train = {arch: unsharded_trainer(arch, tmp)
                     for arch in MOE_ARCHS}
        one_train32 = {arch: unsharded_trainer(arch, tmp, routes)[0]
                       for arch, (_, routes) in one_train.items()}
        gen = torch.Generator().manual_seed(0)
        pipe = (torch.randn(2, 8, 8, generator=gen) * 0.3,
                torch.randn(4, 3, 8, generator=gen))
        inputs = tmp / "inputs.pt"
        torch.save({"params": {a: j["params"] for a, j in jax_one.items()},
                    "jax_routes": {a: j["routes"] for a, j in
                                   jax_one.items()},
                    "train_routes": {a: r for a, (_, r) in
                                     one_train.items()},
                    "pipeline": pipe}, inputs)
        secs = multihost.spawn(_world_a, 4, (str(tmp / "store"), str(inputs),
                                             str(tmp)), WORLD_LIMIT_S)
        stdout, stderr = jax_proc.communicate(timeout=WORLD_LIMIT_S)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0, stderr[-3000:]
    line = next(ln for ln in stdout.splitlines()
                if ln.startswith("JAX_SHARDED "))
    ranks = [torch.load(tmp / f"a{r}.pt", weights_only=False)
             for r in range(4)]
    return {"ranks": ranks, "jax_sharded": json.loads(line[12:]),
            "jax_one": jax_one, "one_train": one_train,
            "one_train32": one_train32, "pipe": pipe,
            "seconds": secs, "tmp": tmp}


@pytest.fixture(scope="module")
def world_b(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world_b")
    multihost.spawn(_world_b, 8, (str(tmp / "store"), str(tmp)),
                    WORLD_LIMIT_S)
    return [torch.load(tmp / f"b{r}.pt", weights_only=False)
            for r in range(8)]


# ---------------------------------------------------------------------------
# World A's cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sharded_loss_matches_jax_sharded(world_a, arch):
    """The port's cross entropy (and MTP loss) under the JAX test's ctx
    against JAX's own sharded values (``Auto`` mesh, 2 x 2), the same
    weights and tokens; JAX's sharded loss stays within its test's bound
    (2e-3) of its one-device loss.

    The aux loss is not compared with JAX's: JAX's ``_run_moe`` averages
    it over the EP axes only and returns it as replicated (``P()``), so
    its sharded value is the first data row's group's, not the mean over
    the groups that the port takes (and the one-device loss approaches).
    That is held here: JAX's sharded aux is within ``JAX_AUX_RTOL`` of
    the port's one-device aux on the first group's rows alone."""
    got = world_a["ranks"][0]["loss"][arch, "tp"]["metrics"]
    want = world_a["jax_sharded"][arch]
    for key in ("loss", "mtp_loss"):
        if key in want:
            assert abs(got[key] - want[key]) <= JAX_LOSS_RTOL * abs(
                want[key]), (arch, key, got[key], want[key])
    one = world_a["jax_one"][arch]
    assert abs(want["total"] - one["total"]) <= 2e-3 * abs(one["total"])
    rows = BATCH // N_DATA
    model = carried_model(arch, one["params"])
    full = torch.from_numpy(tokens(model.cfg))
    with routes_replayed([r[:rows * SEQ] for r in one["routes"]]), \
            torch.no_grad():
        _, first = lm.loss_fn(model, {"tokens": full[:rows]})
    aux0 = float(first["aux_loss"])
    assert abs(want["aux_loss"] - aux0) <= JAX_AUX_RTOL * aux0, \
        (arch, want["aux_loss"], aux0, got["aux_loss"])


@pytest.mark.parametrize("arch,kind", [(a, k) for a in MOE_ARCHS
                                       for k in CTXS[a]])
def test_sharded_loss_and_grads_match_unsharded(world_a, arch, kind):
    r = world_a["ranks"][0]["loss"][arch, kind]
    for other in world_a["ranks"][1:]:   # the metrics are global
        assert other["loss"][arch, kind]["metrics"] == r["metrics"]
    params = world_a["jax_one"][arch]["params"]
    routes = world_a["jax_one"][arch]["routes"]
    model = carried_model(arch, params)
    total, metrics, grads = group_mean(model, routes)
    _, _, grads32 = group_mean(carried_model(arch, params).float(), routes)
    for key, want in metrics.items():
        assert abs(r["metrics"][key] - want) <= LOSS_RTOL * max(
            abs(want), 1e-2), (arch, kind, key)
    floor, _ = worst_rel(grads, grads32)
    err, name = worst_rel(r["grads"], grads)
    assert err <= GRAD_FLOOR_MULT * floor, (arch, kind, name, err, floor)
    # the fsdp layout gathers the tokens over model: experts only there
    if kind == "fsdp":
        assert any(s[-3] == "model" for n, s in r["specs"].items()
                   if n.endswith("w_up"))


@pytest.mark.parametrize("arch,kind", [(a, k) for a in MOE_ARCHS
                                       for k in CTXS[a]])
def test_blocks_gathered_only_at_use(world_a, arch, kind):
    """Each block's weights are whole only inside its forward and its
    recompute: at every block call the blocks gathered are those of its
    group (a repeat of the pattern, or a prefix block), every block ran
    twice (forward and recompute) but the prefix's, and after the loss's
    backward no parameter is held whole."""
    cfg = get_smoke_config(arch)
    n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)
    r = world_a["ranks"][0]["loss"][arch, kind]
    calls = [h for h in r["held"] if h]   # the MTP block is off the stack
    assert len(r["held"]) - len(calls) == int(cfg.mtp)
    for held in calls:
        assert (held == [held[0]] if held[0] < n_pre else
                held == list(range(held[0], held[0] + n_pat))), held
    assert len(calls) == n_pre + 2 * cfg.repeats * n_pat
    assert r["meta_after"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sharded_trainer_matches_unsharded(world_a, arch):
    got = world_a["ranks"][0]["train"][arch]
    want, _ = world_a["one_train"][arch]
    hist, whist = got["history"], want["history"]
    assert [h["step"] for h in hist] == [h["step"] for h in whist]
    for h, w in zip(hist, whist):
        for key in ("loss", "grad_norm"):
            assert np.isfinite(h[key])
            assert abs(h[key] - w[key]) <= TRAIN_RTOL * abs(w[key]), \
                (arch, h, w)
    wparams = dict(want["model"].named_parameters())
    w32 = dict(world_a["one_train32"][arch]["model"].named_parameters())
    worst = max(param_share(p, wparams[n], w32[n]) + (n,)
                for n, p in got["params"].items())
    assert worst[0] <= 1.0, (arch, worst)
    # the optimizer's float32 state (AdamW's moments and master weights,
    # Adafactor's factored second moments) by the same measure
    s32 = world_a["one_train32"][arch]["opt"]
    worst = max(param_share(t, want["opt"][h][k], s32[h][k],
                            STATE_FLOOR_MULT) + (h, k)
                for h, sub in got["opt"].items() for k, t in sub.items())
    assert worst[0] <= 1.0, (arch, worst)
    # every rank gathered the same state
    for other in world_a["ranks"][1:]:
        for name, p in got["params"].items():
            assert torch.equal(other["train"][arch]["params"][name], p)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sharded_optimizer_matches_on_the_same_gradients(world_a, arch):
    """AdamW and Adafactor on shards (the clip's norm over every shard
    once; Adafactor's factored means and RMS summed over the axes that
    shard them) against the whole-leaf update, on the same gradients."""
    for r in world_a["ranks"]:
        got = r["opt"][arch]
        assert got["sharded_leaves"] > 0
        assert got["params"] <= OPT_PARAM_TOL, (arch, got)
        assert got["state"] <= OPT_RTOL, (arch, got)
        for norm, snorm in got["norms"]:
            assert abs(norm - snorm) <= OPT_RTOL * norm


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sharded_init_draws_lm_init(world_a, arch):
    """Every rank drew the one-device weights from the seed, part by
    part, and kept its shard: gathered, ``lm.init``'s bit for bit."""
    got = world_a["ranks"][0]["train"][arch]["init"]
    want = lm.init(torch.Generator("cpu").manual_seed(0), train_cfg(arch))
    for name, p in want.named_parameters():
        assert torch.equal(got[name], p), name


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sharded_checkpoint_is_whole_and_restores(world_a, arch):
    from repro_torch.checkpoint import ckpt

    got = world_a["ranks"][0]["train"][arch]
    steps = TRAIN_STEPS[arch]
    ckdir = world_a["tmp"] / f"ckpt_{arch}"
    assert ckpt.latest_step(ckdir) == steps
    like = {"params": {n: torch.empty(0, dtype=p.dtype)
                       for n, p in got["params"].items()},
            "opt": {h: {k: torch.empty(0, dtype=v.dtype)
                        for k, v in sub.items()}
                    for h, sub in got["opt"].items()}}
    saved = ckpt.restore(ckdir, steps, like)
    for n, p in got["params"].items():
        assert torch.equal(saved["params"][n], p), n
    for h, sub in got["opt"].items():
        for k, v in sub.items():
            assert torch.equal(saved["opt"][h][k], v), (h, k)
    for r in world_a["ranks"]:
        assert r["train"][arch]["restored_equal"]
        assert f"resumed from step {steps}" in r["train"][arch]["resumed"]


def test_pipeline_matches_sequential(world_a):
    w, x = world_a["pipe"]
    ref = torch.tanh(torch.tanh(x @ w[0]) @ w[1])
    for r in world_a["ranks"]:
        assert float((r["pipeline"] - ref).abs().max()) < 1e-5


def test_collectives_moved_bytes(world_a):
    for r in world_a["ranks"]:
        assert r["bytes"]["all_gather"] > 0
        assert r["bytes"]["reduce_scatter"] > 0
        assert r["bytes"].get("broadcast", 0) > 0      # the pipeline's
    # the first stage sends (the pipeline), the last only receives
    assert [r["bytes"].get("send_recv", 0) > 0 for r in
            world_a["ranks"]] == [True, True, False, False]


# ---------------------------------------------------------------------------
# World B's cases
# ---------------------------------------------------------------------------


def test_hierarchical_reduce_matches_flat_mean(world_b):
    ws = [float(p * 10 + d) for p in range(2) for d in range(2)]
    want_w = torch.full((3, 5), float(np.mean(ws)))
    want_b = torch.arange(7, dtype=torch.float32) * float(
        np.mean([p + d + 1 for p in range(2) for d in range(2)]))
    for r in world_b:
        torch.testing.assert_close(r["hier"]["w"], want_w, rtol=1e-6,
                                   atol=0)
        torch.testing.assert_close(r["hier"]["b"], want_b, rtol=1e-6,
                                   atol=0)
        torch.testing.assert_close(r["flat"]["w"], torch.full((3, 5), 1.5),
                                   rtol=1e-6, atol=0)


def test_checkpoint_resharded_onto_smaller_mesh(world_b):
    """Saved from a (4, 2) mesh, restored onto (2, 2): each rank's block
    of ("model", None), and the blocks gathered, equal the array."""
    x = world_b[0]["x"]
    for rank in range(4):
        r = world_b[rank]
        m = rank % 2                      # (data, model) = divmod(rank, 2)
        assert torch.equal(r["x_block"], x[4 * m:4 * m + 4])
        assert torch.equal(r["x_gathered"], x)


def test_model_resharded_by_reshard_state(world_b):
    for rank in range(4):
        assert world_b[rank]["model_equal"]
        assert world_b[rank]["model_sharded"] > 0   # the experts at least
    assert world_b[0]["whole_equal"]


# ---------------------------------------------------------------------------
# Without a world
# ---------------------------------------------------------------------------


class TestElasticPlanning:
    def test_full_pod(self):
        plan = elastic.plan_for(256)
        assert plan.mesh_shape == (16, 16)
        assert plan.dropped_devices == 0
        assert plan.global_batch_scale == 1.0

    def test_one_host_down(self):
        # lose 8 chips (one host): keep TP=16, shrink data to 15
        plan = elastic.plan_for(248)
        assert plan.mesh_shape == (15, 16)
        assert plan.dropped_devices == 8
        assert plan.global_batch_scale == pytest.approx(240 / 256)

    def test_heavy_degradation_halves_tp(self):
        assert elastic.best_mesh_shape(8, model_degree=16) == (1, 8)

    def test_monotone_in_health(self):
        scales = [elastic.plan_for(n).global_batch_scale
                  for n in (64, 128, 192, 256)]
        assert scales == sorted(scales)


@pytest.mark.parametrize("model_degree", [1, 2, 4, 8, 16])
def test_plans_equal_jax(model_degree):
    from repro.distributed import elastic as jelastic

    for healthy in range(1, 300, 7):
        got = elastic.plan_for(healthy, model_degree)
        want = jelastic.plan_for(healthy, model_degree)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert elastic.plan_for(2, model_degree=2).mesh_shape == (1, 2)


def test_ctx_with_sequence_sharding_raises(tmp_path):
    """The training loss under a sequence-sharded ctx equals the
    one-device loss, as do prefill and decode under ``seq`` / ``kv_seq``
    ctxs (here on a one-rank world, whose splits are trivial); a
    sequence-sharded ctx raises only over a layer that is not attention
    (a recurrent model: no layout splits its sequence); ``constrain`` is
    the identity."""
    import torch.distributed as dist

    from repro_torch.distributed import ctx as ctx_mod
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import decode

    cfg = get_smoke_config("granite-moe-3b-a800m")
    model = lm.init(torch.Generator("cpu").manual_seed(0), cfg)
    batch = {"tokens": torch.from_numpy(tokens(cfg))}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_test_mesh(1, 1)
        ctx = ShardCtx(mesh=mesh, batch=("data",), seq=("model",))
        got, gm = lm.loss_fn(model, batch, ctx=ctx)
        want, wm = lm.loss_fn(model, batch)
        assert torch.equal(got, want) and gm == wm
        rec = get_smoke_config("mamba2-370m")
        with pytest.raises(NotImplementedError, match="only attention"):
            lm.loss_fn(lm.init(torch.Generator("cpu").manual_seed(0), rec),
                       {"tokens": torch.from_numpy(tokens(rec))}, ctx=ctx)
        prompt = batch["tokens"][:, :SEQ]
        logits, cache = decode.prefill(model, prompt, 2 * SEQ, ctx=ctx)
        want, wcache = decode.prefill(model, prompt, 2 * SEQ)
        assert torch.equal(logits, want)
        dctx = ShardCtx(mesh=mesh, batch=("data",), kv_seq=("model",))
        step = batch["tokens"][:, SEQ:SEQ + 1]
        got, _ = decode.decode_step(model, cache, step, SEQ, ctx=dctx)
        want, _ = decode.decode_step(model, wcache, step, SEQ)
        assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()
        collectives.forget_groups()
    x = torch.ones(2)
    assert ctx_mod.constrain(x, ctx, ("data",)) is x


def test_mesh_of_the_wrong_size_raises():
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

    with pytest.raises(ValueError, match="needs a process group of 8"):
        make_test_mesh(2, 4)
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True)


def test_new_modules_import_no_jax():
    mods = ["repro_torch.distributed.ctx", "repro_torch.distributed.sharding",
            "repro_torch.distributed.tp", "repro_torch.models.decode",
            "repro_torch.distributed.collectives",
            "repro_torch.distributed.pipeline",
            "repro_torch.distributed.elastic", "repro_torch.launch.specs",
            "repro_torch.launch.mesh", "repro_torch.training.step",
            "repro_torch.training.train_loop", "repro_torch.checkpoint.ckpt",
            "repro_torch.models.lm", "repro_torch.configs.base"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
              "('jax.', 'repro.')) or m == 'repro']\n"
              "assert not bad, bad\nprint('NO_JAX_OK')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "NO_JAX_OK" in out.stdout

