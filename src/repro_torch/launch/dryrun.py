"""Multi-pod dry run: every (architecture x input shape) cell traced for
one rank of the production mesh, and the roofline's inputs extracted.

The port of ``repro.launch.dryrun``, under its name. The JAX module
lowers and compiles each cell against 256 or 512 forced host devices and
reads XLA's memory and cost analyses. The port has no compiler: one
process stands in for rank 0 of the production mesh (16 x 16, or 2 x 16
x 16 with ``pod``) under a fake process group (``torch.distributed``'s
``"fake"`` backend, whose collectives return at once) and runs the
port's own step on fake tensors (``FakeTensorMode``: shapes and dtypes,
no memory), so that no weight is allocated and no value is computed:

  * ``train_4k``: ``make_train_step(ctx=)`` on a ``ShardedModel`` under
    ``make_layout(cfg, "train", multi_pod)`` — each part gathered at its
    use, the gradients reduce-scattered, AdamW or Adafactor on the
    shards; under the fsdp recipe with two pods the sequence is split
    over ``pod`` (training under a sequence-sharded layout);
  * ``prefill_32k``: ``decode.prefill(ctx=)`` on the training rules'
    shards, its cache cut to the decode layout's blocks;
  * ``decode_32k`` / ``long_500k``: ``decode.decode_step(ctx=)`` on the
    inference rules' blocks read in place, a full cache's blocks, one
    token at the last position.

Each cell's record has the JAX module's field names that
``repro_torch.bench.roofline`` reads: ``ok``, ``devices``,
``scaled_flops``, ``scaled_io_bytes``, ``collective_bytes``
(``repro_torch.launch.hlo_analysis``: counted over the ATen operations
the rank dispatches, every loop and recompute as it runs),
``argument_size_in_bytes`` (exact, from the shard specs: the rank's
parameter blocks, optimizer state and batch, or cache and tokens),
``output_size_in_bytes`` (the step's results: the updated shards and
state, or the logits and cache) and ``temp_size_in_bytes`` (the peak
of ``torch.distributed._tools.mem_tracker.MemTracker`` over the step,
less the arguments: the activations, gathered weights and gradients
alive at the peak, outputs included). ``lower_s``/``compile_s`` become
``trace_s``. A cell that raises is ``ok: false`` with its error and
traceback, and the command exits 1 when any cell failed.

Data-dependent operations. A fake tensor holds no values, so an
operation that reads them on the host (``.item()``, ``nonzero``, a
count that sizes a tensor) raises. The port's step has none on these
paths: the MoE dispatch is the JAX package's static-capacity scheme (the
capacity from the token count, a shape; positions in an expert's queue
by a cumsum; dropped tokens written to a spare slot), the decode masks
are ``torch.where`` on tensors, the KV-split MLA decode tests its block
against the position on the host with Python ints, and the constants
rounded to the compute dtype (``sqrt(d)``) are ``torch.tensor``
constants, which a fake tensor keeps. The mesh's geometry is read once,
before the fake mode (``collectives.mesh_grid``). A cell that reaches a
data-dependent operation all the same fails, with that error.

The RG-LRU scan. Its plain version walks the sequence, one multiply and
one add a step (the card runs it as one ``rglru_scan`` launch in
serving; training differentiates the plain walk): 4,096 to 32,768
steps a layer, which fake tensors trace at ~0.5 ms an op, hours for a
recurrentgemma-9b cell. While tracing, the dry run takes the same
function in closed form instead (``_closed_form_scan``: ``h_t = P_t
sum_{s<=t} b_s / P_s`` with ``P_t = exp(sum log a)``, a handful of
whole-tensor ops of the same shapes); it has no product, so the FLOPs
do not move, and its traffic is a few passes over (B, L, W) where the
walk's would be its steps' slices.

Output goes to ``experiments/dryrun_torch/`` by default (git-ignored):
the port never reads the JAX package's records, which come from TPU
compiles. Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
      --shape train_4k --mesh multi
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

``--one-device SEQ BATCH`` (with ``--arch``, ``--smoke`` for its smoke
config) traces one train step of the arch on one device instead
(``one_device``; ``chip_smoke.py`` prints its temp bytes beside the
card's measured peak of the same step), into
``<arch>_one_device_<SEQ>x<BATCH>.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import base as cfgbase
from repro_torch.configs.base import SHAPES
from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.ctx import batch_axes
from repro_torch.launch import hlo_analysis
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import decode as dec
from repro_torch.models import lm
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.step import make_train_step

DEFAULT_OUT = "experiments/dryrun_torch"


def fake_world(n: int) -> None:
    """A fake process group of ``n`` ranks, this process rank 0 (the one
    there was, of another size, left first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
        collectives.forget_groups()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    # the mesh's own tensors stay real
    return FakeTensorMode(allow_non_fake_inputs=True)


def _local_shape(shape, spec, sizes) -> tuple[int, ...]:
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in sharding._axes_of(entry):
            out[d] //= sizes[a]
    return tuple(out)


def _blocks(tree, specs, sizes):
    """Fake blocks of a tree of meta tensors under its specs."""
    if isinstance(tree, dict):
        return {k: _blocks(v, specs[k], sizes) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_blocks(v, s, sizes) for v, s in zip(tree, specs)]
    return torch.empty(_local_shape(tree.shape, specs, sizes),
                       dtype=tree.dtype)


def _rows(batch: dict, ctx) -> dict:
    """This rank's rows of a batch of meta tensors, as fake tensors."""
    spec = (batch_axes(ctx) or None,)
    sizes = collectives.mesh_sizes(ctx.mesh)
    return {k: torch.empty(_local_shape(v.shape, spec + (None,) * (
        v.dim() - 1), sizes), dtype=v.dtype) for k, v in batch.items()}


def _model(cfg, ctx, inference: bool, ep_axes) -> sharding.ShardedModel:
    """A ``ShardedModel`` (built on the meta device, outside the fake
    mode) whose shards are fake blocks of the rules' specs; call inside
    the fake mode."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():
        meta = sp.param_specs(cfg)
        specs = sharding.port_param_specs(meta, cfg, inference=inference,
                                          ep_axes=ep_axes)
        sm = sharding.ShardedModel(cfg, ctx, "cpu", specs,
                                   in_place=inference)
    sizes = collectives.mesh_sizes(ctx.mesh)
    for name, p in sm.meta.named_parameters():
        sm.shards[name] = torch.empty(
            _local_shape(p.shape, sm.specs[name], sizes), dtype=p.dtype)
    return sm


def _step(cfg, shape, multi_pod: bool, mesh):
    """(the cell's step as a function of no arguments, its arguments) on
    fake tensors; call inside the fake mode."""
    layout = sharding.make_layout(cfg, shape.kind, multi_pod,
                                  shape.global_batch)
    ctx = sharding.make_ctx(cfg, mesh, layout)
    if shape.kind == "train":
        sm = _model(cfg, ctx, False, layout.ep_axes)
        opt = make_optimizer(cfg.optimizer)
        state = opt.init(sm.shards, sm.groups, sharded=sm)
        batch = _rows(sp.batch_specs(cfg, shape), ctx)
        step = make_train_step(cfg, opt, ctx=ctx)

        def run():
            _, new_state, metrics = step(sm, state, batch, 0)
            return sm.shards, new_state, metrics

        return run, (sm.shards, state, batch)
    if shape.kind == "prefill":
        sm = _model(cfg, ctx, False, layout.ep_axes)
        batch = _rows(sp.batch_specs(cfg, shape), ctx)

        def run():
            return dec.prefill(sm, batch["tokens"], shape.seq_len,
                               patches=batch.get("patches"), kernel="off",
                               ctx=ctx)

        return run, (sm.shards, batch)
    d = sp.decode_specs(cfg, shape)
    sm = _model(cfg, ctx, True, layout.ep_axes)
    specs = sharding.cache_specs(cfg, mesh, layout, d["cache"])
    cache = _blocks(d["cache"], specs, collectives.mesh_sizes(mesh))
    tokens = _rows({"tokens": d["tokens"]}, ctx)["tokens"]

    def run():
        return dec.decode_step(sm, cache, tokens, shape.seq_len - 1,
                               kernel="off", ctx=ctx)

    return run, (sm.shards, cache, tokens)


def _closed_form_scan(a: torch.Tensor, b: torch.Tensor,
                      h0: torch.Tensor | None = None) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` along axis 1 in closed form (``a`` in
    (0, 1), as the RG-LRU's gate is): the dry run's stand-in for the
    plain sequential scan (module docstring)."""
    p = torch.exp(torch.cumsum(torch.log(a), dim=1))
    h = p * torch.cumsum(b / p, dim=1)
    return h if h0 is None else h + p * h0[:, None]


@contextlib.contextmanager
def _closed_form_scans():
    from repro_torch.kernels.rglru_scan import ops as scan_ops

    walk = scan_ops.linear_scan_ref
    scan_ops.linear_scan_ref = _closed_form_scan
    try:
        yield
    finally:
        scan_ops.linear_scan_ref = walk


def trace(make) -> dict:
    """``make()`` -> (step, arguments) inside a fake mode; the step run
    once, counted (``hlo_analysis``) under a memory tracker: the
    record's cost and memory fields."""
    from torch.distributed._tools.mem_tracker import MemTracker

    t0 = time.perf_counter()
    with _fake_mode(), _closed_form_scans():
        run, args = make()
        arg_bytes = hlo_analysis.tensor_bytes(args)
        tracker = MemTracker()
        tracker.track_external(*[t for t in torch.utils._pytree.tree_leaves(
            args) if isinstance(t, torch.Tensor)])
        with tracker, hlo_analysis.counting() as counts:
            out = run()
        peak = tracker.get_tracker_snapshot("peak")
    totals = counts.totals()
    return {"trace_s": time.perf_counter() - t0,
            "scaled_flops": totals["flops"],
            "scaled_io_bytes": totals["io_bytes"],
            "collective_bytes": totals["collective_bytes"],
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": hlo_analysis.tensor_bytes(out),
            "temp_size_in_bytes": max(0, sum(
                d["Total"] for d in peak.values()) - arg_bytes)}


def one_device(cfg, seq: int, batch: int) -> dict:
    """The record of one train step of ``cfg`` on one device (``batch`` x
    ``seq`` tokens, the config's optimizer), traced on fake tensors."""
    def make():
        model = lm.init(lm.layers.MetaGenerator(), cfg)
        for name, p in list(model.named_parameters()):
            sharding._set_param(model, name, torch.nn.Parameter(
                torch.empty(p.shape, dtype=p.dtype)))
        params = dict(model.named_parameters())
        opt = make_optimizer(cfg.optimizer)
        state = opt.init(params, lm.leaf_groups(model))
        data = sp.batch_specs(cfg, cfgbase.InputShape("one", seq, batch,
                                                      "train"))
        data = {k: torch.empty(v.shape, dtype=v.dtype)
                for k, v in data.items()}
        step = make_train_step(cfg, opt)

        def run():
            _, new_state, metrics = step(model, state, data, 0)
            return params, new_state, metrics

        return run, (params, state, data)

    return trace(make)


def run_one_device(arch: str, seq: int, batch: int, out_dir: Path,
                   smoke: bool = False) -> dict:
    """``one_device``'s record of ``arch`` (its smoke config with
    ``smoke``), written as ``<arch>_one_device_<seq>x<batch>.json``."""
    t0 = time.time()
    record: dict = {"arch": arch, "shape": None, "mesh": "one_device",
                    "seq": seq, "batch": batch, "smoke": smoke}
    try:
        cfg = (cfgbase.get_smoke_config if smoke else cfgbase.get_config)(
            arch)
        record.update(ok=True, devices=1, **one_device(cfg, seq, batch))
    except Exception as e:
        record.update(ok=False, error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    record["total_s"] = round(time.time() - t0, 1)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{arch}_one_device_{seq}x{batch}"
    (out_dir / f"{tag}.json").write_text(json.dumps(record, indent=1))
    status = "OK" if record["ok"] else f"FAIL ({record['error']})"
    print(f"[dryrun] {tag}: {status} in {record['total_s']}s", flush=True)
    return record


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Path) -> dict:
    t0 = time.time()
    record: dict = {"arch": arch, "shape": shape_name,
                    "mesh": "multi" if multi_pod else "single"}
    try:
        cfg = cfgbase.get_config(arch)
        shape = SHAPES[shape_name]
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
        collectives.mesh_grid(mesh)       # read before the fake mode
        rec = trace(lambda: _step(cfg, shape, multi_pod, mesh))
        record.update(ok=True, devices=int(mesh.mesh.numel()), **rec)
        record["trace_s"] = round(record["trace_s"], 1)
    except Exception as e:
        record["ok"] = False
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["total_s"] = round(time.time() - t0, 1)

    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{arch}_{shape_name}_{record['mesh']}"
    (out_dir / f"{tag}.json").write_text(json.dumps(record, indent=1))
    status = "OK" if record.get("ok") else f"FAIL ({record.get('error')})"
    print(f"[dryrun] {tag}: {status} in {record['total_s']}s", flush=True)
    return record


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--one-device", type=int, nargs=2,
                    metavar=("SEQ", "BATCH"),
                    help="trace one train step of --arch on one device")
    ap.add_argument("--smoke", action="store_true",
                    help="with --one-device: the arch's smoke config")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    if args.one_device:
        rec = run_one_device(args.arch, *args.one_device, out_dir,
                             smoke=args.smoke)
        if not rec["ok"]:
            raise SystemExit("the one-device trace failed")
        return
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    if args.all:
        cells = [(a, s.name) for a in cfgbase.list_architectures()
                 for s in cfgbase.cells(a)]
    else:
        cells = [(args.arch, args.shape)]

    n_fail = 0
    try:
        for arch, shape_name in cells:
            for mp in meshes:
                tag = f"{arch}_{shape_name}_{'multi' if mp else 'single'}"
                if args.skip_existing and (out_dir / f"{tag}.json").exists():
                    existing = json.loads((out_dir / f"{tag}.json")
                                          .read_text())
                    if existing.get("ok"):
                        print(f"[dryrun] {tag}: cached OK", flush=True)
                        continue
                rec = run_cell(arch, shape_name, mp, out_dir)
                n_fail += 0 if rec.get("ok") else 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
            collectives.forget_groups()
    if n_fail:
        raise SystemExit(f"{n_fail} dry-run cells failed")


if __name__ == "__main__":
    main()
