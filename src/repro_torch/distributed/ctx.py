"""Activation-sharding context threaded through the model code.

The port of ``repro.distributed.ctx``. ``ShardCtx`` names which mesh axes
shard each logical activation dimension; ``mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` (``repro_torch.launch.mesh
.make_test_mesh`` / ``make_production_mesh``). Axis assignments per
(recipe x step kind) come from ``repro_torch.distributed.sharding
.make_layout``.

The port executes explicit SPMD: each rank holds its shard of the batch
as a plain local tensor and the model calls its collectives itself (the
expert-parallel MoE, ``repro_torch.models.lm._run_moe``). So
``constrain`` is the identity, as the JAX function is in meaning: there
it is only a layout hint to XLA's partitioner.

What the port runs under a ctx: every layout of ``make_layout``. In
serving, a prefill with the sequence split over ``ctx.seq`` (each rank
runs its block of rows; attention gathers K and V over ``seq``) or the
batch split, and a decode with the KV cache's slots split over
``ctx.kv_seq`` (each rank attends over its own slots and the ranks
combine their partial softmaxes, ``repro_torch.distributed.tp``). In
training, the batch over ``ctx.batch``, experts over ``ctx.ep_axes``
and, in the fsdp recipe's train layout with two pods, the sequence over
``ctx.seq``: each rank runs its block of positions of its rows, and
attention gathers K and V over ``seq`` with an autograd gather, so the
gradients that other ranks' queries give a rank's keys and values come
back to it (``repro_torch.models.attention``). Only attention layers
take a split sequence: no layout of ``make_layout`` splits the sequence
of a recurrent or MLA model, and ``check_seq`` raises for one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from torch.distributed.device_mesh import DeviceMesh

AxisSpec = tuple[str, ...] | None  # mesh axes for one logical dim


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    mesh: DeviceMesh
    batch: AxisSpec = None        # batch dim of activations
    seq: AxisSpec = None          # sequence dim (SP/CP)
    kv_seq: AxisSpec = None       # KV-cache sequence dim (decode)
    heads: AxisSpec = None        # attention heads / d_inner (TP)
    model_axis: str = "model"     # the TP/EP axis name
    ep_axes: tuple[str, ...] = ("model",)  # expert-parallel axes
    recipe: str = "tp"

    def spec(self, *dims: AxisSpec) -> tuple:
        return tuple(d if d else None for d in dims)


def _norm(axes: AxisSpec) -> AxisSpec:
    if axes is None:
        return None
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes) or None


def batch_axes(ctx: ShardCtx | None) -> tuple[str, ...]:
    """The mesh axes that split the batch, major to minor (``()``: the
    batch is whole on every rank, or no ctx)."""
    return (_norm(ctx.batch) or ()) if ctx is not None else ()


def seq_axes(ctx: ShardCtx | None) -> tuple[str, ...]:
    """The mesh axes that split the sequence, major to minor."""
    return (_norm(ctx.seq) or ()) if ctx is not None else ()


def kv_axes(ctx: ShardCtx | None) -> tuple[str, ...]:
    """The mesh axes that split the KV cache's slots, major to minor."""
    return (_norm(ctx.kv_seq) or ()) if ctx is not None else ()


def check_seq(ctx: ShardCtx | None, kind: str) -> None:
    """Raise where the ctx splits the sequence of a layer that is not an
    attention layer (``kind``: the block's mixer): those run a recurrence
    or MLA over the whole sequence, and no layout of ``make_layout``
    splits their sequence (their archs take the tp recipe)."""
    if seq_axes(ctx) and kind not in ("global", "local"):
        raise NotImplementedError(
            f"a ShardCtx with seq={ctx.seq} over a {kind!r} layer: only "
            f"attention layers take a split sequence")


def constrain(x: Any, ctx: ShardCtx | None, *dims: AxisSpec) -> Any:
    """The identity: under explicit SPMD the tensor already is this
    rank's shard (the JAX function pins XLA's layout)."""
    return x


def constrain_tree(tree: Any, ctx: ShardCtx | None,
                   spec_fn: Callable) -> Any:
    """``constrain`` over every leaf: the identity, as ``constrain``."""
    return tree
