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

What the port runs under a ctx: the training layouts whose ``seq`` and
``kv_seq`` are unset (the batch split over ``ctx.batch``, experts over
``ctx.ep_axes``). A sequence-sharded prefill or a KV-sequence-sharded
decode is ROADMAP queue 1 item 14f; ``check_supported`` raises for it, so
the model never gives a silently wrong answer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from torch.distributed.device_mesh import DeviceMesh

AxisSpec = tuple[str, ...] | None  # mesh axes for one logical dim

SHARDED_SERVING_ITEM = "ROADMAP queue 1 item 14f (sharded serving)"


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


def batch_axes(ctx: ShardCtx) -> tuple[str, ...]:
    """The mesh axes that split the batch, major to minor (``()``: the
    batch is whole on every rank)."""
    return _norm(ctx.batch) or ()


def check_supported(ctx: ShardCtx | None) -> None:
    """Raise where the ctx shards the sequence or the KV sequence: the
    port has no sequence-sharded attention yet."""
    if ctx is None:
        return
    if _norm(ctx.seq) or _norm(ctx.kv_seq):
        raise NotImplementedError(
            f"a ShardCtx with seq={ctx.seq} kv_seq={ctx.kv_seq}: the port "
            f"runs only batch-split layouts; sequence-sharded prefill and "
            f"KV-sequence-sharded decode are {SHARDED_SERVING_ITEM}")


def constrain(x: Any, ctx: ShardCtx | None, *dims: AxisSpec) -> Any:
    """The identity: under explicit SPMD the tensor already is this
    rank's shard (the JAX function pins XLA's layout)."""
    return x


def constrain_tree(tree: Any, ctx: ShardCtx | None,
                   spec_fn: Callable) -> Any:
    """``constrain`` over every leaf: the identity, as ``constrain``."""
    return tree
