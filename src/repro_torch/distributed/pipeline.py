"""Experimental pipeline parallelism over a mesh axis (``pod`` by default).

The port of ``repro.distributed.pipeline``. GPipe-style: the layer stack
is split into one stage per rank along the axis; microbatches flow
stage-to-stage by a send to the next rank and a receive from the
previous one (``collectives.shift``, the counterpart of JAX's
``ppermute``). With S stages and M microbatches the bubble fraction is
(S-1)/(M+S-1) — at S=2, M=8 that is 11%.

The schedule is the JAX package's, tick for tick: over M + S - 1 ticks,
stage 0 ingests microbatch t (zeros past the last), every stage applies
its layers to what it holds and passes the result on, and the last stage
emits microbatch t - (S - 1); its outputs are then broadcast to every
stage. The ranks off ``axis`` run their own pipelines side by side.
``torch.distributed.pipelining`` is not used: its schedules order the
microbatches their own way.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed import collectives


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, mesh: DeviceMesh,
                   axis: str = "pod") -> torch.Tensor:
    """Run ``n_stages`` sequential stages over microbatches of ``x``.

    stage_params: tensors (or nested dicts/lists of them) with a leading
    n_stages dim; the rank at index s along ``axis`` uses slice s.
    x: (n_micro, mb, ...) microbatched input, the same on every rank;
    the outputs (the last stage's) are returned on every rank.
    ``stage_fn(p, h)`` must keep ``h``'s shape and dtype."""
    n_stages = collectives.mesh_sizes(mesh)[axis]
    stage = collectives.mesh_coords(mesh)[axis]
    n_micro = x.shape[0]
    ticks = n_micro + n_stages - 1
    p_stage = collectives.tree_map(lambda a: a[stage], stage_params)
    buf = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(ticks):
        if stage == 0:  # stage 0 ingests microbatch t (when valid)
            cur_in = x[t] if t < n_micro else torch.zeros_like(buf)
        else:
            cur_in = buf
        y = stage_fn(p_stage, cur_in)
        buf = collectives.shift(y, mesh, axis) if n_stages > 1 else y
        out_idx = t - (n_stages - 1)
        if out_idx >= 0 and stage == n_stages - 1:
            outs[out_idx] = y
    # the last stage's outputs on every stage
    return collectives.broadcast(outs, mesh, (axis,), n_stages - 1)
