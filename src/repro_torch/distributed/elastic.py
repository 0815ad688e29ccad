"""Elastic scaling: rebuild the mesh around failed hardware and reshard.

The port of ``repro.distributed.elastic``. Fail-stop recovery at pod
scale is checkpoint/restart shaped (synchronous SPMD cannot lose a
participant mid-step), so elasticity here means:

  * ``best_mesh_shape`` — given the surviving chip count, pick the largest
    (data, model) grid the framework supports (model axis preserved when
    possible: changing TP degree changes per-op shapes; shrinking the data
    axis only changes throughput);
  * ``reshard_state`` — load a checkpoint saved under ANY mesh onto the new
    mesh (checkpoints store gathered arrays — `repro_torch.checkpoint.ckpt`);
  * ``ElasticPlan`` — what the launcher logs/acts on.

The serving side is elastic by construction: ``HedgedScheduler`` treats
replicas as independent resources — `add_replica`/`remove_replica` at
runtime — and the paper's redundancy masks a replica that dies mid-request.
"""
from __future__ import annotations

import dataclasses

from torch.distributed.device_mesh import DeviceMesh

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    healthy_devices: int
    mesh_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    dropped_devices: int
    global_batch_scale: float  # relative DP throughput vs nominal


def best_mesh_shape(healthy: int, model_degree: int = 16,
                    nominal_data: int = 16) -> tuple[int, int]:
    """Largest (data, model) grid on ``healthy`` chips, preferring to keep
    the model (TP) degree fixed and shrink data parallelism."""
    for m in (model_degree, model_degree // 2, model_degree // 4, 1):
        if m == 0:
            continue
        data = healthy // m
        if data >= 1:
            return (data, m)
    return (1, 1)


def plan_for(healthy: int, model_degree: int = 16,
             nominal: int = 256) -> ElasticPlan:
    data, model = best_mesh_shape(healthy, model_degree)
    used = data * model
    return ElasticPlan(
        healthy_devices=healthy,
        mesh_shape=(data, model),
        axis_names=("data", "model"),
        dropped_devices=healthy - used,
        global_batch_scale=(data * model) / nominal)


def reshard_state(cfg: ModelConfig, ckpt_dir: str, step: int, like: dict,
                  new_mesh: DeviceMesh | None) -> dict:
    """Restore a checkpoint onto ``new_mesh`` (any shape) with the arch's
    sharding rules re-derived for that mesh: each rank gets its blocks.
    ``like``: the tree to restore — a model's parameters by name
    (``{name: tensor}``), or a trainer's ``{"params": ..., "opt": ...}``
    — whose leaves give each block's dtype and device (whole-shape meta
    tensors will not do: the device is read from them). ``new_mesh=None``
    restores whole tensors on one device."""
    from repro_torch.models import layers, lm

    if new_mesh is None:
        return ckpt.restore(ckpt_dir, step, like)
    meta = lm.init(layers.MetaGenerator(), cfg)
    params = sharding.param_shardings(cfg, new_mesh, meta)
    if "params" not in like:
        return ckpt.restore(ckpt_dir, step, like, shardings=params)
    shardings = {"params": params}
    if "opt" in like:
        shardings["opt"] = sharding.opt_shardings(cfg, new_mesh, like["opt"],
                                                  meta)
    return ckpt.restore(ckpt_dir, step, like, shardings=shardings)
