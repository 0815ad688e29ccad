"""The train step: loss -> grads -> optimizer update.

The port of ``repro.training.step``, what ``launch/train.py`` executes.
With a ``ShardCtx`` (the model-parallel layer,
``repro_torch.distributed``) the step runs on every rank of its mesh
over the rank's rows of the batch, on a ``ShardedModel``: each part of
the model is gathered at its use from its placement (a block inside its
forward and its recompute), each gradient summed over the ranks and
taken back to the placement (a reduce-scatter) as backward reaches it, the
clip's norm taken over every shard once, and the optimizer updates the
local shards. Experts stay on their EP rank (``lm._run_moe``). The
ranks along ``model`` under the tp recipe's train layout hold the same
rows and compute the same thing (no head- or ff-parallel split of the
compute, which JAX's GSPMD does; ROADMAP lists it for the port's speed),
so they reach the same weights.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import ShardCtx
from repro_torch.models import lm
from repro_torch.training.optimizer import Optimizer


def make_train_step(cfg: ModelConfig, opt: Optimizer, kernel: str = "off",
                    ctx: ShardCtx | None = None) -> Callable:
    """``train_step(model, opt_state, batch, step) -> (model, opt_state,
    metrics)``: one backward of ``lm.loss_fn`` over ``batch`` (tensors on
    the model's device), then ``opt.update`` on the JAX package's leaves
    (``lm.leaf_groups``), in place. ``metrics`` adds ``grad_norm``, the
    global norm before the clip. The model's parameters must require
    grad; each step's gradients stay in ``p.grad`` until the next step.
    ``kernel="off"``, the counterpart of the reference's ``impl="ref"``,
    differentiates through the kernels' plain versions: the CUDA kernels
    have no backward pass.

    With ``ctx``, ``model`` is a ``repro_torch.distributed.sharding
    .ShardedModel`` on ``ctx.mesh``, ``opt_state`` its optimizer state
    over the shards, ``batch`` this rank's rows
    (``sharding.batch_rows``); every rank of the mesh calls the step.
    Each part of the model is gathered at its use and its gradient
    reduce-scattered as backward reaches it (``ShardedModel.loss``)."""
    groups: dict = {}

    def train_step(model: lm.LM, opt_state: dict, batch: dict, step):
        if model.cfg != cfg:
            raise ValueError(f"the step was made for {cfg.name}, the model "
                             f"is {model.cfg.name}")
        params = dict(model.named_parameters())
        if not groups:
            groups.update(lm.leaf_groups(model))
        for p in params.values():
            p.grad = None
        total, metrics = lm.loss_fn(model, batch, kernel=kernel)
        total.backward()
        grads = {n: p.grad for n, p in params.items()}
        _, opt_state, norm = opt.update(params, grads, opt_state, step,
                                        groups)
        metrics["grad_norm"] = norm
        return model, opt_state, metrics

    def sharded_step(model, opt_state: dict, batch: dict, step):
        if model.cfg != cfg or model.ctx != ctx:
            raise ValueError(f"the step was made for {cfg.name} on its "
                             f"ctx; the sharded model differs")
        total, metrics = model.loss(batch, kernel)
        total.backward()
        grads = model.take_grads()
        _, opt_state, norm = opt.update(model.shards, grads, opt_state,
                                        step, model.groups, sharded=model)
        metrics["grad_norm"] = norm
        return model, opt_state, metrics

    return train_step if ctx is None else sharded_step
