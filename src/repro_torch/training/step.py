"""The train step: loss -> grads -> optimizer update.

The port of ``repro.training.step``, what ``launch/train.py`` executes.
The reference takes a ``ShardCtx`` (its model-parallel layout); the port
runs on one device and has none until the model-parallel layer is ported
(ROADMAP queue 1 item 14e).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.training.optimizer import Optimizer


def make_train_step(cfg: ModelConfig, opt: Optimizer,
                    kernel: str = "off") -> Callable:
    """``train_step(model, opt_state, batch, step) -> (model, opt_state,
    metrics)``: one backward of ``lm.loss_fn`` over ``batch`` (tensors on
    the model's device), then ``opt.update`` on the JAX package's leaves
    (``lm.leaf_groups``), in place. ``metrics`` adds ``grad_norm``, the
    global norm before the clip. The model's parameters must require
    grad; each step's gradients stay in ``p.grad`` until the next step.
    ``kernel="off"``, the counterpart of the reference's ``impl="ref"``,
    differentiates through the kernels' plain versions: the CUDA kernels
    have no backward pass."""
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

    return train_step

