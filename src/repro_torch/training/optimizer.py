"""Optimizers: AdamW (float32 master + moments) and Adafactor (factored
second moment, no momentum, no master), as plain functions on tensors.

The port of ``repro.training.optimizer``, not ``torch.optim``: the
arithmetic follows the JAX package's line by line. ``params`` and
``grads`` are dicts of tensors keyed by the model's parameter names
(``dict(model.named_parameters())``); a missing or ``None`` gradient is
zero, as JAX gives an unused leaf. ``update`` writes the new parameters
(in their own dtype) and the new state into the given tensors in place,
one leaf at a time, so that the float32 temporaries of one leaf (2.4 GB
for gemma2-2b's tied 256,000 x 2,304 table) are all that is added to the
standing state; it returns ``(params, state, global grad norm)``, the
norm the clip measured beside what the JAX update returns.

JAX leaves. The JAX package stacks each parameter of ``cfg.pattern``'s
repeats into one leaf of shape (R, ...); the port keeps one tensor per
layer. AdamW works element by element, so this changes nothing for it.
Adafactor does not: its update clip takes the RMS over a whole leaf, and
it factors any leaf of two or more dims, a stacked (R, d) norm scale
included. So ``init``/``update`` take ``groups``
(``repro_torch.models.lm.leaf_groups``: JAX leaf -> the parameter that
holds it, or the list of parameters that stack into it), and Adafactor
runs on each JAX leaf as JAX shapes it, its state keyed by the JAX
leaf's dotted path. Without ``groups`` every tensor is its own leaf.

AdamW is the default training recipe; Adafactor is used where float32
Adam state cannot fit (deepseek-v3-671b).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

Params = dict[str, torch.Tensor]
Groups = dict[str, "str | list[str]"]

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    clip_rms: float = 1.0


def _grad(grads: Params, name: str, p: torch.Tensor) -> torch.Tensor:
    g = grads.get(name)
    return torch.zeros_like(p) if g is None else g


def _global_norm(grads: Params) -> torch.Tensor:
    total = 0
    for g in grads.values():
        if g is not None:
            total = total + torch.sum(torch.square(g.to(F32)))
    return torch.sqrt(torch.as_tensor(total, dtype=F32))


def _clip_scale(grads: Params, max_norm: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(min(1, max_norm / (norm + 1e-9)), norm), divided tensor by
    tensor (a division by a Python scalar goes through a rounded
    reciprocal)."""
    norm = _global_norm(grads)
    scale = torch.clamp(torch.full_like(norm, max_norm) / (norm + 1e-9),
                        max=1.0)
    return scale, norm


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The clipped gradient as the update reads it: scaled in float32,
    rounded to the gradient's dtype, widened again."""
    return (g.to(F32) * scale).to(g.dtype).to(F32)


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> tuple[Params, torch.Tensor]:
    scale, norm = _clip_scale(grads, max_norm)
    return {k: (g.to(F32) * scale).to(g.dtype) for k, g in grads.items()
            if g is not None}, norm


def _steps(step, device) -> torch.Tensor:
    """``step + 1`` as a float32 0-dim tensor on ``device``."""
    return torch.as_tensor(step, device=device).to(F32) + 1.0


def _device(params: Params) -> torch.device:
    return next(iter(params.values())).device


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@torch.no_grad()
def adamw_init(params: Params, groups: Groups | None = None) -> dict:
    return {"m": {k: torch.zeros(p.shape, dtype=F32, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=F32, device=p.device)
                  for k, p in params.items()},
            "master": {k: p.detach().to(F32, copy=True)
                       for k, p in params.items()}}


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: dict, step,
                 cfg: OptConfig, groups: Groups | None = None):
    scale, norm = _clip_scale(grads, cfg.grad_clip)
    t = _steps(step, _device(params))
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    for name, p in params.items():
        g = _clipped(_grad(grads, name, p), scale)
        m, v, master = (state[k][name] for k in ("m", "v", "master"))
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * g * g)
        del g
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        master.sub_(cfg.lr * (update + cfg.weight_decay * master))
        del update
        p.copy_(master)
    return params, state, norm


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern), simplified: beta1=0, factored v, no master
# ---------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _leaves(params: Params, groups: Groups | None):
    """(JAX leaf key, names, stacked) for every leaf: ``names`` a list of
    the parameters stacked along a new leading axis where ``stacked``."""
    for key, names in (groups or {k: k for k in params}).items():
        if isinstance(names, str):
            yield key, [names], False
        else:
            yield key, list(names), True


def _leaf_shape(params: Params, names: list[str], stacked: bool):
    shape = tuple(params[names[0]].shape)
    return (len(names), *shape) if stacked else shape


@torch.no_grad()
def adafactor_init(params: Params, groups: Groups | None = None) -> dict:
    dev = _device(params)
    v_row, v_col = {}, {}
    for key, names, stacked in _leaves(params, groups):
        shape = _leaf_shape(params, names, stacked)
        if _factored(shape):
            v_row[key] = torch.zeros(shape[:-1], dtype=F32, device=dev)
            v_col[key] = torch.zeros((*shape[:-2], shape[-1]), dtype=F32,
                                     device=dev)
        else:
            v_row[key] = torch.zeros((1,), dtype=F32, device=dev)
            v_col[key] = torch.zeros(shape, dtype=F32, device=dev)
    return {"v_row": v_row, "v_col": v_col}


@torch.no_grad()
def adafactor_update(params: Params, grads: Params, state: dict, step,
                     cfg: OptConfig, groups: Groups | None = None):
    dev = _device(params)
    scale, norm = _clip_scale(grads, cfg.grad_clip)
    t = _steps(step, dev)
    beta2 = 1.0 - t ** (-cfg.decay_rate)
    clip_rms = torch.tensor(cfg.clip_rms, dtype=F32, device=dev)
    for key, names, stacked in _leaves(params, groups):
        ps = [params[n] for n in names]
        gs = [_grad(grads, n, p) for n, p in zip(names, ps)]
        p = torch.stack(ps) if stacked else ps[0]
        g = _clipped(torch.stack(gs) if stacked else gs[0], scale)
        vr, vc = state["v_row"][key], state["v_col"][key]
        g2 = g * g + 1e-30
        if _factored(g.shape):
            vr.copy_(beta2 * vr + (1.0 - beta2) * torch.mean(g2, dim=-1))
            vc.copy_(beta2 * vc + (1.0 - beta2) * torch.mean(g2, dim=-2))
            r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                 min=1e-30)
            update = g / (torch.sqrt(r)[..., None]
                          * torch.sqrt(vc)[..., None, :] + cfg.eps)
        else:
            vc.copy_(beta2 * vc + (1.0 - beta2) * g2)
            update = g / (torch.sqrt(vc) + cfg.eps)
        rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-30)
        update = update / torch.clamp(rms / clip_rms, min=1.0)
        p32 = p.to(F32)
        newp = p32 - cfg.lr * (update + cfg.weight_decay * p32)
        for i, q in enumerate(ps):
            q.copy_(newp[i] if stacked else newp)
    return params, state, norm


# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Optimizer:
    cfg: OptConfig

    def init(self, params: Params, groups: Groups | None = None) -> dict:
        return (adamw_init(params, groups) if self.cfg.name == "adamw"
                else adafactor_init(params, groups))

    def update(self, params: Params, grads: Params, state: dict, step,
               groups: Groups | None = None):
        """Writes the new parameters and state in place; returns
        (params, state, the global grad norm before the clip)."""
        fn = adamw_update if self.cfg.name == "adamw" else adafactor_update
        return fn(params, grads, state, step, self.cfg, groups)


def make_optimizer(name: str, lr: float = 3e-4, **kw: Any) -> Optimizer:
    return Optimizer(OptConfig(name=name, lr=lr, **kw))
