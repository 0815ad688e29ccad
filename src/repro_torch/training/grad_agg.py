"""Straggler-tolerant gradient aggregation (redundancy for training).

The port of ``repro.training.grad_agg``. Synchronous data parallelism
cannot take "first of two" inside one step, so the paper's technique
maps onto training as:

  * **backup microbatches** — dispatch n microbatches where only m are
    required; aggregate whichever m finish first (the host decides the
    mask);
  * **drop-straggler aggregation** — a masked mean over microbatch grads:
    contributions with mask=0 (straggling / failed workers) are excluded
    and the mean is renormalized, keeping the update unbiased w.r.t. the
    included data.

Both reduce to ``masked_grad_mean`` below (static shapes; the mask is
data). This mirrors backup-task execution in Dolly/MapReduce (paper §4)
on the gradient pathway. Gradients are dicts of tensors keyed by
parameter name, each stacked along a leading microbatch axis.
"""
from __future__ import annotations

from typing import Callable

import torch

F32 = torch.float32


def masked_grad_mean(grad_stack: dict[str, torch.Tensor],
                     mask: torch.Tensor) -> dict[str, torch.Tensor]:
    """grad_stack values: (n_micro, ...); mask: (n_micro,) in {0,1}.

    Returns the mean over the included microbatches (renormalized)."""
    m32 = mask.to(F32)
    denom = torch.clamp(torch.sum(m32), min=1.0)

    def agg(g):
        m = m32.reshape((-1,) + (1,) * (g.ndim - 1))
        return (torch.sum(g.to(F32) * m, dim=0) / denom).to(g.dtype)

    return {k: agg(g) for k, g in grad_stack.items()}


def first_m_mask(arrival_order: torch.Tensor, m: int) -> torch.Tensor:
    """Mask selecting the first ``m`` arrivals. arrival_order[i] = rank of
    microbatch i's completion (0 = first)."""
    return (arrival_order < m).to(F32)


def accumulate_microbatch_grads(
        loss_fn: Callable, params: dict[str, torch.Tensor],
        batches: dict[str, torch.Tensor], n_micro: int
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Stack per-microbatch grads: ``batches`` values are (n_micro, ...).

    ``loss_fn(params, microbatch) -> (total, metrics)`` computes on the
    tensors of ``params`` (which require grad); one backward per
    microbatch. Returns (grads stacked (n_micro, ...) per parameter, an
    unused parameter's as zeros; ``metrics["loss"]`` per microbatch)."""
    names = list(params)
    per: dict[str, list[torch.Tensor]] = {n: [] for n in names}
    losses = []
    for i in range(n_micro):
        total, metrics = loss_fn(params, {k: b[i] for k, b in
                                          batches.items()})
        grads = torch.autograd.grad(total, [params[n] for n in names],
                                    allow_unused=True)
        for n, g in zip(names, grads):
            per[n].append(torch.zeros_like(params[n]) if g is None else g)
        losses.append(metrics["loss"].detach())
    return {n: torch.stack(gs) for n, gs in per.items()}, torch.stack(losses)
