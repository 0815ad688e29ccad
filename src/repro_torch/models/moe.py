"""Mixture-of-Experts MLP: top-k routing, static capacity, shared experts.

The port of ``repro.models.moe``. Expert weights are (E, D, F) tensors;
``moe_mlp`` runs a LOCAL slice of experts ``[e_start, e_start +
e_local)`` with the FULL router, so that expert parallelism (ROADMAP
queue 1 item 14e) can shard it as the JAX package's ``shard_map`` does;
on one device ``e_start=0, e_local=E``.

Dispatch is the sort-free masked-capacity scheme of the JAX package:
each token's position in its expert's queue is a cumsum over tokens in
order, tokens past the capacity are dropped, padded experts (granite 40
-> 48) are masked to -1e30 in the router. Routing runs in float32. The
expert products are batched matmuls (``torch.bmm``), as the JAX package
computes them outside any Pallas kernel.

Top-k order: ``lax.top_k`` returns the largest values first and, among
equal values, the lower index first. ``route`` takes the first k of a
stable descending sort, which orders ties the same way.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers
from repro_torch.models.layers import activation, init_mlp, mlp


class MoE(nn.Module):
    """``router.w`` (D, E) float32, ``w_up``/``w_gate`` (E, D, F),
    ``w_out`` (E, F, D) and, with shared experts, ``shared`` (an MLP) —
    the JAX tree's keys."""

    def __init__(self, router: layers.Linear, w_up, w_out, w_gate=None,
                 shared: layers.MLP | None = None):
        super().__init__()
        self.router = router
        self.w_up = layers.frozen(w_up)
        self.w_out = layers.frozen(w_out)
        if w_gate is not None:
            self.w_gate = layers.frozen(w_gate)
        if shared is not None:
            self.shared = shared


def init_moe(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             gated: bool, dtype=layers.DEFAULT_PARAM_DTYPE) -> MoE:
    e, f = cfg.padded_experts, cfg.d_expert
    router = layers.Linear((d_model, e), device=generator.device,
                           dtype=torch.float32)
    router.w.copy_(layers.truncated_normal((d_model, e), d_model**-0.5,
                                           generator, torch.float32))

    def draw(shape, fan_in):
        return layers.truncated_normal(shape, fan_in**-0.5, generator, dtype)

    w_up = draw((e, d_model, f), d_model)
    w_out = draw((e, f, d_model), f)
    w_gate = draw((e, d_model, f), d_model) if gated else None
    shared = None
    if cfg.n_shared:
        d_sh = (cfg.d_shared or cfg.d_expert) * cfg.n_shared
        shared = init_mlp(generator, d_model, d_sh, gated, dtype=dtype)
    return MoE(router, w_up, w_out, w_gate, shared)


def router_logits(router_w: torch.Tensor, xt: torch.Tensor,
                  cfg: MoEConfig) -> torch.Tensor:
    """(T, D) -> (T, E) float32 router logits, padded experts at -1e30."""
    e = cfg.padded_experts
    logits = torch.matmul(xt.to(torch.float32), router_w)
    if e != cfg.n_experts:
        pad = torch.arange(e, device=xt.device) >= cfg.n_experts
        logits = torch.where(pad[None, :], -1e30, logits)
    return logits


def combine(logits: torch.Tensor, idx: torch.Tensor, cfg: MoEConfig):
    """The combine weights (T, k) float32 of the chosen experts ``idx``
    (T, k), the (T, E) 0/1 routing mask and the aux load-balance loss."""
    weights = torch.softmax(torch.gather(logits, 1, idx), dim=-1)
    token_mask = F.one_hot(idx, cfg.padded_experts).to(torch.float32).sum(
        dim=1)
    probs_full = torch.softmax(logits, dim=-1)
    aux = cfg.aux_loss_weight * cfg.n_experts * torch.sum(
        token_mask.mean(dim=0) * probs_full.mean(dim=0))
    return weights, token_mask, aux


def route(router_w: torch.Tensor, xt: torch.Tensor, cfg: MoEConfig):
    """(T, D) -> top-k indices (T, k) int64, combine weights (T, k)
    float32, the (T, E) 0/1 routing mask and the aux loss."""
    logits = router_logits(router_w, xt, cfg)
    _, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    idx = idx[:, :cfg.top_k]
    return (idx, *combine(logits, idx, cfg))


def expert_capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots per expert: ``max(1, int(T k / E capacity_factor))``."""
    return max(1, int(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))


def moe_mlp(p: MoE, x: torch.Tensor, cfg: MoEConfig, act: str, *,
            e_start: int = 0, e_local: int | None = None,
            capacity: int | None = None, out_dtype=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE over a local slice of experts. x (..., D) -> (y, aux).

    ``p.w_up``/``w_gate``/``w_out`` hold only the local experts (leading
    dim ``e_local``); ``p.router`` is always the full router.
    ``out_dtype``: the dtype of the sum over a token's k choices (default
    ``x``'s); expert parallelism takes it in float32, so that the partial
    sums of several ranks are added before the one rounding that the
    one-device sum makes."""
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    e = cfg.padded_experts
    e_local = e_local if e_local is not None else e
    k = cfg.top_k

    idx, weights, token_mask, aux = route(p.router.w, xt, cfg)

    cap = capacity or expert_capacity(t, cfg)
    # position of each token within its expert's queue (over ALL experts,
    # so the capacity accounting does not depend on the slice)
    pos_in_e = (torch.cumsum(token_mask, dim=0) - 1.0) * token_mask
    pos = torch.gather(pos_in_e, 1, idx).to(torch.int64)        # (T, k)
    keep = pos < cap

    # keep only the assignments routed to local experts
    local = (idx >= e_start) & (idx < e_start + e_local) & keep
    flat_e = torch.where(local, idx - e_start, e_local).reshape(-1)
    flat_pos = torch.where(local, pos, cap).reshape(-1)

    buf = torch.zeros((e_local + 1, cap + 1, d), dtype=x.dtype,
                      device=x.device)
    src = torch.repeat_interleave(xt, k, dim=0)                   # (T k, D)
    buf.index_put_((flat_e, flat_pos), src, accumulate=True)
    buf = buf[:e_local, :cap]                                     # (E_l, C, D)

    w_up = p.w_up.to(buf.dtype)
    if hasattr(p, "w_gate"):
        h = activation(act, torch.bmm(buf, p.w_gate.to(buf.dtype)))
        h = h * torch.bmm(buf, w_up)
    else:
        h = activation(act, torch.bmm(buf, w_up))
    out_buf = torch.bmm(h, p.w_out.to(h.dtype))                  # (E_l, C, D)

    w_flat = (weights * local).reshape(-1).to(out_buf.dtype)
    gathered = out_buf[torch.clamp(flat_e, max=e_local - 1),
                       torch.clamp(flat_pos, max=cap - 1)]        # (T k, D)
    y = torch.sum((gathered * w_flat[:, None]).reshape(t, k, d), dim=1,
                  dtype=out_dtype)

    if hasattr(p, "shared"):  # shared expert(s): dense, every token
        y = y + mlp(p.shared, xt, act)
    return y.reshape(shape), aux
