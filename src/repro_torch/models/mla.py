"""DeepSeek-V3 Multi-head Latent Attention (MLA).

The port of ``repro.models.mla``. Prefill expands the factorised
projections to per-head keys and values and runs plain causal attention,
as the JAX package serves it (``impl="ref"``): its flash-attention route
would give the values the queries' head dim of 192, so no kernel takes
this attention. Decode runs the ABSORBED form: the cache holds only the
compressed latent (``c_kv``, ``k_rope``) per position, and the
up-projections fold into the query and output sides.

Unlike the JAX package, ``mla_decode`` writes the new latent into the
cache in place and returns the same cache dict. Under a ctx whose
``kv_seq`` splits the latent cache's slots (sharded serving), each rank
attends over its own slots and the ranks combine their partial
softmaxes (``tp.softmax_combine``); the absorbed projections read their
weights in place (``tp.einsum``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import MLAConfig
from repro_torch.distributed import tp
from repro_torch.distributed.ctx import ShardCtx, kv_axes
from repro_torch.models import layers
from repro_torch.models.layers import apply_rope, init_linear, linear, rmsnorm

NEG_INF = -2.0e38


class MLA(nn.Module):
    """``wdq`` (D, q_lora), ``q_norm``, ``wuq`` (q_lora, H, nope + rope),
    ``wdkv`` (D, kv_lora + rope), ``kv_norm``, ``wuk`` (kv_lora, H, nope),
    ``wuv`` (kv_lora, H, v_dim), ``wo`` (H, v_dim, D) — the JAX tree's
    keys."""

    def __init__(self, wdq, q_norm, wuq, wdkv, kv_norm, wuk, wuv, wo):
        super().__init__()
        self.wdq, self.q_norm, self.wuq = wdq, q_norm, wuq
        self.wdkv, self.kv_norm = wdkv, kv_norm
        self.wuk, self.wuv, self.wo = wuk, wuv, wo


def init_mla(generator: torch.Generator, d_model: int, n_heads: int,
             cfg: MLAConfig, dtype=layers.DEFAULT_PARAM_DTYPE) -> MLA:
    dev = generator.device
    qk_head = cfg.qk_nope_dim + cfg.qk_rope_dim
    wo = layers.Linear((n_heads, cfg.v_head_dim, d_model), device=dev,
                       dtype=dtype)
    wo.w.copy_(layers.truncated_normal(
        (n_heads, cfg.v_head_dim, d_model),
        (n_heads * cfg.v_head_dim) ** -0.5, generator, dtype))
    return MLA(
        wdq=init_linear(generator, d_model, cfg.q_lora_rank, dtype=dtype),
        q_norm=layers.RMSNorm(cfg.q_lora_rank, dev),
        wuq=init_linear(generator, cfg.q_lora_rank, (n_heads, qk_head),
                        dtype=dtype),
        # joint down-projection: [c_kv | k_rope]
        wdkv=init_linear(generator, d_model,
                         cfg.kv_lora_rank + cfg.qk_rope_dim, dtype=dtype),
        kv_norm=layers.RMSNorm(cfg.kv_lora_rank, dev),
        wuk=init_linear(generator, cfg.kv_lora_rank,
                        (n_heads, cfg.qk_nope_dim), dtype=dtype),
        wuv=init_linear(generator, cfg.kv_lora_rank,
                        (n_heads, cfg.v_head_dim), dtype=dtype),
        wo=wo)


def _queries(p: MLA, x: torch.Tensor, positions: torch.Tensor,
             cfg: MLAConfig, rope_theta: float, eps: float):
    cq = rmsnorm(p.q_norm, linear(p.wdq, x), eps)
    q = linear(p.wuq, cq)  # (B, S, H, nope + rope)
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_dim:], positions, rope_theta)
    return q_nope, q_rope


def _latents(p: MLA, x: torch.Tensor, positions: torch.Tensor,
             cfg: MLAConfig, rope_theta: float, eps: float):
    dkv = linear(p.wdkv, x)  # (B, S, kv_lora + rope)
    c_kv = rmsnorm(p.kv_norm, dkv[..., :cfg.kv_lora_rank], eps)
    k_rope = dkv[..., cfg.kv_lora_rank:][..., None, :]  # (B, S, 1, rope)
    k_rope = apply_rope(k_rope, positions, rope_theta)[..., 0, :]
    return c_kv, k_rope


def _out_proj(p: MLA, out: torch.Tensor) -> torch.Tensor:
    """(B, S, H, v_dim) x wo (H, v_dim, D) -> (B, S, D)."""
    if isinstance(p.wo.w, tp.Split):
        return tp.einsum("bshv,hvm->bsm", out, p.wo.w)
    b, s, h, dv = out.shape
    return torch.matmul(out.reshape(b, s, h * dv),
                        p.wo.w.to(out.dtype).reshape(h * dv, -1))


def mla_attention(p: MLA, x: torch.Tensor, positions: torch.Tensor, *,
                  cfg: MLAConfig, rope_theta: float, eps: float = 1e-6,
                  return_kv: bool = False):
    """Full-sequence causal MLA (prefill), expanded form: float32 scores
    of the bf16 operands, masked, a float32 softmax whose probabilities
    are rounded to the values' dtype before the value product."""
    b, s, _ = x.shape
    q_nope, q_rope = _queries(p, x, positions, cfg, rope_theta, eps)
    c_kv, k_rope = _latents(p, x, positions, cfg, rope_theta, eps)
    k_nope = linear(p.wuk, c_kv)   # (B, S, H, nope)
    v = linear(p.wuv, c_kv)        # (B, S, H, v_dim)
    h = k_nope.shape[2]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, cfg.qk_rope_dim)], dim=-1)
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    scores = torch.einsum("bqhd,bshd->bhqs", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    i = torch.arange(s, device=x.device)
    scores.masked_fill_(i[None, :] > i[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    del scores
    out = torch.einsum("bhqs,bshd->bqhd", probs, v)
    y = _out_proj(p, out)
    if return_kv:
        return y, (c_kv, k_rope)
    return y


# ---------------------------------------------------------------------------
# Absorbed decode
# ---------------------------------------------------------------------------


def init_mla_cache(batch: int, max_len: int, cfg: MLAConfig,
                   dtype=torch.bfloat16, device=None) -> dict:
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
    }


def mla_cache_from_latents(c_kv: torch.Tensor, k_rope: torch.Tensor,
                           max_len: int) -> dict:
    """The latent cache of a prefill: positions 0..S-1 filled, in bf16."""
    b, s = c_kv.shape[:2]
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens is longer than "
                         f"max_len={max_len}")
    cache = {}
    for name, lat in (("c_kv", c_kv), ("k_rope", k_rope)):
        buf = torch.zeros((b, max_len, lat.shape[-1]), dtype=torch.bfloat16,
                          device=lat.device)
        buf[:, :s] = lat.to(torch.bfloat16)
        cache[name] = buf
    return cache


def _absorb(eq: str, x: torch.Tensor, w) -> torch.Tensor:
    """``einsum(eq, x, w)`` in ``x``'s dtype, ``w`` whole or in place."""
    if isinstance(w, tp.Split):
        return tp.einsum(eq, x, w)
    return torch.einsum(eq, x, w.to(x.dtype))


def mla_decode(p: MLA, x: torch.Tensor, cache: dict, pos: int, *,
               cfg: MLAConfig, rope_theta: float, eps: float = 1e-6,
               ctx: ShardCtx | None = None) -> tuple[torch.Tensor, dict]:
    """One decode step in absorbed form. x (B, 1, D); writes the new
    latent at ``pos`` in place and returns (y (B, 1, D), the cache).
    Under a ctx with ``kv_seq``, the latent cache is this rank's block
    of its slots over ``kv_seq`` (``cache_spec``'s split where ``kv_seq``
    divides the length: a latent cache carries no slot vector that would
    say otherwise)."""
    b = x.shape[0]
    block = cache["c_kv"].shape[1]
    axes = kv_axes(ctx)
    lo = tp.axes_index(ctx.mesh, axes) * block if axes else 0
    length = block * (tp.axes_size(ctx.mesh, axes) if axes else 1)
    if pos >= length:
        raise ValueError(f"position {pos} is past the latent cache's "
                         f"max_len={length}")
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _queries(p, x, positions, cfg, rope_theta, eps)
    c_new, kr_new = _latents(p, x, positions, cfg, rope_theta, eps)
    if lo <= pos < lo + block:  # this rank holds the new latent's slot
        cache["c_kv"][:, pos - lo] = c_new[:, 0].to(cache["c_kv"].dtype)
        cache["k_rope"][:, pos - lo] = kr_new[:, 0].to(cache["k_rope"].dtype)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]

    # absorb W_uk into the query: q_c (B, 1, H, kv_lora); wuk w is (c, h, d)
    q_c = _absorb("bqhd,chd->bqhc", q_nope, p.wuk.w)
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    scores = (torch.einsum("bqhc,bsc->bhqs", q_c.to(torch.float32),
                           c_kv.to(torch.float32))
              + torch.einsum("bqhr,bsr->bhqs", q_rope.to(torch.float32),
                             k_rope.to(torch.float32))) * scale
    s_idx = torch.arange(lo, lo + block, device=x.device)
    scores.masked_fill_(s_idx > pos, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    # attend in latent space, then apply W_uv and W_o
    if axes:
        # this rank's slots: its output in float32 and its log-sum-exp
        # (-inf where it holds no live slot), combined across the ranks
        live = bool(lo <= pos)
        out_c = torch.einsum("bhqs,bsc->bqhc", probs.to(torch.float32),
                             c_kv.to(torch.float32))
        lse = torch.logsumexp(scores, dim=-1)[:, :, 0]       # (B, H)
        if not live:
            out_c, lse = torch.zeros_like(out_c), torch.full_like(
                lse, -torch.inf)
        out_c = tp.softmax_combine(out_c, lse, ctx.mesh, axes, x.dtype)
    else:
        out_c = torch.einsum("bhqs,bsc->bqhc", probs, c_kv.to(probs.dtype))
    out = _absorb("bqhc,chd->bqhd", out_c,  # wuv w is (c, h, v_dim)
                  p.wuv.w)
    return _out_proj(p, out), cache
