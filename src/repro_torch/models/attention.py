"""GQA attention: global and sliding-window variants, softcap, qk-norm.

The port of ``repro.models.attention``. Where the JAX package picks
``impl="ref"`` (jnp) or ``impl="pallas"``, the port routes through the
kernels' ``ops`` with a ``kernel=`` mode (``repro_torch.kernels.dispatch``):
``"auto"`` launches the CUDA kernels for CUDA tensors and takes their
plain PyTorch versions on the CPU; ``"off"`` takes the plain versions on
any device. The plain versions (``kernels/*/ref.py``) are the arithmetic
of the JAX model's own ``_sdpa`` path, so the model keeps no third copy.

Decode uses either a dense cache (global layers: (B, max_len, KV, hd),
masked by current position) or a ring-buffer cache (local layers: (B,
window, KV, hd)), each with a slot-position vector. Unlike the JAX
package, ``decode_attention`` writes the new token into the cache in
place and returns the same cache dict.

Under a ``ShardCtx`` (sharded serving): a prefill with the sequence
split over ``ctx.seq`` keeps Q as this rank's block of rows and gathers
K and V over ``seq`` (the JAX package's constraint, written out), and
the kernel takes the rows at their global offset over the causal prefix
up to the block's last row (``q_offset``). A decode whose cache slots
are split over ``ctx.kv_seq`` (``sharding.kv_split_axes``) attends over
this rank's slots (``return_lse``) and combines the ranks' partial
softmaxes (``tp.softmax_combine``); only the rank holding the new
token's slot writes it.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed import collectives, tp
from repro_torch.distributed.ctx import ShardCtx, seq_axes
from repro_torch.distributed.sharding import kv_split_axes
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers
from repro_torch.models.layers import (apply_rope, init_linear, linear,
                                       rmsnorm)


class Attention(nn.Module):
    """``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd, d) and,
    with qk-norm, ``q_norm``/``k_norm``."""

    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        if q_norm is not None:
            self.q_norm, self.k_norm = q_norm, k_norm


def init_attention(generator: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, use_bias: bool = False,
                   qk_norm: bool = False,
                   dtype=layers.DEFAULT_PARAM_DTYPE) -> Attention:
    wq = init_linear(generator, d_model, (n_heads, head_dim), use_bias, dtype)
    wk = init_linear(generator, d_model, (n_kv, head_dim), use_bias, dtype)
    wv = init_linear(generator, d_model, (n_kv, head_dim), use_bias, dtype)
    wo = layers.Linear((n_heads, head_dim, d_model), use_bias=False,
                       device=generator.device, dtype=dtype)
    wo.w.copy_(layers.truncated_normal(
        (n_heads, head_dim, d_model), (n_heads * head_dim) ** -0.5,
        generator, dtype))
    norms = ((layers.RMSNorm(head_dim, generator.device),
              layers.RMSNorm(head_dim, generator.device))
             if qk_norm else (None, None))
    return Attention(wq, wk, wv, wo, *norms)


def _project_qkv(p: Attention, x: torch.Tensor, positions: torch.Tensor,
                 rope_theta: float, qk_norm: bool, eps: float):
    q = linear(p.wq, x)            # (B, S, H, hd)
    k = linear(p.wk, x)            # (B, S, KV, hd)
    v = linear(p.wv, x)
    if qk_norm:
        q = rmsnorm(p.q_norm, q, eps)
        k = rmsnorm(p.k_norm, k, eps)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _out_proj(p: Attention, out: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) x wo (H, hd, d) -> (B, S, d)."""
    if isinstance(p.wo.w, tp.Split):
        return tp.einsum("bshd,hdm->bsm", out, p.wo.w)
    b, s, h, hd = out.shape
    w = p.wo.w.to(out.dtype).reshape(h * hd, -1)
    return torch.matmul(out.reshape(b, s, h * hd), w)


def attention(p: Attention, x: torch.Tensor, positions: torch.Tensor, *,
              kind: str, window: int, rope_theta: float,
              attn_softcap: float | None = None,
              qk_norm: bool = False, eps: float = 1e-6,
              kernel: str = "auto", return_kv: bool = False,
              ctx: ShardCtx | None = None):
    """Causal self-attention over a full sequence (prefill, and the
    training loss). Head counts and width are read off the projections'
    shapes. Under a ctx whose ``seq`` splits the sequence, ``x`` is this
    rank's block of rows at the global ``positions`` and the K and V
    returned are the whole sequence's: they are gathered over ``seq``
    with ``collectives.gather``, whose backward sums over the ranks the
    gradients that every rank's queries give each block of keys and
    values and scatters each rank its own (a gather without autograd
    would drop all but the rank's own queries' share)."""
    q, k, v = _project_qkv(p, x, positions, rope_theta, qk_norm, eps)
    w = window if kind == "local" else None
    axes, offset = seq_axes(ctx), 0
    if axes:
        k = collectives.gather(k, ctx.mesh, axes, 1)
        v = collectives.gather(v, ctx.mesh, axes, 1)
        offset = tp.axes_index(ctx.mesh, axes) * q.shape[1]
        end = offset + q.shape[1]
        out = fa_ops.flash_attention(
            q, k[:, :end].contiguous(), v[:, :end].contiguous(), window=w,
            softcap=attn_softcap, q_offset=offset, kernel=kernel)
    else:
        out = fa_ops.flash_attention(q, k, v, window=w,
                                     softcap=attn_softcap, kernel=kernel)
    y = _out_proj(p, out)
    if return_kv:
        return y, (k, v)
    return y


# ---------------------------------------------------------------------------
# Decode (single new token against a cache)
# ---------------------------------------------------------------------------


def init_cache(batch: int, kind: str, max_len: int, window: int, n_kv: int,
               head_dim: int, dtype=torch.bfloat16,
               device=None) -> dict[str, torch.Tensor]:
    """Dense cache for global layers, ring buffer for local layers."""
    length = window if kind == "local" else max_len
    return {
        "k": torch.zeros((batch, length, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, length, n_kv, head_dim), dtype=dtype,
                         device=device),
        # position stored in each slot; -1 = empty. Ring for local layers.
        "pos": torch.full((length,), -1, dtype=torch.int32, device=device),
    }


def decode_attention(p: Attention, x: torch.Tensor,
                     cache: dict[str, torch.Tensor], pos: int, *, kind: str,
                     window: int, rope_theta: float,
                     attn_softcap: float | None = None,
                     qk_norm: bool = False, eps: float = 1e-6,
                     kernel: str = "auto", ctx: ShardCtx | None = None
                     ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One decode step. x (B, 1, D); ``pos`` the current position. Writes
    the new key and value into ``cache`` in place and returns it. Under a
    ctx, ``cache["k"]``/``["v"]`` may be this rank's block of the slots
    (``cache["pos"]`` is always whole)."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, positions, rope_theta, qk_norm, eps)

    length = cache["pos"].shape[0]
    if kind != "local" and pos >= length:
        raise ValueError(f"position {pos} is past the dense cache's "
                         f"max_len={length}")
    # the modulo is the identity on a dense cache; ring buffers (local
    # layers) wrap.
    slot = pos % length
    block = cache["k"].shape[1]
    axes, lo = (), 0
    if block != length:
        axes = kv_split_axes(ctx.kv_seq, ctx.mesh, length)
        lo = tp.axes_index(ctx.mesh, axes) * block
    if lo <= slot < lo + block:  # this rank holds the new token's slot
        cache["k"][:, slot - lo] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot - lo] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = pos
    w = window if kind == "local" else None
    if not axes:
        out = da_ops.decode_attention(
            q, cache["k"], cache["v"], cache["pos"], pos, window=w,
            softcap=attn_softcap, kernel=kernel)
        return _out_proj(p, out), cache
    out, lse = da_ops.decode_attention(
        q, cache["k"], cache["v"], cache["pos"][lo:lo + block], pos,
        window=w, softcap=attn_softcap, return_lse=True, kernel=kernel)
    out = tp.softmax_combine(out, lse, ctx.mesh, axes, q.dtype)
    return _out_proj(p, out), cache
