"""Shared building blocks: norms, RoPE, MLPs, embeddings, softcap.

The port of ``repro.models.layers``. Parameters live in small
``nn.Module`` containers whose attribute names are the JAX pytree's keys
(``Linear.w``, ``RMSNorm.scale``, ``Embedding.table``), so a state-dict
key names the JAX leaf it holds; the ``apply`` functions keep the JAX
signatures and take such a module where JAX takes a param dict. Params
are stored in ``DEFAULT_PARAM_DTYPE`` (bf16), norm scales in float32;
compute runs in bf16 (the embedding table's dtype: a model widened with
``.float()`` computes in float32) with float32 where the reference uses
it (norms, RoPE, softmax, logits).

Random init draws from the reference's distributions with an explicit
``torch.Generator`` on the target device: the bits differ from JAX's, so
parity tests carry the JAX weights across (``repro_torch.interop``).

In a sharded decode a weight may be this rank's block of it
(``repro_torch.distributed.tp.Split``): ``linear``, ``rows`` and
``logits_from_hidden`` then take it across the ranks.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import tp

DEFAULT_PARAM_DTYPE = torch.bfloat16


def truncated_normal(shape, scale: float, generator: torch.Generator,
                     dtype=DEFAULT_PARAM_DTYPE) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``scale``, drawn in
    float32 on the generator's device and cast to ``dtype`` (as
    ``jax.random.truncated_normal(key, -2, 2, shape, f32) * scale``)."""
    dev = generator.device
    if dev.type == "meta":  # ``MetaGenerator``: shapes only, nothing drawn
        return torch.empty(shape, dtype=dtype, device=dev)
    lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2.0, 2.0))
    x = torch.rand(shape, generator=generator, device=dev,
                   dtype=torch.float32)
    # in place, one float32 buffer: a 256,000 x 8,192 head or a (256,
    # 7168, 2048) expert stack is drawn beside a model that nearly fills
    # the card
    x.mul_(hi - lo).add_(lo).mul_(2.0).sub_(1.0).clamp_(-1.0, 1.0)
    x.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(scale)
    return x.to(dtype)


class MetaGenerator:
    """Stands in for a ``torch.Generator`` where a model is built on
    ``torch.device("meta")``: every init function reads only its
    ``device`` and hands it to ``truncated_normal``, which then draws
    nothing. ``launch/specs.py`` builds full-size models so."""

    device = torch.device("meta")


def frozen(x: torch.Tensor) -> nn.Parameter:
    """``x`` as a parameter without gradient (the port serves only)."""
    return nn.Parameter(x, requires_grad=False)


class Linear(nn.Module):
    """``{"w": (d_in, *out)}`` and an optional bias ``{"b": out}``."""

    def __init__(self, w_shape, use_bias: bool = False, device=None,
                 dtype=DEFAULT_PARAM_DTYPE):
        super().__init__()
        self.w = nn.Parameter(torch.empty(w_shape, device=device, dtype=dtype),
                              requires_grad=False)
        if use_bias:
            self.b = nn.Parameter(torch.zeros(w_shape[1:], device=device,
                                              dtype=dtype),
                                  requires_grad=False)


def init_linear(generator: torch.Generator, d_in: int,
                d_out: int | tuple[int, ...], use_bias: bool = False,
                dtype=DEFAULT_PARAM_DTYPE) -> Linear:
    out = d_out if isinstance(d_out, tuple) else (d_out,)
    p = Linear((d_in, *out), use_bias, generator.device, dtype)
    p.w.copy_(truncated_normal((d_in, *out), d_in**-0.5, generator, dtype))
    return p


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, *out) -> (..., *out)."""
    w = p.w
    if isinstance(w, tp.Split):
        y = tp.linear(x, w)
    else:
        y = torch.matmul(x, w.reshape(w.shape[0], -1).to(x.dtype))
        y = y.reshape(*x.shape[:-1], *w.shape[1:])
    if hasattr(p, "b"):
        y = y + p.b.to(y.dtype)
    return y


class RMSNorm(nn.Module):
    """Gemma-style ``(1 + scale)`` norm; ``scale`` (d,) float32, zeros."""

    def __init__(self, d: int, device=None, dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros((d,), device=device,
                                              dtype=dtype),
                                  requires_grad=False)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + p.scale.to(torch.float32))).to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu2":  # nemotron squared-ReLU
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {name}")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """(head_dim / 2,) float32 ``theta ** (-2i / head_dim)``, computed on
    the CPU once per (head_dim, theta, device) and cached, so a decode
    step copies no scalar to the card (a blocking host-to-device copy)."""
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    return torch.pow(torch.tensor(theta, dtype=torch.float32),
                     exps).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, hd) rotated by per-position angles; positions (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)          # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    angles = angles[..., None, :]                          # over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """``out`` (d_ff, d) and, gated, ``gate``/``up`` (d, d_ff); ungated
    only ``up``."""

    def __init__(self, out: Linear, up: Linear, gate: Linear | None = None):
        super().__init__()
        self.out = out
        self.up = up
        if gate is not None:
            self.gate = gate


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             gated: bool, use_bias: bool = False,
             dtype=DEFAULT_PARAM_DTYPE) -> MLP:
    out = init_linear(generator, d_ff, d_model, use_bias, dtype)
    up = init_linear(generator, d_model, d_ff, use_bias, dtype)
    gate = (init_linear(generator, d_model, d_ff, use_bias, dtype)
            if gated else None)
    return MLP(out, up, gate)


def mlp(p: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    if hasattr(p, "gate"):
        h = activation(act, linear(p.gate, x)) * linear(p.up, x)
    else:
        h = activation(act, linear(p.up, x))
    return linear(p.out, h)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


class Embedding(nn.Module):
    """``table`` (vocab, d), or (K, vocab, d) for K codebooks (audio)."""

    def __init__(self, vocab: int, d: int, device=None,
                 dtype=DEFAULT_PARAM_DTYPE, n_tables: int = 0):
        super().__init__()
        shape = (n_tables, vocab, d) if n_tables else (vocab, d)
        self.table = nn.Parameter(torch.empty(shape, device=device,
                                              dtype=dtype),
                                  requires_grad=False)


def init_embedding(generator: torch.Generator, vocab: int, d: int,
                   dtype=DEFAULT_PARAM_DTYPE, n_tables: int = 0) -> Embedding:
    """A table of standard-normal rows; with ``n_tables`` one (vocab, d)
    table per codebook, stacked."""
    p = Embedding(vocab, d, generator.device, dtype, n_tables)
    for t in (p.table if n_tables else [p.table]):
        t.copy_(truncated_normal((vocab, d), 1.0, generator, dtype))
    return p


def rows(table, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``; of a table split over ranks (``tp.Split``), its
    lookup across them (``tp.rows``)."""
    if isinstance(table, tp.Split):
        return tp.rows(table, ids)
    return table[ids]


def embed(p: Embedding, tokens: torch.Tensor, scale: bool,
          d_model: int) -> torch.Tensor:
    """Rows of the table in its own dtype, which sets the model's compute
    dtype: bf16 as in the reference, float32 for a model widened with
    ``.float()`` (the plain path's float32 yardstick)."""
    x = rows(p.table, tokens)
    if scale:
        # the reference scales by sqrt(d) rounded to bf16; a Python float
        # of that value gives the same single rounding of the product and
        # copies nothing to the card
        x = x * float(torch.tensor(d_model**0.5, dtype=x.dtype))
    return x


# Rows of the head table widened to float32 at a time (512 MB): a whole
# 256,000 x 8,192 table would take 8.4 GB beside the model.
LOGIT_CHUNK_ELEMS = 2**27


def logits_from_hidden(table: torch.Tensor, h: torch.Tensor,
                       final_cap: float | None = None) -> torch.Tensor:
    """h (..., D) @ table.T (V, D) -> (..., V), float32 out: the bf16
    operands are widened exactly and multiplied in float32, as JAX's
    ``preferred_element_type=float32`` product does. ``table`` may be a
    transposed view (an untied head stored (D, V)); it is widened a block
    of rows at a time, so no float32 copy of the whole table is made. A
    ``tp.Split`` table takes ``tp.logits``."""
    if isinstance(table, tp.Split):
        return tp.logits(table, h, final_cap)
    h32 = h.to(torch.float32)
    v, d = table.shape
    rows = max(1, LOGIT_CHUNK_ELEMS // d)
    if rows >= v:
        out = torch.matmul(h32, table.to(torch.float32).t())
    else:
        out = torch.empty((*h.shape[:-1], v), dtype=torch.float32,
                          device=h.device)
        for i in range(0, v, rows):
            out[..., i:i + rows] = torch.matmul(
                h32, table[i:i + rows].to(torch.float32).t())
    return softcap(out, final_cap)


def _ce_chunk(table: torch.Tensor, hc: torch.Tensor, tc: torch.Tensor,
              mc: torch.Tensor, final_cap: float | None,
              n_valid: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of ``chunked_cross_entropy``: the masked sum of the
    chunk's negative log-likelihoods and the sum of its mask."""
    logits = logits_from_hidden(table, hc, final_cap)  # (b, chunk, V) f32
    v = logits.shape[-1]
    if n_valid is not None and n_valid < v:
        # in place: logits_from_hidden's output is saved by no op
        logits.masked_fill_(torch.arange(v, device=logits.device)
                            >= n_valid, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, tc[..., None].long())[..., 0]
    return torch.sum((lse - tgt) * mc), torch.sum(mc)


def chunked_cross_entropy(table: torch.Tensor, h: torch.Tensor,
                          targets: torch.Tensor,
                          mask: torch.Tensor | None = None,
                          chunk: int = 512, final_cap: float | None = None,
                          n_valid: int | None = None) -> torch.Tensor:
    """Next-token CE without materializing the full (B, S, V) logits.

    Walks the sequence in chunks: each computes (B, chunk, V) float32
    logits, their logsumexp and the target's logit. With grad enabled a
    chunk is recomputed in backward (``torch.utils.checkpoint``), so only
    one chunk's logits are alive at a time: at 256,000 words and 4,608
    positions the whole float32 logits would take 4.7 GB.

    ``n_valid``: real vocabulary size when the table is padded (padded
    columns are set to -1e30 before the logsumexp)."""
    total, count = chunked_ce_sums(table, h, targets, mask, chunk,
                                   final_cap, n_valid)
    return total / torch.clamp(count, min=1.0)


def chunked_ce_sums(table: torch.Tensor, h: torch.Tensor,
                    targets: torch.Tensor, mask: torch.Tensor | None = None,
                    chunk: int = 512, final_cap: float | None = None,
                    n_valid: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``chunked_cross_entropy``'s two sums, float32: the masked
    per-position losses and the count of valid targets. A batch split
    over ranks (``repro_torch.distributed``) adds each across the ranks
    before it divides."""
    b, s, _ = h.shape
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by loss chunk {chunk}")
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=h.device)
    mask = mask.to(torch.float32)
    remat = torch.is_grad_enabled() and (h.requires_grad
                                         or table.requires_grad)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, chunk):
        args = (table, h[:, i:i + chunk], targets[:, i:i + chunk],
                mask[:, i:i + chunk], final_cap, n_valid)
        if remat:
            nll, cnt = checkpoint(_ce_chunk, *args, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            nll, cnt = _ce_chunk(*args)
        total = total + nll
        count = count + cnt
    return total, count
