"""Mamba-2 block: state-space duality (SSD), chunked full-sequence path.

The port of ``repro.models.ssd``. Per-head scalar-decay SSM:
    h_t = exp(dt_t * A) h_{t-1} + dt_t * (x_t outer B_t)     h: (P, N)
    y_t = h_t @ C_t + D * x_t

Prefill uses the SSD chunked algorithm: the sequence is split into chunks
of Q tokens; within a chunk the output is an attention-like quadratic term
(the "duality"), computed by the ``ssd_scan`` op (``kernel=``,
``repro_torch.kernels.dispatch``: under ``"auto"`` a CUDA tensor launches
the CUDA kernel, a CPU tensor takes the plain version); across chunks a
Python loop carries the (H, P, N) state, in plain PyTorch as the JAX
package computes it outside its kernel. ``ssd_reference`` is the exact
sequential recurrence, the oracle of both.

Decode carries ``{conv {x, bc} (bf16), h (B, H, P, N) float32}`` — O(1)
per token — and updates that dict in place.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import layers
from repro_torch.models.layers import frozen, init_linear, linear
from repro_torch.models.rglru import causal_conv1d


def dims(d_model: int, cfg: SSMConfig) -> tuple[int, int]:
    d_inner = cfg.expand * d_model
    n_heads = d_inner // cfg.head_dim
    return d_inner, n_heads


class SSD(nn.Module):
    """The JAX tree's keys: ``z_proj``/``x_proj`` (d, d_inner),
    ``bc_proj`` (d, 2N), ``dt_proj`` (d, H), depthwise convs
    ``conv_x_w``/``conv_x_b`` and ``conv_bc_w``/``conv_bc_b``, float32
    ``dt_bias``/``a_log``/``d_skip`` (H,), the gated ``norm`` and
    ``out_proj`` (d_inner, d)."""

    def __init__(self, z_proj, x_proj, bc_proj, dt_proj, conv_x_w, conv_x_b,
                 conv_bc_w, conv_bc_b, dt_bias, a_log, d_skip, norm,
                 out_proj):
        super().__init__()
        self.z_proj, self.x_proj = z_proj, x_proj
        self.bc_proj, self.dt_proj = bc_proj, dt_proj
        self.conv_x_w, self.conv_x_b = frozen(conv_x_w), frozen(conv_x_b)
        self.conv_bc_w, self.conv_bc_b = frozen(conv_bc_w), frozen(conv_bc_b)
        self.dt_bias, self.a_log = frozen(dt_bias), frozen(a_log)
        self.d_skip = frozen(d_skip)
        self.norm, self.out_proj = norm, out_proj


def init_ssd_block(generator: torch.Generator, d_model: int, cfg: SSMConfig,
                   dtype=layers.DEFAULT_PARAM_DTYPE) -> SSD:
    d_inner, n_heads = dims(d_model, cfg)
    dev = generator.device
    tn = layers.truncated_normal
    z_proj = init_linear(generator, d_model, d_inner, dtype=dtype)
    x_proj = init_linear(generator, d_model, d_inner, dtype=dtype)
    bc_proj = init_linear(generator, d_model, 2 * cfg.d_state, dtype=dtype)
    dt_proj = init_linear(generator, d_model, n_heads, dtype=dtype)
    conv_x_w = tn((cfg.d_conv, d_inner), cfg.d_conv**-0.5, generator, dtype)
    conv_bc_w = tn((cfg.d_conv, 2 * cfg.d_state), cfg.d_conv**-0.5,
                   generator, dtype)
    out_proj = init_linear(generator, d_inner, d_model, dtype=dtype)

    def full(n, value, dt=torch.float32):
        return torch.full((n,), value, dtype=dt, device=dev)

    return SSD(z_proj, x_proj, bc_proj, dt_proj, conv_x_w,
               full(d_inner, 0.0, dtype), conv_bc_w,
               full(2 * cfg.d_state, 0.0, dtype), full(n_heads, 0.0),
               full(n_heads, 0.0),  # A = -exp(a_log)
               full(n_heads, 1.0), layers.RMSNorm(d_inner, dev), out_proj)


def _prep(p: SSD, x: torch.Tensor, cfg: SSMConfig,
          conv_state: dict[str, torch.Tensor] | None):
    """Shared front end: projections, convs, activations."""
    d_model = x.shape[-1]
    d_inner, n_heads = dims(d_model, cfg)
    z = linear(p.z_proj, x)
    xs = linear(p.x_proj, x)
    bc = linear(p.bc_proj, x)
    dt = linear(p.dt_proj, x)
    cs_x = conv_state["x"] if conv_state else None
    cs_bc = conv_state["bc"] if conv_state else None
    xs, new_cs_x = causal_conv1d(p.conv_x_w, p.conv_x_b, xs, cs_x)
    bc, new_cs_bc = causal_conv1d(p.conv_bc_w, p.conv_bc_b, bc, cs_bc)
    xs = F.silu(xs)
    bc = F.silu(bc)
    b = bc[..., :cfg.d_state]
    c = bc[..., cfg.d_state:]
    dt = F.softplus(dt.to(torch.float32) + p.dt_bias)           # (B, L, H)
    a = -torch.exp(p.a_log)                                     # (H,)
    bsz, length = x.shape[:2]
    xh = xs.reshape(bsz, length, n_heads, cfg.head_dim)
    new_conv = {"x": new_cs_x, "bc": new_cs_bc}
    return z, xs, xh, b, c, dt, a, new_conv, d_inner


def ssd_reference(xh: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  dt: torch.Tensor, a: torch.Tensor,
                  h0: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact sequential recurrence (the oracle). xh (B, L, H, P), b/c (B,
    L, N), dt (B, L, H), a (H,). Returns (y (B, L, H, P), final state (B,
    H, P, N)), float32."""
    bsz, length, n_heads, hd = xh.shape
    n = b.shape[-1]
    f32 = torch.float32
    h = (torch.zeros((bsz, n_heads, hd, n), dtype=f32, device=xh.device)
         if h0 is None else h0)
    xh, b, c = xh.to(f32), b.to(f32), c.to(f32)
    ys = []
    for t in range(length):
        dtt = dt[:, t]                                          # (B, H)
        decay = torch.exp(dtt * a[None, :])
        upd = (dtt[..., None, None] * xh[:, t][..., None]
               * b[:, t][:, None, None, :])                     # (B,H,P,N)
        h = decay[..., None, None] * h + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, c[:, t]))
    return torch.stack(ys, dim=1), h


def ssd_chunked(xh: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                dt: torch.Tensor, a: torch.Tensor, chunk: int,
                h0: torch.Tensor | None = None, *, kernel: str = "auto"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD chunked algorithm. Same contract as ``ssd_reference``; the
    intra-chunk term goes through the ``ssd_scan`` op."""
    bsz, length, n_heads, hd = xh.shape
    n = b.shape[-1]
    q = chunk
    orig_len = length
    if length % q:
        # pad to a chunk multiple: dt=0 => decay=1 and no state update, so
        # padded steps are identity on the state and sliced off the output.
        pad = q - length % q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        length += pad
    nc = length // q
    f32 = torch.float32

    xc = xh.reshape(bsz, nc, q, n_heads, hd).to(f32)
    bc = b.reshape(bsz, nc, q, n).to(f32)
    cc = c.reshape(bsz, nc, q, n).to(f32)
    dtc = dt.reshape(bsz, nc, q, n_heads)

    log_decay = dtc * a[None, None, None, :]                    # < 0
    cum = torch.cumsum(log_decay, dim=2)                        # inclusive
    total = cum[:, :, -1:]                                      # (B,NC,1,H)
    y_intra, states = ssd_ops.ssd_intra_chunk(xc, bc, cc, dtc, cum,
                                              kernel=kernel)

    # inter-chunk scan over the (small) per-chunk states
    h = (torch.zeros((bsz, n_heads, hd, n), dtype=f32, device=xh.device)
         if h0 is None else h0)
    chunk_decay = torch.exp(total[:, :, 0])                     # (B,NC,H)
    h_prev = []
    for i in range(nc):
        h_prev.append(h)                                        # BEFORE
        h = chunk_decay[:, i][..., None, None] * h + states[:, i]
    h_prev = torch.stack(h_prev, dim=1)                         # (B,NC,H,P,N)

    # inter-chunk contribution: y += exp(cum_q) * C_q . h_prev
    y_inter = torch.einsum("bcqh,bcqn,bchpn->bcqhp", torch.exp(cum), cc,
                           h_prev)
    y = (y_intra + y_inter).reshape(bsz, length, n_heads, hd)
    return y[:, :orig_len], h


def _finish(p: SSD, z: torch.Tensor, xs: torch.Tensor, y_flat: torch.Tensor,
            cfg: SSMConfig) -> torch.Tensor:
    """Skip connection, gating, norm, out projection."""
    y = y_flat + xs * torch.repeat_interleave(
        p.d_skip, cfg.head_dim).to(xs.dtype)
    f32 = torch.float32
    y = layers.rmsnorm(p.norm, (y.to(f32) * F.silu(z.to(f32))).to(z.dtype))
    return linear(p.out_proj, y)


def ssd_block(p: SSD, x: torch.Tensor, cfg: SSMConfig, *,
              kernel: str = "auto", return_state: bool = False):
    """Full-sequence Mamba-2 mixer. x (B, L, D)."""
    z, xs, xh, b, c, dt, a, new_conv, d_inner = _prep(p, x, cfg, None)
    y, h_final = ssd_chunked(xh, b, c, dt, a, cfg.chunk, kernel=kernel)
    y_flat = y.reshape(*x.shape[:2], d_inner).to(x.dtype)
    out = _finish(p, z, xs, y_flat, cfg)
    if return_state:
        return out, {"conv": new_conv, "h": h_final}
    return out


def init_ssd_cache(batch: int, d_model: int, cfg: SSMConfig,
                   device=None) -> dict:
    d_inner, n_heads = dims(d_model, cfg)
    bf16 = torch.bfloat16
    return {
        "conv": {
            "x": torch.zeros((batch, cfg.d_conv - 1, d_inner), dtype=bf16,
                             device=device),
            "bc": torch.zeros((batch, cfg.d_conv - 1, 2 * cfg.d_state),
                              dtype=bf16, device=device),
        },
        "h": torch.zeros((batch, n_heads, cfg.head_dim, cfg.d_state),
                         dtype=torch.float32, device=device),
    }


def ssd_decode(p: SSD, x: torch.Tensor, cache: dict, cfg: SSMConfig
               ) -> tuple[torch.Tensor, dict]:
    """One-token step. x (B, 1, D). Puts the new conv states and ``h``
    into ``cache`` and returns it."""
    z, xs, xh, b, c, dt, a, new_conv, d_inner = _prep(p, x, cfg,
                                                      cache["conv"])
    f32 = torch.float32
    decay = torch.exp(dt[:, 0] * a[None, :])                    # (B, H)
    upd = (dt[:, 0][..., None, None] * xh[:, 0][..., None].to(f32)
           * b[:, 0][:, None, None, :].to(f32))
    h = decay[..., None, None] * cache["h"] + upd
    y = torch.einsum("bhpn,bn->bhp", h, c[:, 0].to(f32))
    y_flat = y.reshape(x.shape[0], 1, d_inner).to(x.dtype)
    cache["conv"].update(new_conv)
    cache["h"] = h
    return _finish(p, z, xs, y_flat, cfg), cache
