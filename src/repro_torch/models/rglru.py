"""RecurrentGemma / Griffin recurrent block: conv1d + RG-LRU + gated output.

The port of ``repro.models.rglru``. Block structure (Griffin recurrent
block):
    x -> [linear -> GeLU]                          (gate branch)
      -> [linear -> causal conv1d(w=4) -> RG-LRU]  (recurrent branch)
    y  = gate * recurrent  -> linear out

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          input gate
    a_t = exp(c * softplus(Lambda) * (-r_t))   in (0, 1)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full-sequence path runs the recurrence through the ``rglru_scan`` op
(``kernel=``, ``repro_torch.kernels.dispatch``): under ``"auto"`` a CUDA
tensor launches the CUDA kernel, a CPU tensor takes the plain sequential
version. Decode carries ``{conv (B, cw-1, W) bf16, h (B, W) float32}``
and updates that dict in place. ``causal_conv1d`` is shared with the SSD
block (``repro_torch.models.ssd``), as in the JAX package.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import RGLRUConfig
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan.ref import linear_scan_ref
from repro_torch.models import layers
from repro_torch.models.layers import frozen, init_linear, linear

N_GATE_BLOCKS = 16  # block-diagonal gates, as in the JAX package


class RGLRU(nn.Module):
    """The JAX tree's keys: ``in_gate``/``in_rec`` (d, W), ``conv_w`` (cw,
    W), ``conv_b`` (W,), block-diagonal gates ``wa``/``wx`` (nb, W/nb,
    W/nb) with ``ba``/``bx`` (nb, W/nb), ``lam`` (W,) float32 and ``out``
    (W, d)."""

    def __init__(self, in_gate, in_rec, conv_w, conv_b, wa, ba, wx, bx, lam,
                 out):
        super().__init__()
        self.in_gate, self.in_rec, self.out = in_gate, in_rec, out
        self.conv_w, self.conv_b = frozen(conv_w), frozen(conv_b)
        self.wa, self.ba = frozen(wa), frozen(ba)
        self.wx, self.bx = frozen(wx), frozen(bx)
        self.lam = frozen(lam)


def init_rglru_block(generator: torch.Generator, d_model: int,
                     cfg: RGLRUConfig,
                     dtype=layers.DEFAULT_PARAM_DTYPE) -> RGLRU:
    w = cfg.lru_width or d_model
    nb = N_GATE_BLOCKS
    if w % nb:
        raise ValueError(f"lru_width {w} is not a multiple of {nb}")
    dev, bw = generator.device, w // nb
    tn = layers.truncated_normal
    in_gate = init_linear(generator, d_model, w, dtype=dtype)
    in_rec = init_linear(generator, d_model, w, dtype=dtype)
    conv_w = tn((cfg.conv_width, w), cfg.conv_width**-0.5, generator, dtype)
    wa = tn((nb, bw, bw), bw**-0.5, generator, dtype)
    wx = tn((nb, bw, bw), bw**-0.5, generator, dtype)
    out = init_linear(generator, w, d_model, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    lam = torch.full((w,), 2.0, dtype=torch.float32, device=dev)
    return RGLRU(in_gate, in_rec, conv_w, zeros(w), wa, zeros(nb, bw), wx,
                 zeros(nb, bw), lam, out)


def _block_linear(w: torch.Tensor, b: torch.Tensor,
                  u: torch.Tensor) -> torch.Tensor:
    """Block-diagonal linear: u (..., W) with W = nb * bw."""
    nb, bw, _ = w.shape
    ub = u.reshape(*u.shape[:-1], nb, bw)
    y = torch.einsum("...nb,nbc->...nc", ub, w.to(u.dtype))
    y = y + b.to(u.dtype)
    return y.reshape(u.shape)


def _gates(p: RGLRU, cfg: RGLRUConfig, u: torch.Tensor):
    """a_t and b_t of the recurrence h_t = a h + b, float32."""
    f32 = torch.float32
    r = torch.sigmoid(_block_linear(p.wa, p.ba, u).to(f32))
    i = torch.sigmoid(_block_linear(p.wx, p.bx, u).to(f32))
    log_a = -cfg.c_exponent * F.softplus(p.lam) * r          # (..., W) < 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u.to(f32))
    return a, b


def causal_conv1d(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                  state: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x (B, L, W); state (B, cw-1, W) carries the
    last cw-1 inputs for decode. Returns (y, new state), both in
    ``x.dtype``: the taps are summed in ``x.dtype`` in the reference's
    order, then the bias is added."""
    cw = w.shape[0]
    bsz, length, width = x.shape
    if state is None:
        state = torch.zeros((bsz, cw - 1, width), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, cw-1+L, W)
    y = torch.zeros_like(x)
    for i in range(cw):
        y = y + xp[:, i:i + length] * w[i].to(x.dtype)
    y = y + b.to(x.dtype)
    new_state = xp[:, length:] if cw > 1 else state
    return y, new_state


# ``h_t = a_t h_{t-1} + b_t`` along axis 1 from an optional ``h0``: the
# JAX module's ``linear_scan``, here the plain sequential version
linear_scan = linear_scan_ref


def rglru_block(p: RGLRU, x: torch.Tensor, cfg: RGLRUConfig, *,
                kernel: str = "auto", return_state: bool = False):
    """Full-sequence recurrent block (prefill). x (B, L, D)."""
    gate = F.gelu(linear(p.in_gate, x), approximate="tanh")
    u = linear(p.in_rec, x)
    u, conv_state = causal_conv1d(p.conv_w, p.conv_b, u)
    a, b = _gates(p, cfg, u)
    h = scan_ops.linear_scan(a, b, kernel=kernel)
    y = h.to(x.dtype) * gate
    out = linear(p.out, y)
    if return_state:
        return out, {"conv": conv_state, "h": h[:, -1]}
    return out


def init_rglru_cache(batch: int, d_model: int, cfg: RGLRUConfig,
                     device=None) -> dict[str, torch.Tensor]:
    w = cfg.lru_width or d_model
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                            dtype=torch.bfloat16, device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def rglru_decode(p: RGLRU, x: torch.Tensor, cache: dict[str, torch.Tensor],
                 cfg: RGLRUConfig
                 ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One-token step. x (B, 1, D). Puts the new conv state and ``h`` into
    ``cache`` and returns it."""
    gate = F.gelu(linear(p.in_gate, x), approximate="tanh")
    u = linear(p.in_rec, x)
    u, cache["conv"] = causal_conv1d(p.conv_w, p.conv_b, u, cache["conv"])
    a, b = _gates(p, cfg, u)  # (B, 1, W)
    h = a[:, 0] * cache["h"] + b[:, 0]
    cache["h"] = h
    y = h[:, None].to(x.dtype) * gate
    return linear(p.out, y), cache
