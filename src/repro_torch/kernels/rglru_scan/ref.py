"""Plain PyTorch version of the RG-LRU scan kernel.

The JAX package's oracle (``repro.kernels.rglru_scan.ref.linear_scan_ref``)
is an associative scan; this one walks the sequence, one multiply and one
add a step, each rounded on its own: the arithmetic of the CUDA kernel,
which it equals bit for bit. Against the associative scan it agrees to a
float32 tolerance (the order of the products differs)."""
from __future__ import annotations

import torch


def linear_scan_ref(a: torch.Tensor, b: torch.Tensor,
                    h0: torch.Tensor | None = None) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` along axis 1, ``h_{-1} = h0`` (zeros
    when None). a/b (B, L, W) float32 -> h (B, L, W)."""
    h = (torch.zeros_like(a[:, 0]) if h0 is None
         else h0.to(device=a.device, dtype=a.dtype))
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
