"""Public histogram-sketch ops: log binning, kernel dispatch and
percentile read-out.

This package owns the sketch geometry (``HIST_LO`` / ``HIST_HI`` /
``DEFAULT_BINS``): ``n_bins`` log-spaced buckets spanning [HIST_LO,
HIST_HI]; values outside clamp to the edge bins. ``log_scale`` computes
the bin transform in float32 exactly as the JAX package does, and the
CUDA kernels receive its two floats from here, so the kernel and the
plain path bin with the same constants.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.hist_sketch import kernel as hist_kernel
from repro_torch.kernels.hist_sketch.ref import hist_accum_ref

# Unit-mean service times => responses live well inside [1e-3, 1e5].
HIST_LO = 1e-3
HIST_HI = 1e5
DEFAULT_BINS = 2048


@functools.lru_cache(maxsize=None)
def log_scale(n_bins: int, lo: float = HIST_LO,
              hi: float = HIST_HI) -> tuple[float, float]:
    """``(log_lo, scale)`` of the bin transform ``(log(v) - log_lo) *
    scale``, both float32 values. ``scale`` is a true float32 division
    (``scalar / tensor`` in torch multiplies by a rounded reciprocal)."""
    f32 = torch.float32
    log_lo = torch.log(torch.tensor(lo, dtype=f32))
    scale = (torch.tensor(n_bins - 1, dtype=f32)
             / (torch.log(torch.tensor(hi, dtype=f32)) - log_lo))
    return float(log_lo), float(scale)


def bin_indices(values: torch.Tensor, warm: torch.Tensor | None = None, *,
                n_bins: int = DEFAULT_BINS, lo: float = HIST_LO,
                hi: float = HIST_HI) -> torch.Tensor:
    """Log-bin indices (same shape as ``values``, int32 in [-1, n_bins)).

    Entries where ``warm`` (broadcastable 0/1 weight) is zero are encoded
    as -1, which the accumulators skip. The float-to-int conversion
    truncates, then the index is clipped, then masked.
    """
    log_lo, scale = (torch.tensor(x, dtype=torch.float32, device=values.device)
                     for x in log_scale(n_bins, lo, hi))
    idx = ((torch.log(values) - log_lo) * scale).to(torch.int32)
    idx = idx.clamp(0, n_bins - 1)
    if warm is not None:
        idx = torch.where(torch.broadcast_to(warm, values.shape) > 0, idx,
                          torch.full_like(idx, -1))
    return idx


def hist_accum(idx: torch.Tensor, *, n_bins: int = DEFAULT_BINS,
               kernel: str = "auto") -> torch.Tensor:
    """idx (T, C) int32 in [-1, n_bins) -> per-cell counts (C, n_bins) f32.

    A CUDA tensor launches the CUDA kernel (see ``dispatch``); a CPU
    tensor, or ``kernel="off"``, takes the plain version."""
    if dispatch.use_kernel(kernel, idx):
        out = torch.zeros((idx.shape[1], n_bins), dtype=torch.float32,
                          device=idx.device)
        return hist_kernel.hist_accum_cuda(idx, out)
    return hist_accum_ref(idx, n_bins=n_bins)


def hist_sketch(values: torch.Tensor, warm: torch.Tensor | None = None, *,
                n_bins: int = DEFAULT_BINS, lo: float = HIST_LO,
                hi: float = HIST_HI, kernel: str = "auto") -> torch.Tensor:
    """Log-histogram counts (C, n_bins) of a (T, C) block of values."""
    idx = bin_indices(values, warm, n_bins=n_bins, lo=lo, hi=hi)
    return hist_accum(idx, n_bins=n_bins, kernel=kernel)


def sketch_quantiles(hist: torch.Tensor, qs, *, lo: float = HIST_LO,
                     hi: float = HIST_HI) -> torch.Tensor:
    """Percentiles (Q, ...) read from histogram counts (..., n_bins).

    Returns the geometric midpoint of the first bin at which the cdf
    reaches the target mass — relative error is at most one log-bin width
    (~0.5% at the default 2048 bins over 8 decades).
    """
    n_bins = hist.shape[-1]
    dev = hist.device
    log_lo, scale = (torch.tensor(x, dtype=torch.float32, device=dev)
                     for x in log_scale(n_bins, lo, hi))
    cdf = torch.cumsum(hist, dim=-1)                      # (..., n_bins)
    count = cdf[..., -1:]                                 # (..., 1)
    qs = torch.as_tensor(qs, dtype=torch.float32, device=dev)
    hundred = torch.tensor(100.0, dtype=torch.float32, device=dev)
    targets = qs.reshape((-1,) + (1,) * hist.ndim) / hundred * count[None]
    bin_idx = torch.argmax((cdf[None] >= targets).to(torch.int32), dim=-1)
    return torch.exp(log_lo + (bin_idx.to(torch.float32) + 0.5) / scale)
