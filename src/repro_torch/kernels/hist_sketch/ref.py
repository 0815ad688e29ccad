"""Plain PyTorch version of the histogram-sketch kernel."""
from __future__ import annotations

import torch


def hist_accum_ref(idx: torch.Tensor, *, n_bins: int) -> torch.Tensor:
    """idx (T, C) int32 in [-1, n_bins) -> per-cell counts (C, n_bins) f32.

    Each valid (t, c) entry adds exactly 1.0 to ``out[c, idx[t, c]]``
    (clipped into range); ``idx == -1`` entries add nothing. Counts are
    integers below 2**24, so the float sums are exact in any order.
    """
    t, c = idx.shape
    valid = (idx >= 0).to(torch.float32)
    cols = torch.arange(c, device=idx.device).expand(t, c)
    safe = idx.clamp(0, n_bins - 1).to(torch.int64)
    out = torch.zeros((c, n_bins), dtype=torch.float32, device=idx.device)
    return out.index_put_((cols, safe), valid, accumulate=True)
