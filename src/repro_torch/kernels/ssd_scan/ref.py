"""Plain PyTorch version of the SSD intra-chunk kernel: the port of
``repro.kernels.ssd_scan.ref.ssd_intra_chunk_ref``."""
from __future__ import annotations

import torch


def ssd_intra_chunk_ref(xc: torch.Tensor, bc: torch.Tensor, cc: torch.Tensor,
                        dtc: torch.Tensor, cum: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD term and per-chunk state contributions.

    xc (B, NC, Q, H, P); bc/cc (B, NC, Q, N); dtc/cum (B, NC, Q, H), all
    float32. Returns y_intra (B, NC, Q, H, P) and states (B, NC, H, P, N).
    Above the diagonal ``exp(cum_q - cum_s)`` overflows; it is selected
    away (``where``), never multiplied by a 0/1 mask."""
    q = xc.shape[2]
    total = cum[:, :, -1:]                                  # (B,NC,1,H)
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,NC,Q,Q,H)
    mask = torch.ones((q, q), dtype=torch.bool, device=xc.device).tril()
    gate = torch.where(mask[None, None, :, :, None], torch.exp(rel),
                       torch.zeros((), dtype=rel.dtype, device=rel.device))
    scores = torch.einsum("bcqn,bcsn->bcqs", cc, bc)
    w = scores[..., None] * gate * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", w, xc)
    sgate = torch.exp(total - cum) * dtc                    # (B,NC,Q,H)
    states = torch.einsum("bcqh,bcqhp,bcqn->bchpn", sgate, xc, bc)
    return y_intra, states
