"""Plain PyTorch version of the decode-attention kernel: the port of
``repro.kernels.decode_attention.ref.decode_attention_ref``."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         slot_pos: torch.Tensor, pos: int, *,
                         window: int | None = None,
                         softcap: float | None = None) -> torch.Tensor:
    """q (B, 1, H, hd); k/v (B, L, KV, hd); slot_pos (L,) int32 -> (B, 1,
    H, hd). Slot ``s`` takes part iff ``0 <= slot_pos[s] <= pos`` and,
    with a window, ``slot_pos[s] > pos - window``."""
    b, _, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                          k.to(q.dtype).to(torch.float32)) * (hd ** -0.5)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window is not None:
        valid &= slot_pos > pos - window
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v)
    return out.reshape(b, 1, h, hd)
