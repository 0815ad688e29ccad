"""Plain PyTorch version of the flash-attention kernel (causal GQA,
optional sliding window and logit softcap): the port of
``repro.kernels.flash_attention.ref.flash_attention_ref``."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int | None = None,
                        softcap: float | None = None) -> torch.Tensor:
    """q (B, S, H, hd); k/v (B, S, KV, hd) -> (B, S, H, hd).

    Scores in float32, scaled by ``hd**-0.5``, soft-capped, masked, then
    a float32 softmax whose probabilities are rounded to ``v.dtype``
    before the value product, as in the reference."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) * (hd ** -0.5)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = j <= i
    if window is not None:
        mask &= j > i - window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, s, h, hd)
