"""Plain PyTorch version of the decode-attention kernel: the port of
``repro.kernels.decode_attention.ref.decode_attention_ref``."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         slot_pos: torch.Tensor, pos: int, *,
                         window: int | None = None,
                         softcap: float | None = None,
                         return_lse: bool = False):
    """q (B, 1, H, hd); k/v (B, L, KV, hd); slot_pos (L,) int32 -> (B, 1,
    H, hd). Slot ``s`` takes part iff ``0 <= slot_pos[s] <= pos`` and,
    with a window, ``slot_pos[s] > pos - window``.

    ``return_lse``: the partial result of a cache split into slices
    (combined across them by ``repro_torch.distributed.tp
    .softmax_combine``): (the output in float32, its value product taken
    in float32 on the rounded probabilities, not rounded after; the
    log-sum-exp (B, H) of the masked, soft-capped, scaled scores). Where
    no slot takes part the output is 0 and the log-sum-exp -inf, so the
    slice weighs nothing in the combine."""
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
    if not return_lse:
        out = torch.einsum("bkgs,bskd->bkgd", probs, v)
        return out.reshape(b, 1, h, hd)
    live = valid.any()
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(torch.float32),
                       v.to(torch.float32))
    out = torch.where(live, out, torch.zeros_like(out))
    lse = torch.logsumexp(scores, dim=-1)
    lse = torch.where(live, lse, torch.full_like(lse, -torch.inf))
    return out.reshape(b, 1, h, hd), lse.reshape(b, h)
