"""Plain PyTorch version of the flash-attention kernel (causal GQA,
optional sliding window and logit softcap): the port of
``repro.kernels.flash_attention.ref.flash_attention_ref``."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def check_offset(sq: int, sk: int, q_offset: int) -> None:
    """Raise unless ``sk`` keys are the causal prefix of ``sq`` queries
    at ``q_offset``."""
    if q_offset < 0 or sk != q_offset + sq:
        raise ValueError(f"{sk} keys for {sq} queries at q_offset="
                         f"{q_offset}: the keys must be the causal prefix, "
                         f"q_offset + Sq = {q_offset + sq}")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int | None = None,
                        softcap: float | None = None,
                        q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd); k/v (B, Sk, KV, hd) -> (B, Sq, H, hd).

    The queries are the rows at positions ``q_offset .. q_offset + Sq -
    1`` and the keys positions ``0 .. Sk - 1``, with ``Sk = q_offset +
    Sq``: a block of rows of a sequence-sharded prefill over its causal
    prefix (``q_offset=0``: the whole sequence). Scores in float32
    (float64 for float64 inputs, which ``torch.autograd.gradcheck``
    takes), scaled by ``hd**-0.5``, soft-capped, masked, then a softmax
    in that type whose probabilities are rounded to ``v.dtype`` before
    the value product, as in the reference. Differentiable: the in-place
    mask acts on the scaled (or soft-capped) scores, which no backward
    reads."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    check_offset(s, k.shape[1], q_offset)
    g = h // kv
    qg = q.reshape(b, s, kv, g, hd)
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(acc),
                          k.to(acc)) * (hd ** -0.5)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    i = torch.arange(q_offset, q_offset + s, device=q.device)[:, None]
    j = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = j <= i
    if window is not None:
        mask &= j > i - window
    # in place: at llava-next-34b's 56 heads over 2,896 positions one
    # float32 score tensor is 1.9 GB, beside a model of 68.8 GB
    scores.masked_fill_(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    del scores
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, s, h, hd)
