"""Plain float32 reference of a decoder of GQA attention blocks with a
mixture-of-experts MLP (granite-moe-3b-a800m): ``dense_gqa`` with its
MLP replaced.

The MoE: router logits in float32 over the padded experts, the padded
ones excluded; each token's top-k by a stable descending sort (ties to
the lower index); combine weights the softmax over the k chosen logits.
The prompt is routed as one group with ``capacity = max(1, int(S k / E
capacity_factor))`` slots an expert (E the published expert count): an
expert takes tokens in order and drops the ones past its slots, whose
share is not given to another expert. Every later token (a decode step,
routed alone) keeps all k. Each expert is act(x Wgate) * (x Wup) Wout
over the tokens routed to it, times its combine weight (rounded to the
activations' dtype), summed over a token's experts in float32. The
router stays float32 in every precision, as in the program.
"""
from __future__ import annotations

import torch

from perfbench.reference import dense_gqa
from perfbench.reference.dense_gqa import activation, fan_in  # noqa: F401


def moe_mlp(prec, w: dict, pre: str, port: dict):
    moe = port["moe"]
    if not port.get("gated_mlp", True):
        raise ValueError("this reference's experts are gated")
    router = w[pre + "mlp.router.w"].to(torch.float32)     # (d, E padded)
    w_up = [prec.weight(e) for e in w[pre + "mlp.w_up"]]
    w_gate = [prec.weight(e) for e in w[pre + "mlp.w_gate"]]
    w_out = [prec.weight(e) for e in w[pre + "mlp.w_out"]]
    n_exp, top_k, cf = moe["n_experts"], moe["top_k"], moe.get(
        "capacity_factor", 1.25)
    act = port["mlp_act"]

    def run(h: torch.Tensor, groups) -> torch.Tensor:
        logits = torch.matmul(h.to(torch.float32), router)
        logits[:, n_exp:] = float("-inf")
        idx = torch.sort(logits, dim=-1, descending=True,
                         stable=True).indices[:, :top_k]           # (T, k)
        wts = torch.softmax(torch.gather(logits, 1, idx), dim=-1)
        keep = torch.ones_like(idx, dtype=torch.bool)
        for off, _, prompt_len in groups:   # each prompt its own group
            s = prompt_len
            cap = max(1, int(s * top_k / n_exp * cf))
            pi = idx[off:off + s]
            chosen = torch.zeros((s, logits.shape[1]), device=h.device)
            chosen.scatter_(1, pi, 1.0)
            before = torch.cumsum(chosen, dim=0) - chosen   # earlier tokens
            keep[off:off + s] = torch.gather(before, 1, pi) < cap
        y = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        for e in range(n_exp):
            tok, slot = torch.nonzero((idx == e) & keep, as_tuple=True)
            if tok.numel() == 0:
                continue
            xe = h[tok]
            a = activation(act, prec.mm(xe, w_gate[e])) * prec.mm(xe, w_up[e])
            part = prec.mm(a, w_out[e]) * wts[tok, slot, None].to(h.dtype)
            y.index_add_(0, tok, part.to(torch.float32))
        return y.to(h.dtype)
    return run


def logits_at(w, port, seqs, prompt_lens, rows, *, precision="float32"):
    return dense_gqa.logits_at(w, port, seqs, prompt_lens, rows,
                               precision=precision, mlp=moe_mlp)
