"""Plain float32 reference of a decoder of GQA attention blocks with a
dense MLP (nemotron-4-15b), read from the weights by name.

A block: x += Wo attn(rope(Wq n(x)), rope(Wk n(x)), Wv n(x)); x +=
mlp(n(x)), with n the RMS norm times (1 + scale); the MLP is
act(x Wup) Wout (nemotron's squared ReLU, not gated) or act(x Wgate) *
(x Wup) Wout (gated). Attention is causal over the whole sequence, its
scores scaled by head_dim**-0.5; RoPE rotates the two halves of each
head by position x theta**(-2i/head_dim). Logits are the final norm of
the wanted positions times the head (the embedding table where tied),
in float32, over the published vocabulary. No cache, no kernel, no
batching: a served sequence is the prompt and its served tokens but the
last, and the full causal pass over it gives what prefill and the decode
steps through the cache must give.

``precision``:
- ``"float32"``: everything in float32 with TF32 off, on the
  benchmark's bf16 weights widened;
- ``"bf16"``: the configuration's own precision: activations and
  products in bf16 (float32 accumulation), norms, RoPE, the softmax and
  the head in float32, each result rounded to bf16 where a bf16 model
  stores it (attention's probabilities before the value product, each
  expert's weighted output before the sum over a token's experts);
- ``"fp8"``: the control: float32, but every product with a weight takes
  both operands rounded to float8 e4m3 (a scale per output column of the
  weight and per row of the activations), as an fp8 serving path would.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

NOT_HERE = ("attn_softcap", "final_softcap", "qk_norm", "use_bias",
            "embed_scale", "post_norm", "prefix", "suffix")
FP8_MAX = 448.0
MLP_ROWS = 8192  # rows of the MLP at a time (its float32 hidden)


def fan_in(name: str, shape: tuple) -> int | None:
    """The fan-in that scales a weight's random draw; None for a norm
    scale."""
    if name.endswith(".scale"):
        return None
    if name == "embed.table":
        return 1
    if name.endswith("wo.w"):                 # (H, hd, d)
        return shape[0] * shape[1]
    if name.endswith((".w_up", ".w_gate", ".w_out")):  # (E, in, out)
        return shape[1]
    return shape[0]                           # (in, *out)


def check_port(port: dict) -> None:
    for key in NOT_HERE:
        if port.get(key):
            raise ValueError(f"this reference does not implement {key}")
    if tuple(port["pattern"]) not in (("global",), ("global_moe",)):
        raise ValueError(f"layer pattern {port['pattern']} is not GQA")


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Precision:
    def __init__(self, kind: str):
        if kind not in ("float32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.fp8 = kind == "fp8"
        self.dtype = torch.bfloat16 if kind == "bf16" else torch.float32

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """(in, out) weight in the activations' dtype (in fp8, rounded
        per column)."""
        w = w.to(self.dtype)
        return _fp8(w, -2) if self.fp8 else w

    def head(self, w: torch.Tensor) -> torch.Tensor:
        """The head (d, V), float32 (in fp8, rounded per column)."""
        w = w.to(torch.float32)
        return _fp8(w, -2) if self.fp8 else w

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.matmul(_fp8(x, -1) if self.fp8 else x, w)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """In float32, returned in ``x``'s dtype."""
    x32 = x.to(torch.float32)
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, hd) at positions 0 .. S-1, in float32, returned in
    ``x``'s dtype."""
    dtype, x = x.dtype, x.to(torch.float32)
    s, _, hd = x.shape
    freqs = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                    device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA: q (S, H, hd), k/v (S, KV, hd) -> (S, H, hd), one KV
    head's group at a time; scores and softmax in float32, the
    probabilities rounded to ``v``'s dtype before the value product."""
    s, h, hd = q.shape
    kv = k.shape[1]
    g = h // kv
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).triu_(1)
    out = torch.empty_like(q)
    for j in range(kv):
        qs = q[:, j * g:(j + 1) * g].transpose(0, 1).float()  # (g, S, hd)
        sc = torch.matmul(qs, k[:, j].t().float()) * hd ** -0.5  # (g, S, S)
        sc.masked_fill_(mask, float("-inf"))
        out[:, j * g:(j + 1) * g] = torch.matmul(
            torch.softmax(sc, dim=-1).to(v.dtype), v[:, j]).transpose(0, 1)
    return out


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "relu2":
        return torch.square(F.relu(x))
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def dense_mlp(prec: Precision, w: dict, pre: str, port: dict):
    """The block's MLP as a function of (h, groups): h (T, d) holds the
    sequences one after another, ``groups`` their (offset, length,
    prompt_len); a dense MLP reads no group."""
    up = prec.weight(w[f"{pre}mlp.up.w"])
    out = prec.weight(w[f"{pre}mlp.out.w"])
    gate = (prec.weight(w[f"{pre}mlp.gate.w"]) if port.get("gated_mlp", True)
            else None)
    act = port["mlp_act"]

    def run(h: torch.Tensor, groups) -> torch.Tensor:
        y = torch.empty_like(h)
        for i in range(0, h.shape[0], MLP_ROWS):
            hc = h[i:i + MLP_ROWS]
            if gate is None:
                a = activation(act, prec.mm(hc, up))
            else:
                a = activation(act, prec.mm(hc, gate)) * prec.mm(hc, up)
            y[i:i + MLP_ROWS] = prec.mm(a, out)
        return y
    return run


def logits_at(w: dict, port: dict, seqs: list[torch.Tensor],
              prompt_lens: list[int], rows: list[list[int]], *,
              precision: str = "float32", mlp=dense_mlp) -> list[torch.Tensor]:
    """Float32 logits (len(rows[i]), vocab) of each sequence ``seqs[i]``
    (token ids) at positions ``rows[i]``. ``prompt_lens[i]``: where the
    prompt ends (an MoE routes the prompt as one group). Layer by layer
    over all sequences, each layer's weights widened once: attention a
    sequence at a time, the MLP over all of them together."""
    check_port(port)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prec = Precision(precision)
    d, h, kv, hd = (port["d_model"], port["n_heads"], port["n_kv_heads"],
                    port["head_dim"])
    eps, theta = port.get("norm_eps", 1e-6), port.get("rope_theta", 1e4)
    table = w["embed.table"]
    xs = [table[s].to(prec.dtype) for s in seqs]
    lens = [x.shape[0] for x in xs]
    offs = [sum(lens[:j]) for j in range(len(lens))]
    groups = list(zip(offs, lens, prompt_lens))
    for i in range(port["n_layers"]):
        pre = f"blocks.{i}."
        wq = prec.weight(w[pre + "mixer.wq.w"].reshape(d, h * hd))
        wk = prec.weight(w[pre + "mixer.wk.w"].reshape(d, kv * hd))
        wv = prec.weight(w[pre + "mixer.wv.w"].reshape(d, kv * hd))
        wo = prec.weight(w[pre + "mixer.wo.w"].reshape(h * hd, d))
        for j, x in enumerate(xs):
            s = x.shape[0]
            a = rmsnorm(x, w[pre + "pre_norm.scale"], eps)
            q = rope(prec.mm(a, wq).view(s, h, hd), theta)
            k = rope(prec.mm(a, wk).view(s, kv, hd), theta)
            v = prec.mm(a, wv).view(s, kv, hd)
            xs[j] = x + prec.mm(attention(q, k, v).reshape(s, h * hd), wo)
        del wq, wk, wv, wo
        # the MLP over every sequence at once
        x = torch.cat(xs)
        x = x + mlp(prec, w, pre, port)(
            rmsnorm(x, w[pre + "mlp_norm.scale"], eps), groups)
        xs = list(torch.split(x, lens))
    head = (w["lm_head.w"] if "lm_head.w" in w
            else table.transpose(0, 1))       # (d, V padded)
    head = prec.head(head)
    out = []
    for x, r in zip(xs, rows):
        hfin = rmsnorm(x[torch.as_tensor(r, device=x.device)],
                       w["final_norm.scale"], eps).to(torch.float32)
        out.append(prec.mm(hfin, head)[:, :port["vocab_size"]])
    return out
