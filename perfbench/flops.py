"""The benchmark's own count of a model's operations and of an attention
call's bound, from shapes alone (the yardstick: nothing here reads the
program).

``request_flops`` is the model FLOPs of one served request: 2 x the
active parameters outside the embedding per token that runs through the
block stack, the head (2 x d x vocab) at each position whose logits are
computed (the last prompt position and every decode step), and the
causal attention products, 4 x head_dim per live (query, key) pair and
query head. An MoE layer's active parameters are its top-k routed
experts (of the published expert count, not the padded one) and its
router.
"""
from __future__ import annotations


def active_block_params(port: dict) -> int:
    """Active parameters of the block stack for one token (norms left
    out), from the configuration's ``port`` section."""
    d, h, kv, hd = (port["d_model"], port["n_heads"], port["n_kv_heads"],
                    port["head_dim"])
    attn = d * h * hd * 2 + d * kv * hd * 2
    mats = 3 if port.get("gated_mlp", True) else 2
    moe = port.get("moe")
    if moe:
        mlp = moe["top_k"] * d * moe["d_expert"] * mats + d * moe["n_experts"]
    else:
        mlp = d * port["d_ff"] * mats
    return port["n_layers"] * (attn + mlp)


def attention_pairs_prefill(s: int) -> int:
    """Live (query, key) pairs of a causal prefill of ``s`` positions."""
    return s * (s + 1) // 2


def request_flops(port: dict, prompt_len: int, new_tokens: int) -> float:
    """Model FLOPs of one request: a prefill of ``prompt_len`` tokens
    and ``new_tokens - 1`` decode steps (the engine's greedy loop)."""
    s, n = int(prompt_len), int(new_tokens)
    through = s + n - 1
    linear = 2 * active_block_params(port) * through
    head = 2 * port["d_model"] * port["vocab_size"] * n
    pairs = attention_pairs_prefill(s) + sum(p + 1 for p in range(s, s + n - 1))
    attn = 4 * port["head_dim"] * port["n_heads"] * port["n_layers"] * pairs
    return float(linear + head + attn)


def flash_bound_s(b: int, s: int, h: int, kv: int, hd: int, peak: dict,
                  elem_bytes: int = 2) -> float:
    """Least time of a causal prefill attention call: Q, K, V read and O
    written once against the HBM rate, or 4 hd flops per live (query,
    key) pair and head against the bf16 rate, whichever is larger."""
    byts = elem_bytes * hd * b * s * (2 * h + 2 * kv)
    flops = 4 * hd * h * b * attention_pairs_prefill(s)
    return max(byts / peak["hbm_bytes_per_s"], flops / peak["bf16_flops_per_s"])


def decode_bound_s(b: int, h: int, kv: int, hd: int, live: int, peak: dict,
                   elem_bytes: int = 2) -> float:
    """Least time of one decode attention call over ``live`` cache
    slots: the live keys and values and the query and output once, or
    the products, whichever is larger."""
    byts = elem_bytes * hd * b * (2 * live * kv + 2 * h)
    flops = 4 * hd * h * b * live
    return max(byts / peak["hbm_bytes_per_s"], flops / peak["bf16_flops_per_s"])
