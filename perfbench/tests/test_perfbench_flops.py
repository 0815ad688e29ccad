"""The FLOP and roofline arithmetic against small shapes counted by
hand."""
from __future__ import annotations

import math

from perfbench import flops

PEAK = {"bf16_flops_per_s": 1e12, "hbm_bytes_per_s": 1e9}
DENSE = {"n_layers": 2, "d_model": 4, "n_heads": 2, "n_kv_heads": 1,
         "head_dim": 2, "d_ff": 8, "vocab_size": 10, "gated_mlp": False}
MOE = dict(DENSE, gated_mlp=True,
           moe={"n_experts": 5, "top_k": 2, "d_expert": 3})


def test_active_params_by_hand():
    # attention: wq 4x(2x2)=16, wo 16, wk 4x(1x2)=8, wv 8 -> 48; mlp 2x4x8=64
    assert flops.active_block_params(DENSE) == 2 * (48 + 64)
    # moe: top-2 of gated experts 2 x (3 x 4 x 3) = 72, router 4 x 5 = 20
    assert flops.active_block_params(MOE) == 2 * (48 + 72 + 20)


def test_request_flops_by_hand():
    # prompt 3, 2 new tokens: 4 tokens through the stack, 2 logits rows,
    # pairs 1+2+3 in prefill and 4 at the decode step (position 3)
    f = flops.request_flops(DENSE, 3, 2)
    linear = 2 * 224 * 4
    head = 2 * 4 * 10 * 2
    attn = 4 * 2 * 2 * 2 * (6 + 4)
    assert f == linear + head + attn
    assert flops.request_flops(DENSE, 3, 1) == 2 * 224 * 3 + 80 + 4 * 2 * 2 * 2 * 6


def test_attention_bounds_by_hand():
    # b1 s4 h2 kv1 hd2: bytes 2 x 2 x 4 x (4 + 2) = 96; flops 4x2x2x10 = 160
    assert math.isclose(flops.flash_bound_s(1, 4, 2, 1, 2, PEAK), 96 / 1e9)
    big = {"bf16_flops_per_s": 1.0, "hbm_bytes_per_s": 1e12}
    assert flops.flash_bound_s(1, 4, 2, 1, 2, big) == 160.0
    # decode over 5 live slots: bytes 2 x 2 x (2 x 5 x 1 + 2 x 2) = 56
    assert math.isclose(flops.decode_bound_s(1, 2, 1, 2, 5, PEAK), 56 / 1e9)
    assert flops.decode_bound_s(1, 2, 1, 2, 5, big) == 4 * 2 * 2 * 5
