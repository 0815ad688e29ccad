"""musicgen-large [audio]: 48L d2048 32H (MHA kv=32) d_ff=8192 vocab=2048.
Decoder-only over EnCodec tokens, 4 codebooks (delay pattern); the EnCodec
frontend is a stub — input_specs() provides the (B, S, 4) token grid.
[arXiv:2306.05284]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=32, head_dim=64, d_ff=8192, vocab_size=2048,
        pattern=("global",), n_codebooks=4, mlp_act="gelu", gated_mlp=False,
        use_bias=True, recipe="tp", long_context_ok=False)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-smoke", family="audio", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=256, vocab_size=128,
        pattern=("global",), n_codebooks=4, mlp_act="gelu", gated_mlp=False,
        use_bias=True, recipe="tp", long_context_ok=False)


register("musicgen-large", full, smoke)
