"""command-r-35b [dense]: 40L d8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
GQA, no biases. [hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b", family="dense", n_layers=40, d_model=8192,
        n_heads=64, n_kv_heads=8, head_dim=128, d_ff=22528,
        vocab_size=256_000, pattern=("global",), mlp_act="silu",
        gated_mlp=True, use_bias=False, rope_theta=8_000_000.0, recipe="tp",
        long_context_ok=False)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=8, n_kv_heads=2, head_dim=8, d_ff=192, vocab_size=512,
        pattern=("global",), mlp_act="silu", gated_mlp=True, recipe="tp",
        long_context_ok=False)


register("command-r-35b", full, smoke)
