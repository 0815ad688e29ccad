"""nemotron-4-15b [dense]: 32L d6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
GQA + squared-ReLU MLP (non-gated). [arXiv:2402.16819]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense", n_layers=32, d_model=6144,
        n_heads=48, n_kv_heads=8, head_dim=128, d_ff=24576,
        vocab_size=256_000, pattern=("global",), mlp_act="relu2",
        gated_mlp=False, use_bias=False, rope_theta=10_000.0, recipe="tp",
        long_context_ok=False)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=256, vocab_size=512,
        pattern=("global",), mlp_act="relu2", gated_mlp=False, recipe="tp",
        long_context_ok=False)


register("nemotron-4-15b", full, smoke)
