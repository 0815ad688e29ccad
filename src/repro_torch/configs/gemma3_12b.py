"""gemma3-12b [dense]: 48L d3840 16H (GQA kv=8) d_ff=15360 vocab=262144.
5:1 local:global attention, 128k context, qk-norm, dual rope bases.
[hf:google/gemma-3-*]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b", family="dense", n_layers=48, d_model=3840,
        n_heads=16, n_kv_heads=8, head_dim=256, d_ff=15360,
        vocab_size=262_144,
        pattern=("local", "local", "local", "local", "local", "global"),
        window=1024, qk_norm=True, mlp_act="gelu", gated_mlp=True,
        embed_scale=True, post_norm=True, tie_embeddings=True,
        rope_theta=1_000_000.0, rope_local_theta=10_000.0, recipe="tp",
        long_context_ok=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b-smoke", family="dense", n_layers=6, d_model=64,
        n_heads=2, n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        pattern=("local", "local", "local", "local", "local", "global"),
        window=16, qk_norm=True, mlp_act="gelu", gated_mlp=True,
        embed_scale=True, post_norm=True, tie_embeddings=True,
        rope_theta=1_000_000.0, rope_local_theta=10_000.0, recipe="tp",
        long_context_ok=True)


register("gemma3-12b", full, smoke)
