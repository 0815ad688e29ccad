"""recurrentgemma-9b [hybrid]: 38L d4096 16H (MQA kv=1) d_ff=12288
vocab=256000. Griffin pattern: (RG-LRU, RG-LRU, local attention), window
2048. [arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
        n_heads=16, n_kv_heads=1, head_dim=256, d_ff=12288,
        vocab_size=256_000,
        pattern=("rec", "rec", "local"), suffix=("rec", "rec"),
        window=2048, rglru=RGLRUConfig(lru_width=4096, conv_width=4),
        mlp_act="gelu", gated_mlp=True, embed_scale=True,
        tie_embeddings=True, recipe="tp", long_context_ok=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke", family="hybrid", n_layers=8,
        d_model=64, n_heads=2, n_kv_heads=1, head_dim=32, d_ff=256,
        vocab_size=512, pattern=("rec", "rec", "local"), suffix=("rec", "rec"),
        window=16, rglru=RGLRUConfig(lru_width=64, conv_width=4),
        mlp_act="gelu", gated_mlp=True, embed_scale=True,
        tie_embeddings=True, recipe="tp", long_context_ok=True)


register("recurrentgemma-9b", full, smoke)
