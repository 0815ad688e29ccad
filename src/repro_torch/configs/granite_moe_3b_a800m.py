"""granite-moe-3b-a800m [moe]: 32L d1536 24H (GQA kv=8) vocab=49155.
40 experts top-8, d_expert=512; experts padded 40 -> 48 for 16-way EP.
[hf:ibm-granite/granite-3.0-*]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
        n_heads=24, n_kv_heads=8, head_dim=64, d_ff=512, vocab_size=49_155,
        pattern=("global_moe",),
        moe=MoEConfig(n_experts=40, top_k=8, d_expert=512),
        mlp_act="silu", gated_mlp=True, tie_embeddings=True,
        recipe="fsdp",  # 24 heads do not divide the 16-way model axis
        long_context_ok=False)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m-smoke", family="moe", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64,
        vocab_size=512, pattern=("global_moe",),
        moe=MoEConfig(n_experts=10, top_k=2, d_expert=64,   # pads 10 -> 16
                      capacity_factor=8.0),
        mlp_act="silu", gated_mlp=True, tie_embeddings=True, recipe="fsdp",
        long_context_ok=False)


register("granite-moe-3b-a800m", full, smoke)
