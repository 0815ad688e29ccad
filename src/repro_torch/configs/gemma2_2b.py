"""gemma2-2b [dense]: 26L d2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
Local+global alternating attention, logit softcaps, sandwich norms.
[arXiv:2408.00118]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", family="dense", n_layers=26, d_model=2304,
        n_heads=8, n_kv_heads=4, head_dim=256, d_ff=9216, vocab_size=256_000,
        pattern=("local", "global"), window=4096, attn_softcap=50.0,
        final_softcap=30.0, mlp_act="gelu", gated_mlp=True,
        embed_scale=True, post_norm=True, tie_embeddings=True,
        recipe="fsdp",  # 8 heads do not divide the 16-way model axis
        long_context_ok=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b-smoke", family="dense", n_layers=4, d_model=64,
        n_heads=2, n_kv_heads=1, head_dim=32, d_ff=256, vocab_size=512,
        pattern=("local", "global"), window=16, attn_softcap=50.0,
        final_softcap=30.0, mlp_act="gelu", gated_mlp=True, embed_scale=True,
        post_norm=True, tie_embeddings=True, recipe="fsdp",
        long_context_ok=True)


register("gemma2-2b", full, smoke)
