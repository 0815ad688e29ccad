"""llava-next-34b [vlm]: 60L d7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
AnyRes tiling; the vision tower is a stub — input_specs() provides
precomputed patch embeddings, the backbone owns the multimodal projector.
[hf:llava-hf/llava-v1.6-*]"""
from repro_torch.configs.base import ModelConfig, PatchStub, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
        n_heads=56, n_kv_heads=8, head_dim=128, d_ff=20480,
        vocab_size=64_000, pattern=("global",),
        patch_stub=PatchStub(n_patches=2880, embed_dim=1024),  # anyres 5x576
        mlp_act="silu", gated_mlp=True,
        recipe="fsdp",  # 56 heads do not divide the 16-way model axis
        long_context_ok=False)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b-smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=256, vocab_size=512,
        pattern=("global",), patch_stub=PatchStub(n_patches=8, embed_dim=32),
        mlp_act="silu", gated_mlp=True, recipe="fsdp",
        long_context_ok=False)


register("llava-next-34b", full, smoke)
