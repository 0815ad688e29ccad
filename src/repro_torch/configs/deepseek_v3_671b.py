"""deepseek-v3-671b [moe]: 61L d7168 128H d_ff(expert)=2048 vocab=129280.
MLA attention, 3 dense + 58 MoE layers (1 shared + 256 routed, top-8), MTP.
[arXiv:2412.19437]"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
        n_heads=128, n_kv_heads=128, head_dim=128, d_ff=18432,
        vocab_size=129_280,
        prefix=("mla", "mla", "mla"), pattern=("mla_moe",),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                      qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                      d_shared=2048, first_dense=3),
        mtp=True, mlp_act="silu", gated_mlp=True, recipe="tp",
        optimizer="adafactor",  # 671B x fp32 Adam does not fit 256x16GB v5e
        long_context_ok=False)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-smoke", family="moe", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        prefix=("mla",), pattern=("mla_moe",),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=64, n_shared=1,
                      d_shared=64, first_dense=1, capacity_factor=8.0),
        mtp=True, mlp_act="silu", gated_mlp=True, recipe="tp",
        optimizer="adafactor", long_context_ok=False)


register("deepseek-v3-671b", full, smoke)
