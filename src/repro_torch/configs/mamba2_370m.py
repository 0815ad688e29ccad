"""mamba2-370m [ssm]: 48L d1024, attention-free, vocab=50280, ssm_state=128.
SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm", n_layers=48, d_model=1024,
        n_heads=32, n_kv_heads=32, head_dim=64, d_ff=0, vocab_size=50_280,
        pattern=("ssd",),
        # chunk=256 (reference). §Perf iteration m2-3 tried 64 — HBM traffic
        # ROSE 33% because the inter-chunk state tensor scales as 1/Q; the
        # fitted io(Q) = aQ + b/Q has its optimum near Q=164 with only ~9%
        # headroom, so the structural fix is the Pallas ssd_scan kernel
        # (intra-chunk tensors stay in VMEM), not chunk tuning.
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      chunk=256),
        tie_embeddings=True, recipe="tp", long_context_ok=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-smoke", family="ssm", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=32, d_ff=0, vocab_size=512,
        pattern=("ssd",),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=8),
        tie_embeddings=True, recipe="tp", long_context_ok=True)


register("mamba2-370m", full, smoke)
