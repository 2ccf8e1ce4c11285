"""Qwen3-MoE-235B-A22B — MoE decoder, 128 experts top-8. [hf:Qwen/Qwen3-*; hf]
94L d_model=4096 64H (kv=4, head_dim=128 explicit) moe d_ff=1536 vocab=151936.
"""
from repro_torch.config.base import ModelConfig

ARCH_ID = "qwen3-moe-235b-a22b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
        d_ff=1536, vocab_size=151936,
        num_experts=128, experts_per_token=8,
        norm_type="rmsnorm", mlp_act="swiglu", rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=256,
        num_experts=8, experts_per_token=2,
        norm_type="rmsnorm", mlp_act="swiglu",
    )
