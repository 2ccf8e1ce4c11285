"""Grok-1 (314B) — MoE decoder, 8 experts top-2. [hf:xai-org/grok-1; unverified]
64L d_model=6144 48H (kv=8) d_ff=32768 vocab=131072.
"""
from repro_torch.config.base import ModelConfig

ARCH_ID = "grok-1-314b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
        d_ff=32768, vocab_size=131072,
        num_experts=8, experts_per_token=2,
        norm_type="rmsnorm", mlp_act="geglu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
        num_experts=4, experts_per_token=2,
        norm_type="rmsnorm", mlp_act="geglu",
    )
