"""Qwen2.5-14B — dense GQA decoder. [hf:Qwen/Qwen2.5-*; hf]
48L d_model=5120 40H (kv=8) d_ff=13824 vocab=152064; GQA, QKV bias, RoPE, RMSNorm, SwiGLU.
"""
from repro_torch.config.base import ModelConfig

ARCH_ID = "qwen2.5-14b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
        d_ff=13824, vocab_size=152064,
        qkv_bias=True, norm_type="rmsnorm", mlp_act="swiglu", rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
        qkv_bias=True, norm_type="rmsnorm", mlp_act="swiglu",
    )
