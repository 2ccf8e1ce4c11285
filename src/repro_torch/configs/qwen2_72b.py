"""Qwen2-72B — dense GQA decoder; the LMS headline case (params >> HBM).
[arXiv:2407.10671; hf] 80L d_model=8192 64H (kv=8) d_ff=29568 vocab=152064; QKV bias.
"""
from repro_torch.config.base import ModelConfig

ARCH_ID = "qwen2-72b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
        d_ff=29568, vocab_size=152064,
        qkv_bias=True, norm_type="rmsnorm", mlp_act="swiglu", rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=192, vocab_size=256,
        qkv_bias=True, norm_type="rmsnorm", mlp_act="swiglu",
    )
