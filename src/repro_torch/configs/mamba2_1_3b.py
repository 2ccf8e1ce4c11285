"""Mamba2-1.3B — attention-free SSM with SSD (state-space duality).
[arXiv:2405.21060; unverified] 48L d_model=2048, state=128, headdim=64, expand=2.
"""
from repro_torch.config.base import ModelConfig

ARCH_ID = "mamba2-1.3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0, head_dim=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_conv=4, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
        ssm_ngroups=1, norm_type="rmsnorm", norm_eps=1e-5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=0, num_kv_heads=0, head_dim=0,
        d_ff=0, vocab_size=256,
        ssm_state=16, ssm_conv=4, ssm_headdim=16, ssm_expand=2, ssm_chunk=16,
        ssm_ngroups=1, norm_type="rmsnorm", norm_eps=1e-5,
    )
