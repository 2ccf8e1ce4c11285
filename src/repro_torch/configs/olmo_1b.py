"""OLMo-1B — dense MHA decoder. [arXiv:2402.00838; hf]
16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304; non-parametric LayerNorm, SwiGLU, RoPE.
"""
from repro_torch.config.base import ModelConfig

ARCH_ID = "olmo-1b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
        d_ff=8192, vocab_size=50304,
        norm_type="layernorm_nonparam", mlp_act="swiglu", tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
        norm_type="layernorm_nonparam", mlp_act="swiglu", tie_embeddings=True,
    )
