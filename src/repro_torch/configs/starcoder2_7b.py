"""StarCoder2-7B — dense GQA decoder. [arXiv:2402.19173; hf]
32L d_model=4608 36H (kv=4) d_ff=18432 vocab=49152; GQA, RoPE, LayerNorm, GELU MLP, biases.
"""
from repro_torch.config.base import ModelConfig

ARCH_ID = "starcoder2-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4, head_dim=128,
        d_ff=18432, vocab_size=49152,
        use_bias=True, norm_type="layernorm", norm_eps=1e-5, mlp_act="gelu",
        rope_theta=100_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
        use_bias=True, norm_type="layernorm", norm_eps=1e-5, mlp_act="gelu",
    )
