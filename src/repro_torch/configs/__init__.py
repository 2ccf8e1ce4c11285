"""Architecture registry: --arch <id> -> (config(), smoke_config()).

Only the architectures whose layer kinds the port runs are registered; the
JAX package's other ids raise "not ported yet"."""
from repro_torch.configs import (grok_1_314b, mamba2_1_3b, olmo_1b, qwen2_5_14b,
                                 qwen2_72b, qwen3_moe_235b, starcoder2_7b)

_MODULES = (qwen2_5_14b, olmo_1b, starcoder2_7b, qwen2_72b, mamba2_1_3b, qwen3_moe_235b,
            grok_1_314b)

REGISTRY = {m.ARCH_ID: m for m in _MODULES}
ARCH_IDS = tuple(REGISTRY)

# every arch id of the JAX package's registry; the rest are not ported yet
_REFERENCE_IDS = (
    "qwen2.5-14b", "olmo-1b", "starcoder2-7b", "qwen2-72b", "mamba2-1.3b",
    "grok-1-314b", "qwen3-moe-235b-a22b", "recurrentgemma-9b", "qwen2-vl-2b",
    "whisper-tiny",
)


def _module(arch_id: str):
    if arch_id in REGISTRY:
        return REGISTRY[arch_id]
    if arch_id in _REFERENCE_IDS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet; ported: {sorted(REGISTRY)}")
    raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")


def get_config(arch_id: str):
    return _module(arch_id).config()


def get_smoke_config(arch_id: str):
    return _module(arch_id).smoke_config()
