"""Step construction. Only the serve engine's slot decode step is ported: the
train, zero1, prefill and whole-batch decode steps come in later slices.

PyTorch runs eagerly, so a step is a plain callable: no jit, no shardings
and no buffer donation — the decode step updates the page arena in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.config.base import ShapeConfig
from repro_torch.models import kvquant, paging
from repro_torch.models import transformer as tr
from repro_torch.models.model import Model


@dataclass(frozen=True)
class StepSpec:
    """The argument surface of the `build_*_step` functions. kv_dtype=None
    resolves to model width; a memory plan (`plan`) is not ported yet."""
    plan: Any = None
    kv_dtype: Optional[str] = None
    arena: Optional[paging.PageArena] = None

    def resolved_kv_dtype(self) -> str:
        """Explicit kv_dtype > model width, validated so a typo raises here."""
        if self.plan is not None:
            raise NotImplementedError("memory plans are not ported yet")
        if self.kv_dtype is not None:
            return kvquant.validate_kv_dtype(self.kv_dtype)
        return "model"


def build_slot_decode_step(model: Model, shape: ShapeConfig,
                           spec: StepSpec = StepSpec()):
    """Fixed-shape slot-batched decode step of the continuous-batching serve
    engine: `shape.global_batch` is the slot count, `shape.seq_len` the
    per-slot cache capacity. Each call advances every active slot one token
    at its own position; requests join and leave by editing the cache's page
    table and the positions/active vectors, never the step.

    kv_dtype="int8": the attn k/v leaves are int8 codes with per-row f32
    scale leaves, and each new token's rows are quantized on write. arena:
    every pageable leaf is re-laid into the shared page arena with an int32
    page table at the top of the cache tree; the int8 transform runs first
    so the scales page too. The arena is required: slot-contiguous decode
    on the card needs a kernel that is not ported yet.

    -> (fn(params, cache, batch, positions, active) -> (logits [B,V],
    cache), cache_defs): cache_defs is the tree of ParamDefs giving the
    cache layout fn expects."""
    kv_dtype = spec.resolved_kv_dtype()
    if spec.arena is None:
        raise NotImplementedError(
            "slot decode without a page arena is not ported yet")
    defs = tr.cache_defs(model.cfg, shape.global_batch, shape.seq_len)
    if kvquant.is_int8(kv_dtype):
        defs = kvquant.quantize_cache_defs(defs, shape.seq_len)
    defs = paging.page_cache_defs(defs, shape.seq_len, spec.arena)
    page_size = spec.arena.page_size

    def decode(params, cache, batch, positions, active):
        return model.decode_slots(params, cache, batch, positions, active,
                                  page_size=page_size)

    return decode, defs
