"""Step construction for the serve path: the whole-batch prefill and decode
steps of the static loop and the serve engine's slot decode step. The
train and zero1 steps come in later slices.

PyTorch runs eagerly, so a step is a plain callable: no jit, no shardings
and no buffer donation — where the JAX package donates a cache, the step
updates the caches in place instead.
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
    resolves to model width; a memory plan (`plan`) is not ported yet.
    cache_len: capacity of the cache the prefill step emits."""
    plan: Any = None
    kv_dtype: Optional[str] = None
    arena: Optional[paging.PageArena] = None
    cache_len: Optional[int] = None

    def resolved_kv_dtype(self) -> str:
        """Explicit kv_dtype > model width, validated so a typo raises here."""
        if self.plan is not None:
            raise NotImplementedError("memory plans are not ported yet")
        if self.kv_dtype is not None:
            return kvquant.validate_kv_dtype(self.kv_dtype)
        return "model"


def build_prefill_step(model: Model, shape: ShapeConfig,
                       spec: StepSpec = StepSpec()):
    """Whole-prompt prefill of `shape.global_batch` prompts of
    `shape.seq_len` tokens into a cache of `spec.cache_len` positions
    (default: the prompt), so serving prefills straight into the
    decode-capacity cache. -> (fn(params, batch) -> (last-token logits
    [B,V], cache), cache_defs)."""
    if spec.plan is not None:
        raise NotImplementedError("memory plans are not ported yet")
    cache_len = spec.cache_len or shape.seq_len
    defs = tr.cache_defs(model.cfg, shape.global_batch, cache_len)

    def prefill(params, batch):
        return model.prefill(params, batch, cache_len=cache_len)

    return prefill, defs


def build_decode_step(model: Model, shape: ShapeConfig,
                      spec: StepSpec = StepSpec()):
    """Whole-batch decode step of the static loop: `shape.global_batch`
    rows, each at the same position, against caches of `shape.seq_len`
    positions, which are updated in place. -> (fn(params, cache, batch,
    pos) -> (logits [B,V], cache), cache_defs)."""
    if spec.plan is not None:
        raise NotImplementedError("memory plans are not ported yet")
    defs = tr.cache_defs(model.cfg, shape.global_batch, shape.seq_len)

    def decode(params, cache, batch, pos: int):
        return model.decode_step(params, cache, batch, pos)

    return decode, defs


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
    so the scales page too. Without an arena the caches stay
    slot-contiguous [B, seq_len, ...]. The caches are updated in place.

    -> (fn(params, cache, batch, positions, active) -> (logits [B,V],
    cache), cache_defs): cache_defs is the tree of ParamDefs giving the
    cache layout fn expects."""
    kv_dtype = spec.resolved_kv_dtype()
    defs = tr.cache_defs(model.cfg, shape.global_batch, shape.seq_len)
    if kvquant.is_int8(kv_dtype):
        defs = kvquant.quantize_cache_defs(defs, shape.seq_len)
    page_size = None
    if spec.arena is not None:
        defs = paging.page_cache_defs(defs, shape.seq_len, spec.arena)
        page_size = spec.arena.page_size

    def decode(params, cache, batch, positions, active):
        return model.decode_slots(params, cache, batch, positions, active,
                                  page_size=page_size)

    return decode, defs
