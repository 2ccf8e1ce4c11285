"""Step construction: the one-device train step (the JAX package's
paper-faithful mode on a mesh of one device), and for the serve path the
whole-batch prefill and decode steps of the static loop and the serve
engine's slot decode step. The zero1 step and the multi-device train step
come in later slices.

PyTorch runs eagerly, so a step is a plain callable: no jit, no shardings
and no buffer donation — where the JAX package donates a cache or a train
state, the step updates it in place instead.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.config.base import ShapeConfig, TrainConfig
from repro_torch.models import kvquant, paging
from repro_torch.models import transformer as tr
from repro_torch.models.model import Model
from repro_torch.optim.adamw import OPTIMIZERS, clip_by_global_norm
from repro_torch.optim.schedule import SCHEDULES
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class TrainState(NamedTuple):
    step: torch.Tensor    # int32 scalar on the params' device
    params: Any
    opt: Any


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


# ---------------------------------------------------------------------------
# Train step (paper-faithful mode: replicated optimizer; one device)
# ---------------------------------------------------------------------------

def _microbatch_split(batch, m: int):
    """[B, ...] -> [m, B/m, ...]. Only 0-d (scalar) leaves broadcast; any
    leaf whose leading dim `m` does not divide is an error."""
    def split(key, x):
        if x.dim() == 0:
            return x.expand((m,))
        if x.shape[0] % m == 0:
            return x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
        raise ValueError(
            f"microbatches={m} does not divide the leading dim of batch "
            f"leaf {key!r} with shape {tuple(x.shape)}; only 0-d leaves "
            "broadcast")
    return {k: split(k, v) for k, v in batch.items()}


def build_train_step(model: Model, tcfg: TrainConfig, plan: Any = None):
    """-> step_fn(state, batch) -> (state, metrics), for one device.

    The loss and its grads over every param leaf (`torch.autograd.grad`),
    with m = tcfg.microbatches > 1 accumulated in f32 over the microbatches
    and divided by m, as the JAX package's scan does; then the grads are
    clipped to tcfg.grad_clip by their global norm and the optimizer steps
    with the lr of `warmup_cosine(state.step)`. The state is updated in
    place and returned in a new TrainState with step + 1. The metrics are
    f32 scalars on the device: loss, grad_norm, lr, ce and aux. On one
    device the data-parallel mean of the grads and the loss is the
    identity, as the JAX package's `pmean` over an axis of size 1 is.

    A tcfg.mesh of more than one device, ddl.mode "zero1", compress_dcn
    and a memory plan (LMS) are not ported yet and raise."""
    mesh = tcfg.mesh
    if mesh.num_devices > 1:
        raise NotImplementedError(
            f"a mesh of {mesh.num_devices} devices {mesh.shape} is not ported "
            "yet; the port trains on one device (mesh 1x1)")
    if tcfg.ddl.mode == "zero1":
        raise NotImplementedError("DDL zero1 is not ported yet")
    if tcfg.ddl.compress_dcn:
        raise NotImplementedError("DDL compress_dcn is not ported yet")
    if plan is not None:
        raise NotImplementedError("memory plans (LMS) are not ported yet")
    _, opt_update = OPTIMIZERS[tcfg.optimizer]
    sched = SCHEDULES["warmup_cosine"]
    m = tcfg.microbatches

    def loss_and_grads(params, batch):
        """-> (loss, {"ce", "aux"}, grads): detached tensors; grads in the
        params' dtypes, or f32 when accumulated over microbatches."""
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        flat = tree_leaves(leaves)
        if m == 1:
            loss, mets = model.loss(leaves, batch)
            grads = torch.autograd.grad(loss, flat)
            return (loss.detach(), {k: v.detach() for k, v in mets.items()},
                    tree_unflatten(params, grads))
        parts = _microbatch_split(batch, m)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in flat]
        l_acc = torch.zeros((), dtype=torch.float32, device=flat[0].device)
        m_acc = {"ce": l_acc.clone(), "aux": l_acc.clone()}
        for i in range(m):
            loss, mets = model.loss(leaves, {k: v[i] for k, v in parts.items()})
            for a, g in zip(acc, torch.autograd.grad(loss, flat)):
                a.add_(g)
            l_acc = l_acc + loss.detach()
            m_acc = {k: m_acc[k] + mets[k].detach() for k in m_acc}
        grads = [a.div_(m) for a in acc]
        return l_acc / m, {k: v / m for k, v in m_acc.items()}, tree_unflatten(params, grads)

    def step_fn(state: TrainState, batch):
        loss, mets, grads = loss_and_grads(state.params, batch)
        with torch.no_grad():
            lr = sched(state.step, base_lr=tcfg.learning_rate,
                       warmup_steps=tcfg.warmup_steps,
                       total_steps=tcfg.total_steps)
            grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
            params, opt = opt_update(grads, state.opt, state.params, lr=lr,
                                     beta1=tcfg.beta1, beta2=tcfg.beta2,
                                     weight_decay=tcfg.weight_decay)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "ce": mets["ce"], "aux": mets["aux"]}
        return TrainState(state.step + 1, params, opt), metrics

    return step_fn


def init_train_state(model: Model, tcfg: TrainConfig, seed: int,
                     device) -> TrainState:
    """Params from `model.init(seed, device)` and a fresh optimizer state."""
    params = model.init(seed, device)
    opt_init, _ = OPTIMIZERS[tcfg.optimizer]
    return TrainState(torch.zeros((), dtype=torch.int32, device=device),
                      params, opt_init(params))
