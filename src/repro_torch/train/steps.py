"""Step construction: the train step in the JAX package's paper-faithful
mode (DDL allreduce over the ranks of a data-parallel mesh, replicated
optimizer), and for the serve path the whole-batch prefill and decode
steps of the static loop and the serve engine's slot decode step. The
zero1 step comes in a later slice.

PyTorch runs eagerly, so a step is a plain callable: no jit, no shardings
and no buffer donation — where the JAX package donates a cache or a train
state, the step updates it in place instead.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.config.base import ShapeConfig, TrainConfig
from repro_torch.core.ddl.allreduce import ddl_reduce_tree
from repro_torch.core.ddl.overlap import make_stack_hooks
from repro_torch.launch.mesh import Mesh, dp_axes, make_mesh, mesh_axis_sizes
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
# Train step (paper-faithful mode: DDL allreduce, replicated optimizer)
# ---------------------------------------------------------------------------

def _resolve_overlap(tcfg: TrainConfig, dp_total: int) -> bool:
    """The DDLConfig knob, else overlap; forced off with nothing to reduce
    (dp 1) or no reduction at all, as in the JAX package (whose
    `overlap_grads` argument of build_train_step and memory plan's
    recommendation, ranked above the knob and below it, the port does not
    take yet)."""
    if tcfg.ddl.mode == "none" or dp_total <= 1:
        return False
    if tcfg.ddl.overlap_grads is not None:
        return bool(tcfg.ddl.overlap_grads)
    return True


def _split_stack_grads(tree):
    """-> (stack-group subtrees, everything else with empty stacks)."""
    dec = tree["decoder"]
    stacks = {k: v for k, v in dec.items() if k.startswith("stack")}
    rest = {**tree, "decoder": {k: v for k, v in dec.items()
                                if not k.startswith("stack")}}
    return stacks, rest


def _merge_stack_grads(rest, stacks):
    return {**rest, "decoder": {**rest["decoder"], **stacks}}


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


def build_train_step(model: Model, tcfg: TrainConfig, plan: Any = None,
                     mesh: Optional[Mesh] = None):
    """-> step_fn(state, batch) -> (state, metrics), for this rank of
    `mesh` (default: `make_mesh(tcfg.mesh)`), whose batch is the rank's
    rows of the global batch.

    The loss and its grads over every param leaf (`torch.autograd.grad`),
    with m = tcfg.microbatches > 1 accumulated in f32 over the microbatches
    and divided by m, as the JAX package's scan does. On a mesh of several
    data-parallel ranks the grads are then DDL-reduced to their mean over
    the ranks (`core/ddl`): with the overlapped backward (the default, m ==
    1), the decoder stack's layer by layer inside the backward and the rest
    (embedding, final norm, head) after it; otherwise the whole tree after
    the backward. Then the grads are clipped to tcfg.grad_clip by their
    global norm and the optimizer steps with the lr of
    `warmup_cosine(state.step)`. The state is updated in place and
    returned in a new TrainState with step + 1. The metrics are f32
    scalars on the device: loss, grad_norm, lr, ce and aux, the loss, ce
    and aux as means over the ranks. Every rank ends the step with the
    same params. On one device every reduction is the identity, as the
    JAX package's collectives over axes of size 1 are.

    ddl.mode "none" leaves the grads unreduced, as in the JAX package.
    ddl.mode "zero1", m > 1 with the overlapped backward (the JAX
    package's sharded accumulator) and a memory plan (LMS) are not ported
    yet and raise; so does a tensor-parallel `model` axis (`make_mesh`)."""
    if tcfg.ddl.mode == "zero1":
        raise NotImplementedError("DDL zero1 is not ported yet")
    if plan is not None:
        raise NotImplementedError("memory plans (LMS) are not ported yet")
    mesh = make_mesh(tcfg.mesh) if mesh is None else mesh
    sizes = mesh_axis_sizes(mesh)
    dpa = dp_axes(mesh)
    data_size = sizes.get("data", 1)
    pod_size = sizes.get("pod", 1)
    pod_axis = "pod" if "pod" in sizes and pod_size > 1 else None
    mean_over = data_size * pod_size
    ddl = tcfg.ddl
    _, opt_update = OPTIMIZERS[tcfg.optimizer]
    sched = SCHEDULES["warmup_cosine"]
    m = tcfg.microbatches
    overlap = _resolve_overlap(tcfg, mean_over)
    if overlap and m > 1:
        raise NotImplementedError(
            f"microbatches={m} with the overlapped backward (the sharded "
            "microbatch accumulator) is not ported yet; pass "
            "DDLConfig(overlap_grads=False)")
    reduce = dict(mesh=mesh, data_axis="data", pod_axis=pod_axis,
                  data_size=data_size, pod_size=pod_size)
    hooks = make_stack_hooks(["stack0"], ddl, **reduce) if overlap else None

    def loss_and_grads(params, batch):
        """-> (loss, {"ce", "aux"}, grads): detached tensors; grads in the
        params' dtypes, or f32 when accumulated over microbatches. With
        the hooks the decoder stack's grads come back reduced."""
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        flat = tree_leaves(leaves)
        if m == 1:
            loss, mets = model.loss(leaves, batch, grad_hooks=hooks)
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

    def reduce_grads(grads):
        """The DDL mean over the ranks of what the hooks left unreduced."""
        if mean_over == 1:
            return grads
        if not overlap:
            return ddl_reduce_tree(grads, ddl, **reduce)[0]
        stacks, rest = _split_stack_grads(grads)
        rest, _ = ddl_reduce_tree(rest, ddl, **reduce)
        return _merge_stack_grads(rest, stacks)

    def step_fn(state: TrainState, batch):
        loss, mets, grads = loss_and_grads(state.params, batch)
        with torch.no_grad():
            grads = reduce_grads(grads)
            lr = sched(state.step, base_lr=tcfg.learning_rate,
                       warmup_steps=tcfg.warmup_steps,
                       total_steps=tcfg.total_steps)
            grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
            params, opt = opt_update(grads, state.opt, state.params, lr=lr,
                                     beta1=tcfg.beta1, beta2=tcfg.beta2,
                                     weight_decay=tcfg.weight_decay)
            # the means over the ranks, in one collective per axis
            loss, ce, aux = mesh.pmean(torch.stack([loss, mets["ce"], mets["aux"]]), dpa)
            metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr, "ce": ce, "aux": aux}
        return TrainState(state.step + 1, params, opt), metrics

    return step_fn


def init_train_state(model: Model, tcfg: TrainConfig, seed: int,
                     device) -> TrainState:
    """Params from `model.init(seed, device)` and a fresh optimizer state."""
    params = model.init(seed, device)
    opt_init, _ = OPTIMIZERS[tcfg.optimizer]
    return TrainState(torch.zeros((), dtype=torch.int32, device=device),
                      params, opt_init(params))
