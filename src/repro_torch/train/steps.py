"""Step construction: the train step in the JAX package's paper-faithful
mode (DDL allreduce over the ranks of a data-parallel mesh, replicated
optimizer), resident or under an LMS memory plan (on one device or on
every rank of the mesh: LMS + DDL), and for the serve path the
whole-batch prefill and decode steps of the static loop and the serve
engine's slot decode step. The zero1 step comes in a later slice.

PyTorch runs eagerly, so a step is a plain callable: no jit, no shardings
and no buffer donation — where the JAX package donates a cache or a train
state, the step updates it in place instead.

Host residency is executed for every class the plan's SwapSchedule
streams (DESIGN.md §6): the decoder stack's params by the layer-streaming
executor (`models/transformer.py`), the optimizer state by the streamed
sweep (`_streamed_opt_update`: a layer's (mu, nu, master) slice copied in
while the previous one updates, then written back), and the grads, on a
mesh of several ranks, by the backward's host sink: each layer's grads
reduced over the ranks by the DDL hook's queue while the backward goes
on, into pinned host memory, read back a layer at a time by the sweep.
The state is placed where the plan says (`init_train_state(plan=)`,
`place_train_state`): the host classes, and the sunk grads, in one pinned
arena (`core/lms/offload.PinnedArena`).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.config.base import DDLConfig, ShapeConfig, TrainConfig
from repro_torch.core.ddl.allreduce import ddl_reduce_tree
from repro_torch.core.ddl.overlap import make_stack_hooks
from repro_torch.core.lms import offload as off
from repro_torch.core.lms.planner import MemoryPlan, OPT_REST_CHUNKS, plan_to_policy
from repro_torch.core.lms.policies import Policy
from repro_torch.launch.mesh import Mesh, dp_axes, make_mesh, mesh_axis_sizes
from repro_torch.models import kvquant, paging
from repro_torch.models import transformer as tr
from repro_torch.models.layers import DTYPES, init_pieces
from repro_torch.models.model import Model
from repro_torch.optim.adamw import (OPTIMIZERS, AdamState, SGDState, StackSquares,
                                     _slices, adamw_slice_update, clip_by_global_norm,
                                     clip_leaf, clip_scale, leaf_squares, norm_of,
                                     sgdm_slice_update)
from repro_torch.optim.schedule import SCHEDULES
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class TrainState(NamedTuple):
    step: torch.Tensor    # int32 scalar on the params' device
    params: Any
    opt: Any
    # the decoder stack's grads tree in pinned host memory, written by the
    # backward's host sink each step, when the plan sinks grads; else None
    grads: Any = None


SERVE_PLANS = "memory plans for serving (LMS serve plans) are not ported yet"


@dataclass(frozen=True)
class StepSpec:
    """The argument surface of the `build_*_step` functions. kv_dtype=None
    resolves to model width. plan: the train step's memory plan; serve
    plans are not ported yet. overlap_grads: the train step's overlapped
    backward, above the DDLConfig knob (`_resolve_overlap`). cache_len:
    capacity of the cache the prefill step emits."""
    plan: Optional[MemoryPlan] = None
    kv_dtype: Optional[str] = None
    arena: Optional[paging.PageArena] = None
    overlap_grads: Optional[bool] = None
    cache_len: Optional[int] = None

    def resolved_kv_dtype(self) -> str:
        """Explicit kv_dtype > model width, validated so a typo raises here."""
        if self.plan is not None:
            raise NotImplementedError(SERVE_PLANS)
        if self.kv_dtype is not None:
            return kvquant.validate_kv_dtype(self.kv_dtype)
        return "model"

    def ddl_for(self, tcfg: TrainConfig) -> DDLConfig:
        """The DDL config the step executes with: a calibrated plan's
        tuned_bucket_mb stands in for bucket_mb=None (auto); a bucket the
        user gave always wins."""
        if (tcfg.ddl.bucket_mb is None and self.plan is not None
                and self.plan.calibrated and self.plan.tuned_bucket_mb):
            return dataclasses.replace(tcfg.ddl, bucket_mb=self.plan.tuned_bucket_mb)
        return tcfg.ddl


def _param_stream(plan: Optional[MemoryPlan]):
    """The plan's SwapSchedule iff it streams params: the switch that turns
    host residency (a placement) into layer streaming."""
    if plan is None or plan.swap_schedule is None:
        return None
    return plan.swap_schedule if plan.swap_schedule.streams_params else None


def _opt_stream(plan: Optional[MemoryPlan]):
    """The plan's SwapSchedule iff it streams the optimizer class: the
    switch that replaces the resident opt_update with the streamed sweep."""
    if plan is None or plan.swap_schedule is None:
        return None
    return plan.swap_schedule if plan.swap_schedule.streams_optimizer else None


def build_prefill_step(model: Model, shape: ShapeConfig,
                       spec: StepSpec = StepSpec()):
    """Whole-prompt prefill of `shape.global_batch` prompts of
    `shape.seq_len` tokens into a cache of `spec.cache_len` positions
    (default: the prompt), so serving prefills straight into the
    decode-capacity cache. -> (fn(params, batch) -> (last-token logits
    [B,V], cache), cache_defs)."""
    if spec.plan is not None:
        raise NotImplementedError(SERVE_PLANS)
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
        raise NotImplementedError(SERVE_PLANS)
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

def _resolve_overlap(arg: Optional[bool], plan: Optional[MemoryPlan],
                     tcfg: TrainConfig, dp_total: int) -> bool:
    """The builder's argument (`StepSpec.overlap_grads`) > the DDLConfig
    knob > the plan's priced recommendation > overlap; forced off with
    nothing to reduce (dp 1) or no reduction at all, as in the JAX
    package."""
    if tcfg.ddl.mode == "none" or dp_total <= 1:
        return False
    if arg is not None:
        return bool(arg)
    if tcfg.ddl.overlap_grads is not None:
        return bool(tcfg.ddl.overlap_grads)
    if plan is not None and plan.overlap_grads is not None:
        return bool(plan.overlap_grads)
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


# ---------------------------------------------------------------------------
# Streamed optimizer sweep (residency["optimizer"] == "host", executed)
# ---------------------------------------------------------------------------

def _rest_chunks(n: int) -> int:
    """Flat chunks of an unstacked leaf of n elements in the sweep: one
    below 2**20 elements, else gcd(n, OPT_REST_CHUNKS), the rule the
    planner prices with."""
    if n < (1 << 20):
        return 1
    return math.gcd(n, OPT_REST_CHUNKS)


def _stack_path(path) -> bool:
    return tuple(path[:2]) == ("decoder", "stack0")


def _paths(tree, prefix=()):
    """[(path, leaf)] in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _paths(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _pipelined(items, depth: int, fetch, update) -> None:
    """update(item, fetched) for each item in order, with fetch(item) (a
    dict of offload.Pending) issued up to `depth` items ahead, so the copy
    of item i+1 is in flight while item i updates."""
    pending = {}
    for i, item in enumerate(items):
        for j in range(i, min(i + depth, len(items))):
            if j not in pending:
                pending[j] = fetch(items[j])
        update(item, {k: p.wait() for k, p in pending.pop(i).items()})


def _streamed_opt_update(optimizer: str, grads, opt_state, params, *, lr,
                         beta1, beta2, weight_decay, schedule, params_host: bool,
                         device, clip=None, grads_host: bool = False):
    """The optimizer update as a streamed sweep (JAX `_streamed_opt_update`).

    The optimizer state lies in pinned host memory. For each layer of the
    decoder stack the layer's slice of the state (AdamW's f32 mu, nu and
    master; momentum SGD's momentum, with the layer's params when they are
    host-resident too) is copied in, `prefetch_depth` layers ahead, updated
    by the same per-slice kernels the resident path uses
    (`optim/adamw.py`), and written straight back; a host-resident layer's
    new bf16 params are written back to the host as well. The unstacked
    rest (embedding, head, final norm: on the device) updates in
    `_rest_chunks` flat chunks of its state, two in flight, the same way.
    grads_host: the stack's grads lie in pinned host memory (the backward's
    host sink) and come in with their layer's state. clip: the clip factor
    (`clip_scale` of the global norm), applied to each slice of the grads
    as it updates (`clip_leaf`, as JAX's sweep does); None: the grads come
    in clipped. Elementwise math does not depend on how it is sliced, so
    the result equals the resident `opt_update`'s of the clipped grads
    bitwise. -> (params, state), updated in place."""
    step = opt_state.step + 1
    if optimizer == "adamw":
        sf = step.float()
        b1c = 1.0 - beta1 ** sf
        b2c = 1.0 - beta2 ** sf
        states = (opt_state.mu, opt_state.nu, opt_state.master)
    elif optimizer == "sgdm":
        states = (opt_state.momentum,)
    else:
        raise ValueError(f"no streamed sweep for optimizer {optimizer!r}")

    def update(g, st, p):
        """One slice, in place: st the state leaves on the device, p the
        params' (on the device)."""
        if optimizer == "adamw":
            for gs, ms, vs, mps, ps in _slices(g, *st, p):
                gs = gs if clip is None else clip_leaf(gs, clip)
                adamw_slice_update(gs, ms, vs, mps, lr=lr, beta1=beta1, beta2=beta2,
                                   b1c=b1c, b2c=b2c, weight_decay=weight_decay)
                ps.copy_(mps)
        else:
            for gs, ms, ps in _slices(g, *st, p):
                gs = gs if clip is None else clip_leaf(gs, clip)
                sgdm_slice_update(gs, ms, ps, lr=lr, beta1=beta1,
                                  weight_decay=weight_decay)

    stack = params["decoder"]["stack0"]
    n = tree_leaves(stack)[0].shape[0]
    gstack = grads["decoder"]["stack0"]
    sstacks = [s["decoder"]["stack0"] for s in states]

    def fetch_layer(i):
        out = {"state": off.stream_layer_to_device(
            {str(k): tr._layer(s, i) for k, s in enumerate(sstacks)}, device, cls="optimizer")}
        if params_host and optimizer == "sgdm":
            out["params"] = off.stream_layer_to_device(tr._layer(stack, i), device, cls="params")
        if grads_host:
            out["grads"] = off.stream_layer_to_device(tr._layer(gstack, i), device, cls="grads")
        return out

    def update_layer(i, fetched):
        st = fetched["state"]
        p_dev = tr._layer(stack, i)
        if params_host:
            # AdamW writes the params from the master copy: no copy in
            p_dev = fetched["params"] if optimizer == "sgdm" else tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), p_dev)
        g_dev = fetched["grads"] if grads_host else tr._layer(gstack, i)
        st_leaves = [tree_leaves(st[str(k)]) for k in range(len(states))]
        for j, (g, p) in enumerate(zip(tree_leaves(g_dev), tree_leaves(p_dev))):
            update(g, [sl[j] for sl in st_leaves], p)
        off.stream_layer_to_host(st, {str(k): tr._layer(s, i) for k, s in enumerate(sstacks)},
                                 cls="optimizer")
        if params_host:
            off.stream_layer_to_host(p_dev, tr._layer(stack, i), cls="params")

    _pipelined(list(range(n)), tr._stream_depth(schedule, n), fetch_layer, update_layer)

    rest = [(path, leaf) for path, leaf in _paths(params) if not _stack_path(path)]
    chunks = []
    for path, leaf in rest:
        c = _rest_chunks(leaf.numel())
        chunks += [(path, k, c) for k in range(c)]

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def piece(t, k, c):
        flat = t.view(-1)
        size = flat.numel() // c
        return flat[k * size:(k + 1) * size]

    def fetch_chunk(item):
        path, k, c = item
        return {"state": off.stream_layer_to_device({str(j): piece(at(s, path), k, c)
                                                     for j, s in enumerate(states)},
                                                    device, cls="optimizer")}

    def update_chunk(item, fetched):
        path, k, c = item
        st = fetched["state"]
        update(piece(at(grads, path), k, c), [st[str(j)] for j in range(len(states))],
               piece(at(params, path), k, c))
        off.stream_layer_to_host(st, {str(j): piece(at(s, path), k, c)
                                      for j, s in enumerate(states)}, cls="optimizer")

    _pipelined(chunks, 2, fetch_chunk, update_chunk)
    off.fence(device)
    if optimizer == "adamw":
        return params, AdamState(step, *states)
    return params, SGDState(step, *states)


# ---------------------------------------------------------------------------
# State placement (the counterpart of JAX `make_state_shardings`)
# ---------------------------------------------------------------------------

def _host_classes(plan: Optional[MemoryPlan]):
    """-> (stack params on host, optimizer state on host) by the plan's
    residency. The unstacked params (embedding, head, final norm) stay on
    the device whatever it says: the plan prices them inside `params`."""
    res = plan.residency if plan is not None else {}
    return res.get("params") == "host", res.get("optimizer") == "host"


def _grads_host(plan: Optional[MemoryPlan]) -> bool:
    """The stack's grads go to pinned host memory: the plan puts grads on
    the host and the streamed optimizer sweep is there to read them back a
    layer at a time (the JAX package's condition; a resident update would
    read the whole sunk tree back at once)."""
    return (plan is not None and plan.residency.get("grads") == "host"
            and _opt_stream(plan) is not None)


class _Placer:
    """Allocates a train state's leaves where a plan puts them: the host
    ones from one pinned arena of `host_bytes`."""

    def __init__(self, device, host_bytes: int):
        self.device = device
        self.arena = off.pinned_arena(host_bytes, device) if host_bytes else None

    def take(self, shape, dtype, host: bool):
        if not host:
            return torch.zeros(shape, dtype=dtype, device=self.device)
        return self.arena.take(shape, dtype)


def _state_layout(paths, optimizer, params_host, opt_host, grads_host=False):
    """-> (host bytes, [(path, shape, dtype, params on host)]); with
    grads_host the stack's grads (in the params' dtypes) are in the host
    bytes too."""
    per = {"adamw": 3, "sgdm": 1}[optimizer]
    total, out = 0, []
    for path, shape, dtype in paths:
        n = math.prod(shape)
        nbytes = off.PinnedArena.padded(n * torch.empty((), dtype=dtype).element_size())
        ph = params_host and _stack_path(path)
        if ph:
            total += nbytes
        if grads_host and _stack_path(path):
            total += nbytes
        if opt_host:
            total += per * off.PinnedArena.padded(4 * n)
        out.append((path, shape, dtype, ph))
    return total, out


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _def_paths(defs, prefix=()):
    """[(path, ParamDef)] in `tree_init` order (dict insertion order)."""
    if isinstance(defs, dict):
        return [pd for k, v in defs.items() for pd in _def_paths(v, prefix + (k,))]
    return [(prefix, defs)]


def _placed_state(optimizer, paths, device, params_host, opt_host, fill,
                  grads_host=False):
    """A TrainState laid out by the plan; fill(index, path, p, states)
    writes each leaf's values. With grads_host the state carries the
    stack's grads tree in the arena (zeros), for the backward's host
    sink."""
    host_bytes, layout = _state_layout(paths, optimizer, params_host, opt_host,
                                       grads_host)
    placer = _Placer(device, host_bytes)
    nstate = 3 if optimizer == "adamw" else 1
    params, states, grads = {}, [{} for _ in range(nstate)], {}
    for ix, (path, shape, dtype, ph) in enumerate(layout):
        p = placer.take(shape, dtype, ph)
        st = [placer.take(shape, torch.float32, opt_host) for _ in range(nstate)]
        fill(ix, path, p, st)
        _set(params, path, p)
        for tree, t in zip(states, st):
            _set(tree, path, t)
        if grads_host and _stack_path(path):
            _set(grads, path[2:], placer.take(shape, dtype, True))
    step = torch.zeros((), dtype=torch.int32, device=device)
    opt = (AdamState(step.clone(), *states) if optimizer == "adamw"
           else SGDState(step.clone(), *states))
    return TrainState(step, params, opt, grads if grads_host else None)


def place_train_state(state: TrainState, plan: Optional[MemoryPlan], device) -> TrainState:
    """A copy of `state` placed as the plan says: the stack's params in
    pinned host memory when they stream, the optimizer state there when it
    streams, and a grads tree for the stack there when the plan sinks
    grads (`_grads_host`), everything else on `device`."""
    device = torch.device(device)
    params_host, opt_host = _host_classes(plan)
    adam = isinstance(state.opt, AdamState)
    src_states = ((state.opt.mu, state.opt.nu, state.opt.master) if adam
                  else (state.opt.momentum,))
    src = _paths(state.params)
    paths = [(path, tuple(t.shape), t.dtype) for path, t in src]

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def fill(ix, path, p, st):
        p.copy_(src[ix][1])
        for dst, s in zip(st, src_states):
            dst.copy_(at(s, path))

    out = _placed_state("adamw" if adam else "sgdm", paths, device, params_host,
                        opt_host, fill, _grads_host(plan))
    step = state.step.to(device).clone()
    opt = out.opt._replace(step=state.opt.step.to(device).clone())
    return TrainState(step, out.params, opt, out.grads)


def build_train_step(model: Model, tcfg: TrainConfig, plan: Optional[MemoryPlan] = None,
                     mesh: Optional[Mesh] = None, spec: Optional[StepSpec] = None):
    """-> step_fn(state, batch) -> (state, metrics), for this rank of
    `mesh` (default: `make_mesh(tcfg.mesh)`), whose batch is the rank's
    rows of the global batch.

    The loss and its grads over every param leaf (`torch.autograd.grad`),
    with m = tcfg.microbatches > 1 accumulated in f32 over the microbatches
    and divided by m, as the JAX package's scan does. On a mesh of several
    data-parallel ranks the grads are then DDL-reduced to their mean over
    the ranks (`core/ddl`): with the overlapped backward (m == 1; on by
    default, `_resolve_overlap`), the decoder stack's layer by layer inside
    the backward and the rest (embedding, final norm, head) after it;
    otherwise the whole tree after the backward. Then the grads are
    clipped to tcfg.grad_clip by their global norm and the optimizer steps
    with the lr of `warmup_cosine(state.step)`. The state is updated in
    place and returned in a new TrainState with step + 1. The metrics are
    f32 scalars on the device: loss, grad_norm, lr, ce and aux, the loss,
    ce and aux as means over the ranks. Every rank ends the step with the
    same params. On one device every reduction is the identity, as the
    JAX package's collectives over axes of size 1 are.

    plan (or spec.plan): an LMS memory plan (`core/lms/planner.py`). Its
    policy (`plan_to_policy`) decides per tagged activation of each layer
    whether it is saved, offloaded to pinned host memory or recomputed;
    when it streams params, the state's stack lies in pinned host memory
    (`init_train_state(plan=)`) and each layer is copied in for its
    forward and again for its backward; when it streams the optimizer, the
    update is the streamed sweep (`_streamed_opt_update`), with the clip
    inside it. The stack's grads are written into a grads tree layer by
    layer. On a mesh of several ranks (LMS + DDL) with the overlapped
    backward each layer's grads go to the DDL hook's reduction queue
    (`core/ddl/overlap.ReductionQueue`), which reduces them on a thread of
    its own while the backward goes on and writes their mean into that
    tree: on the device, or, when the plan puts grads on the host
    (`_grads_host`), into the state's pinned grads tree (the backward's
    host sink), read back a layer at a time by the sweep. Without the
    overlapped backward a plan's sunk grads are placed on the host after
    the tree pass, as in the JAX package. Streamed and resident steps give
    the same state bitwise, on one rank or several.

    ddl.mode "none" leaves the grads unreduced, as in the JAX package.
    ddl.mode "zero1" and m > 1 with the overlapped backward (the JAX
    package's sharded accumulator) are not ported yet and raise; so does a
    tensor-parallel `model` axis (`make_mesh`), and, under a plan, m > 1,
    params on the host with the optimizer on the device, and the Mamba-2
    stack."""
    spec = StepSpec() if spec is None else spec
    if spec.plan is None and plan is not None:
        spec = dataclasses.replace(spec, plan=plan)
    plan = spec.plan
    if tcfg.ddl.mode == "zero1":
        raise NotImplementedError("DDL zero1 is not ported yet")
    mesh = make_mesh(tcfg.mesh) if mesh is None else mesh
    sizes = mesh_axis_sizes(mesh)
    dpa = dp_axes(mesh)
    data_size = sizes.get("data", 1)
    pod_size = sizes.get("pod", 1)
    pod_axis = "pod" if "pod" in sizes and pod_size > 1 else None
    mean_over = data_size * pod_size
    ddl = spec.ddl_for(tcfg)
    _, opt_update = OPTIMIZERS[tcfg.optimizer]
    sched = SCHEDULES["warmup_cosine"]
    m = tcfg.microbatches
    overlap = _resolve_overlap(spec.overlap_grads, plan, tcfg, mean_over)
    if overlap and m > 1:
        raise NotImplementedError(
            f"microbatches={m} with the overlapped backward (the sharded "
            "microbatch accumulator) is not ported yet; pass "
            "DDLConfig(overlap_grads=False)")
    if plan is not None:
        _check_plan(plan, model, m)
    # a plan that assigns nothing recomputes every activation (JAX:
    # jax.checkpoint with policy None)
    policy = (plan_to_policy(plan) or Policy()) if plan is not None else None
    stream = _param_stream(plan)
    opt_stream = _opt_stream(plan)
    params_host = _host_classes(plan)[0]
    grads_host = _grads_host(plan)
    reduce = dict(mesh=mesh, data_axis="data", pod_axis=pod_axis,
                  data_size=data_size, pod_size=pod_size)
    hooks = (make_stack_hooks(["stack0"], ddl, **reduce,
                              sink=off.HOST if grads_host else None)
             if overlap else None)
    queue = hooks["stack0"].queue if hooks is not None and plan is not None else None
    layers = model.cfg.num_layers

    def lms_loss_and_grads(state, batch):
        """Under a plan: the stack is not differentiated through autograd;
        the LMS executor writes its grads into a grads tree (zeros on the
        device, so a param no layer used keeps a zero grad; the state's
        pinned tree under the host sink, every layer written each step),
        through the reduction queue with the overlapped backward, which is
        drained before this returns. -> (..., the stack's per-slice sums of
        squares when the queue made them, else None)."""
        stacks, rest = _split_stack_grads(state.params)
        leaves = tree_map(lambda p: p.detach().requires_grad_(), rest)
        device = tree_leaves(leaves)[0].device
        sunk = queue is not None and grads_host
        if sunk:
            gstack = _sunk_grads(state)
        else:
            gstack = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device),
                              stacks["stack0"])
        squares = StackSquares([tuple(t.shape) for t in tree_leaves(gstack)]) if sunk else None
        if queue is not None:
            queue.open(device, tr._stream_depth(plan.swap_schedule, layers), squares)
        try:
            loss, mets = model.loss(_merge_stack_grads(leaves, stacks), batch,
                                    policy=policy, stream=stream, stack_grads=gstack,
                                    grad_hooks=hooks)
            grads = torch.autograd.grad(loss, tree_leaves(leaves))
        except BaseException:
            if queue is not None:
                queue.abandon()
            raise
        if queue is not None:
            queue.drain(layers)
        return (loss.detach(), {k: v.detach() for k, v in mets.items()},
                _merge_stack_grads(tree_unflatten(rest, grads), {"stack0": gstack}),
                squares.squares() if sunk else None)

    def loss_and_grads(state, batch):
        """-> (loss, {"ce", "aux"}, grads, stack squares or None): detached
        tensors; grads in the params' dtypes, or f32 when accumulated over
        microbatches. With the hooks the decoder stack's grads come back
        reduced."""
        if plan is not None:
            return lms_loss_and_grads(state, batch)
        params = state.params
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        flat = tree_leaves(leaves)
        if m == 1:
            loss, mets = model.loss(leaves, batch, grad_hooks=hooks)
            grads = torch.autograd.grad(loss, flat)
            return (loss.detach(), {k: v.detach() for k, v in mets.items()},
                    tree_unflatten(params, grads), None)
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
        return (l_acc / m, {k: v / m for k, v in m_acc.items()},
                tree_unflatten(params, grads), None)

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
        loss, mets, grads, stack_squares = loss_and_grads(state, batch)
        with torch.no_grad():
            grads = reduce_grads(grads)
            lr = sched(state.step, base_lr=tcfg.learning_rate,
                       warmup_steps=tcfg.warmup_steps,
                       total_steps=tcfg.total_steps)
            if opt_stream is not None:
                # the clip's norm now; its scaling inside the sweep, slice
                # by slice, as the JAX package's streamed sweep
                gnorm = _global_norm_streamed(grads, stack_squares)
                scale = clip_scale(gnorm, tcfg.grad_clip)
                if grads_host and stack_squares is None:
                    # no queue to sink each layer: place the reduced stack
                    # on the host after the tree pass (JAX's fallback)
                    stacks, rest = _split_stack_grads(grads)
                    host = _sunk_grads(state)
                    off.stream_layer_to_host(stacks["stack0"], host, cls="grads")
                    off.fence(state.step.device)
                    grads = _merge_stack_grads(rest, {"stack0": host})
                params, opt = _streamed_opt_update(
                    tcfg.optimizer, grads, state.opt, state.params, lr=lr,
                    beta1=tcfg.beta1, beta2=tcfg.beta2,
                    weight_decay=tcfg.weight_decay, schedule=opt_stream,
                    params_host=params_host, device=state.step.device, clip=scale,
                    grads_host=grads_host)
            else:
                grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
                params, opt = opt_update(grads, state.opt, state.params, lr=lr,
                                         beta1=tcfg.beta1, beta2=tcfg.beta2,
                                         weight_decay=tcfg.weight_decay)
            # the means over the ranks, in one collective per axis
            loss, ce, aux = mesh.pmean(torch.stack([loss, mets["ce"], mets["aux"]]), dpa)
            metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr, "ce": ce, "aux": aux}
        return state._replace(step=state.step + 1, params=params, opt=opt), metrics

    # the LMS + DDL backward's reduction queue (its times of the last
    # step), None without one
    step_fn.queue = queue
    return step_fn


def _sunk_grads(state: TrainState):
    """The state's pinned grads tree of the stack, which a plan that sinks
    grads writes into."""
    if state.grads is None:
        raise ValueError("the plan puts grads on the host: place the state with it "
                         "(init_train_state(plan=), place_train_state)")
    return state.grads


def _global_norm_streamed(grads, stack_squares=None) -> torch.Tensor:
    """`global_norm` of the grads tree whose stack's per-slice sums of
    squares may come made (`stack_squares`, in the stack's leaf order: the
    reduction queue summed them while the layers were on the device, and
    the grads now lie on the host); the other leaves' are summed here."""
    stack = iter(stack_squares or ())
    return norm_of([next(stack) if stack_squares is not None and _stack_path(path)
                    else leaf_squares(leaf) for path, leaf in _paths(grads)])


def _check_plan(plan: MemoryPlan, model: Model, m: int) -> None:
    """Raise for what a plan asks that the port does not execute yet."""
    res = plan.residency
    unported = {
        "LMS with microbatches > 1": m > 1,
        "params on the host with the optimizer state on the device":
            res.get("params") == "host" and res.get("optimizer") != "host",
        "the Mamba-2 stack under a plan": tr._check_kinds(model.cfg) != "attn",
    }
    for what, on in unported.items():
        if on:
            raise NotImplementedError(f"{what} is not ported yet")


def init_train_state(model: Model, tcfg: TrainConfig, seed: int,
                     device, plan: Optional[MemoryPlan] = None) -> TrainState:
    """Params from `model.init(seed, device)` and a fresh optimizer state.

    With a plan that puts params or the optimizer on the host, the state is
    built one leaf (a stacked leaf: one layer) at a time, on the device and
    copied out, so it never stands whole on the device: the stack's params
    and the optimizer state go to pinned host memory as the plan says
    (`_host_classes`), the rest to the device; a plan that sinks grads
    (`_grads_host`) also gets the stack's grads tree there. The values are
    `model.init(seed, device)`'s bitwise: the same draws from the same
    generator."""
    device = torch.device(device)
    params_host, opt_host = _host_classes(plan)
    if params_host or opt_host:
        defs = _def_paths(model.param_defs())
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        paths = [(path, d.shape, DTYPES[d.dtype]) for path, d in defs]

        def fill(ix, path, p, st):
            for i, piece in init_pieces(defs[ix][1], gen, device):
                p[i] = piece
                if tcfg.optimizer == "adamw":
                    st[2][i] = piece.float()
        return _placed_state(tcfg.optimizer, paths, device, params_host, opt_host, fill,
                             _grads_host(plan))
    params = model.init(seed, device)
    opt_init, _ = OPTIMIZERS[tcfg.optimizer]
    return TrainState(torch.zeros((), dtype=torch.int32, device=device),
                      params, opt_init(params))
