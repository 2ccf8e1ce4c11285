"""Step construction: the train step in the JAX package's paper-faithful
mode (DDL allreduce over the ranks of a data-parallel mesh, replicated
optimizer) and in its zero1 mode (the AdamW state sharded over the data
ranks: `build_zero1_train_step`), each resident or under an LMS memory
plan (on one device or on every rank of the mesh: LMS + DDL), with
microbatches accumulated in f32 (on a mesh with the overlapped backward,
as reduce-scattered 1/|data| shards); and for the serve path the
whole-batch prefill and decode steps of the static loop and the serve
engine's slot decode step, each resident or under a serve plan (params
streamed from pinned host memory a layer at a time; the static loop's
decode also streams a host-resident KV cache).

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
arena (`core/lms/offload.PinnedArena`). One rule places the params: under
a plan that puts params on the host every leaf goes there, the stack and
the unstacked rest (embedding, final norm, head) alike (`_host_classes`), and
the model reads the rest from there (`models/rest.py`). Serve params
follow the same rule (`init_params`, `place_params`).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.config.base import DDLConfig, ShapeConfig, TrainConfig
from repro_torch.core.ddl import overlap as ddl_overlap
from repro_torch.core.ddl.allreduce import (PackSpec, ddl_reduce_tree,
                                            hierarchical_reduce_scatter_flat, pack,
                                            pack_block, pack_spec)
from repro_torch.core.ddl.overlap import make_stack_hooks
from repro_torch.core.lms import offload as off
from repro_torch.core.lms.planner import MemoryPlan, OPT_REST_CHUNKS, plan_to_policy
from repro_torch.core.lms.policies import Policy
from repro_torch.launch.mesh import Mesh, dp_axes, make_mesh, mesh_axis_sizes
from repro_torch.models import kvquant, paging
from repro_torch.models import rest as host_rest
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tr
from repro_torch.models.layers import DTYPES, init_pieces, local_pieces
from repro_torch.models.model import Model
from repro_torch.optim.adamw import (OPTIMIZERS, SLICE, AdamState, SGDState,
                                     StackSquares, _slices, adamw_slice_update,
                                     clip_by_global_norm, clip_leaf, clip_scale,
                                     leaf_squares, norm_of, sgdm_slice_update)
from repro_torch.optim.schedule import SCHEDULES
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


ZERO1_TP = "zero1 under tensor parallelism (a 'model' axis above 1) is not ported yet"


class TrainState(NamedTuple):
    step: torch.Tensor    # int32 scalar on the params' device
    params: Any
    opt: Any
    # the decoder stack's grads tree in pinned host memory, written by the
    # backward's host sink each step, when the plan sinks grads; else None
    grads: Any = None


@dataclass(frozen=True)
class StepSpec:
    """The argument surface of the `build_*_step` functions. plan: the
    step's memory plan (a train plan, or a serve plan from
    `plan(PlanRequest(serve=True, ...))`). kv_dtype=None resolves from the
    plan (`resolved_kv_dtype`). overlap_grads: the train step's
    overlapped backward, above the DDLConfig knob (`_resolve_overlap`).
    cache_len: capacity of the cache the prefill step emits."""
    plan: Optional[MemoryPlan] = None
    kv_dtype: Optional[str] = None
    arena: Optional[paging.PageArena] = None
    overlap_grads: Optional[bool] = None
    cache_len: Optional[int] = None

    def resolved_kv_dtype(self) -> str:
        """Explicit kv_dtype > the plan's paged-pool width > model width,
        validated so a typo raises here."""
        if self.kv_dtype is not None:
            return kvquant.validate_kv_dtype(self.kv_dtype)
        kv_paging = self.plan.kv_paging if self.plan is not None else None
        if kv_paging is not None:
            return kvquant.validate_kv_dtype(kv_paging.kv_dtype)
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


def _serving_stream(plan: Optional[MemoryPlan]):
    """The SwapSchedule of the serving sweeps, which stream params, and in
    the static loop's decode the KV cache, per layer."""
    return plan.swap_schedule if plan is not None else None


def _opt_stream(plan: Optional[MemoryPlan]):
    """The plan's SwapSchedule iff it streams the optimizer class: the
    switch that replaces the resident opt_update with the streamed sweep."""
    if plan is None or plan.swap_schedule is None:
        return None
    return plan.swap_schedule if plan.swap_schedule.streams_optimizer else None


def build_prefill_step(model: Model, shape: ShapeConfig,
                       spec: StepSpec = StepSpec(), mesh=None):
    """Whole-prompt prefill of `shape.global_batch` prompts of
    `shape.seq_len` tokens into a cache of `spec.cache_len` positions
    (default: the prompt), so serving prefills straight into the
    decode-capacity cache. Under a serve plan the params stream in a layer
    at a time when the plan puts them on the host, and the cache is
    emitted into host memory when it puts the KV cache there (JAX: the
    cache's host sharding), a layer at a time as the prefill makes it, for
    `build_decode_step` to stream. mesh: on a tensor-parallel mesh the
    params and the cache are this rank's blocks (`kv_heads` over `model`)
    and the logits leave whole on every rank, as each serve step's do.
    -> (fn(params, batch) -> (last-token logits [B,V], cache),
    cache_defs)."""
    cache_len = spec.cache_len or shape.seq_len
    mesh = shd.tp(mesh)
    defs = tr.cache_defs(model.cfg, shape.global_batch, cache_len, mesh)
    stream = _serving_stream(spec.plan)
    kv_host = spec.plan is not None and spec.plan.residency.get("kvcache") == "host"

    def prefill(params, batch):
        out = None
        if kv_host:
            pin = batch["tokens"].device.type == "cuda"
            out = tree_map(lambda d: torch.empty(d.shape, dtype=DTYPES[d.dtype],
                                                 pin_memory=pin), defs)
        return model.prefill(params, batch, cache_len=cache_len, stream=stream, out=out,
                             swap_out=kv_host, mesh=mesh)

    return prefill, defs


def build_decode_step(model: Model, shape: ShapeConfig,
                      spec: StepSpec = StepSpec(), mesh=None):
    """Whole-batch decode step of the static loop: `shape.global_batch`
    rows, each at the same position, against caches of `shape.seq_len`
    positions, which are updated in place. Under a serve plan the params
    stream in a layer at a time, and a cache in host memory (the plan
    streams the KV cache) comes in with them and goes back updated. ->
    (fn(params, cache, batch, pos) -> (logits [B,V], cache), cache_defs);
    on a tensor-parallel `mesh` as `build_prefill_step`."""
    mesh = shd.tp(mesh)
    defs = tr.cache_defs(model.cfg, shape.global_batch, shape.seq_len, mesh)
    stream = _serving_stream(spec.plan)

    def decode(params, cache, batch, pos: int):
        return model.decode_step(params, cache, batch, pos, stream=stream, mesh=mesh)

    return decode, defs


def build_slot_decode_step(model: Model, shape: ShapeConfig,
                           spec: StepSpec = StepSpec(), mesh=None):
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
    Under a serve plan the params stream in a layer at a time when it puts
    them on the host; the KV cache never streams here: the paged pool
    executes its host residency (JAX `build_slot_decode_step`).

    -> (fn(params, cache, batch, positions, active) -> (logits [B,V],
    cache), cache_defs): cache_defs is the tree of ParamDefs giving the
    cache layout fn expects (this rank's `kv_heads` block on a
    tensor-parallel `mesh`; the page table and the page dims are
    replicated, as the JAX package's `page_cache_abstract` keeps them)."""
    kv_dtype = spec.resolved_kv_dtype()
    mesh = shd.tp(mesh)
    defs = tr.cache_defs(model.cfg, shape.global_batch, shape.seq_len, mesh)
    if kvquant.is_int8(kv_dtype):
        defs = kvquant.quantize_cache_defs(defs, shape.seq_len)
    page_size = None
    if spec.arena is not None:
        defs = paging.page_cache_defs(defs, shape.seq_len, spec.arena)
        page_size = spec.arena.page_size
    stream = _serving_stream(spec.plan)

    def decode(params, cache, batch, positions, active):
        return model.decode_slots(params, cache, batch, positions, active,
                                  page_size=page_size, stream=stream, mesh=mesh)

    return decode, defs


def init_params(model: Model, seed: int, device, plan: Optional[MemoryPlan] = None,
                mesh=None):
    """Serve params: `model.init(seed, device)`, or, under a plan that puts
    params on the host, the same values built one leaf (a stacked leaf:
    one layer) at a time on the device and copied into one pinned arena
    (`_host_classes`), as `init_train_state(plan=)` builds training state:
    the same draws from the same generator, bitwise. On a tensor-parallel
    `mesh` this rank's blocks of those values (each rank pins its own)."""
    device = torch.device(device)
    tp = shd.tp(mesh)
    if not _host_classes(plan)[0]:
        return model.init(seed, device, mesh=tp)
    defs = _def_paths(model.param_defs())
    specs = _path_specs(model, defs, tp)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def fill(ix, p):
        for i, piece in local_pieces(defs[ix][1], gen, device, specs[ix], tp):
            p[i] = piece
    return _placed_params([(path, shd.local_shape(d.shape, sp, tp), DTYPES[d.dtype])
                           for (path, d), sp in zip(defs, specs)], device,
                          fill, model.param_defs())


def place_params(params, plan: Optional[MemoryPlan], device):
    """`params` placed as `init_params(plan=)` places them: in one pinned
    arena under a plan that puts params on the host, a leaf at a time;
    else on `device`."""
    device = torch.device(device)
    if not _host_classes(plan)[0]:
        return tree_map(lambda t: t.to(device), params)
    src = _paths(params)

    def fill(ix, p):
        p.copy_(src[ix][1])
    return _placed_params([(path, tuple(t.shape), t.dtype) for path, t in src], device,
                          fill, params)


def _placed_params(paths, device, fill, template):
    """A params tree with every leaf in one pinned arena; fill(index, p)
    writes leaf `index`'s values into p."""
    placer = _Placer(device, sum(_leaf_bytes(shape, dtype) for _, shape, dtype in paths))
    params = {}
    for ix, (path, shape, dtype) in enumerate(paths):
        p = placer.take(shape, dtype, True)
        fill(ix, p)
        _set(params, path, p)
    return _with_empty(params, template)


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


def _stacked_mask(tree):
    """A matching tree of bools: True on the leaves of the decoder's stack
    groups (the leaves the hooks reduce; their leading dim is the layer
    dim)."""
    def mark(sub, flag):
        return tree_map(lambda _: flag, sub)
    out = {k: mark(v, False) for k, v in tree.items() if k != "decoder"}
    out["decoder"] = {k: mark(v, k.startswith("stack")) for k, v in tree["decoder"].items()}
    return out


def _meta_params(model: Model, mesh=None):
    """The params' shapes and dtypes as a tree of meta tensors (no memory):
    what `shard_spec` and `pack_spec` lay out; this rank's blocks' on a
    tensor-parallel `mesh`."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=DTYPES[d.dtype], device="meta"),
                    model.local_param_defs(mesh))


def _tp_mesh(tcfg: TrainConfig, mesh=None):
    """The tensor-parallel mesh of a run (`sharding.tp`), or None: `mesh`
    when given, else this rank's coordinates on `tcfg.mesh` (enough to cut
    its blocks; no process group)."""
    if mesh is not None:
        return shd.tp(mesh)
    if shd.model_size(tcfg.mesh) <= 1:
        return None
    return Mesh(tcfg.mesh, rank=dist.get_rank() if dist.is_initialized() else 0)


def _path_specs(model: Model, defs, tp) -> list:
    """The spec of each (path, ParamDef) of `defs` on `tp` (() without
    tensor parallelism)."""
    if tp is None:
        return [()] * len(defs)
    tree = model.param_specs(tp)
    out = []
    for path, _ in defs:
        node = tree
        for k in path:
            node = node[k]
        out.append(node)
    return out


def _stack_rows(flat, spec, stacked):
    """The stack's leaves' parts of a flat ShardSpec vector as [L, sl]
    views, in the stack's tree: what the LMS executor's queue writes each
    layer's slot into (`_layer` takes row i)."""
    parts = [ddl_overlap.leaf_part(flat, spec, j).view(spec.rows[j], -1)
             for j, st in enumerate(tree_leaves(stacked)) if st]
    return tree_unflatten(spec.treedef["decoder"]["stack0"], parts)


def _write_parts(out, parts, add: bool = False):
    """Write (or add) each (offset, part) of `local_shard_parts` into the
    flat vector `out`."""
    for o, part in parts:
        dst = out[o:o + part.numel()]
        if add:
            dst.add_(part)
        else:
            dst.copy_(part)


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
    rest (embedding, head, final norm: in pinned host memory beside the
    stack when the params are, else on the device) updates in
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
        out = {"state": off.stream_layer_to_device({str(j): piece(at(s, path), k, c)
                                                    for j, s in enumerate(states)},
                                                   device, cls="optimizer")}
        if params_host and optimizer == "sgdm":
            out["params"] = off.stream_layer_to_device(piece(at(params, path), k, c), device,
                                                       cls="params")
        return out

    def update_chunk(item, fetched):
        path, k, c = item
        st = fetched["state"]
        p = piece(at(params, path), k, c)
        p_dev = p
        if params_host:
            # as a host layer's: the new params written back from the card
            p_dev = fetched["params"] if optimizer == "sgdm" else torch.empty(
                p.shape, dtype=p.dtype, device=device)
        update(piece(at(grads, path), k, c), [st[str(j)] for j in range(len(states))], p_dev)
        off.stream_layer_to_host(st, {str(j): piece(at(s, path), k, c)
                                      for j, s in enumerate(states)}, cls="optimizer")
        if params_host:
            off.stream_layer_to_host(p_dev, p, cls="params")

    _pipelined(chunks, 2, fetch_chunk, update_chunk)
    off.fence(device)
    if optimizer == "adamw":
        return params, AdamState(step, *states)
    return params, SGDState(step, *states)


# ---------------------------------------------------------------------------
# State placement (the counterpart of JAX `make_state_shardings`)
# ---------------------------------------------------------------------------

def _host_classes(plan: Optional[MemoryPlan]):
    """-> (params on host, optimizer state on host) by the plan's
    residency. The placement rule of the params: on the host means every
    leaf in the pinned arena, the stack's and the unstacked rest's
    (embedding, final norm, head) alike, for the replicated step, zero1
    and serving. The planner prices the device's params as streamed
    layers of the whole model, so the rest streams too
    (`models/rest.py`)."""
    res = plan.residency if plan is not None else {}
    return res.get("params") == "host", res.get("optimizer") == "host"


def _leaf_bytes(shape, dtype) -> int:
    """Arena bytes of a leaf (`PinnedArena.padded`)."""
    return off.PinnedArena.padded(math.prod(shape) * torch.empty((), dtype=dtype).element_size())


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


def _state_layout(paths, optimizer, params_host, opt_host, grads_host=False,
                  grads_f32=False):
    """-> (host bytes, [(path, shape, dtype, params on host)]); with
    grads_host the stack's grads (in the params' dtypes, or f32 with
    grads_f32: accumulated over microbatches) are in the host bytes too."""
    per = {"adamw": 3, "sgdm": 1}[optimizer]
    total, out = 0, []
    for path, shape, dtype in paths:
        n = math.prod(shape)
        nbytes = _leaf_bytes(shape, dtype)
        if params_host:
            total += nbytes
        if grads_host and _stack_path(path):
            total += off.PinnedArena.padded(4 * n) if grads_f32 else nbytes
        if opt_host:
            total += per * off.PinnedArena.padded(4 * n)
        out.append((path, shape, dtype, params_host))
    return total, out


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _with_empty(tree, template):
    """`tree`, built leaf by leaf from `template`'s leaf paths, with the
    subtrees of `template` that hold no leaf (a LayerNorm without params
    is `{}`) put back, in place: trees of one model keep one structure.
    -> tree."""
    for k, v in template.items():
        if isinstance(v, dict):
            _with_empty(tree.setdefault(k, {}), v)
    return tree


def _def_paths(defs, prefix=()):
    """[(path, ParamDef)] in `tree_init` order (dict insertion order)."""
    if isinstance(defs, dict):
        return [pd for k, v in defs.items() for pd in _def_paths(v, prefix + (k,))]
    return [(prefix, defs)]


def _placed_state(optimizer, paths, device, params_host, opt_host, fill, template,
                  grads_host=False, grads_f32=False):
    """A TrainState laid out by the plan; fill(index, path, p, states)
    writes each leaf's values; `template` is a tree of the params'
    structure (`_with_empty`). With grads_host the state carries the
    stack's grads tree in the arena (zeros), for the backward's host sink
    (f32 with grads_f32, for the accumulated grads placed there at m >
    1)."""
    host_bytes, layout = _state_layout(paths, optimizer, params_host, opt_host,
                                       grads_host, grads_f32)
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
            _set(grads, path[2:], placer.take(shape, torch.float32 if grads_f32 else dtype,
                                              True))
    for tree in (params, *states):
        _with_empty(tree, template)
    if grads_host:
        _with_empty(grads, template["decoder"]["stack0"])
    step = torch.zeros((), dtype=torch.int32, device=device)
    opt = (AdamState(step.clone(), *states) if optimizer == "adamw"
           else SGDState(step.clone(), *states))
    return TrainState(step, params, opt, grads if grads_host else None)


def place_train_state(state: TrainState, plan: Optional[MemoryPlan], device,
                      microbatches: int = 1) -> TrainState:
    """A copy of `state` placed as the plan says: the stack's params in
    pinned host memory when they stream, the optimizer state there when it
    streams, and a grads tree for the stack there when the plan sinks
    grads (`_grads_host`; f32 when `microbatches` > 1), everything else on
    `device`."""
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
                        opt_host, fill, state.params, _grads_host(plan), microbatches > 1)
    step = state.step.to(device).clone()
    opt = out.opt._replace(step=state.opt.step.to(device).clone())
    return TrainState(step, out.params, opt, out.grads)


def _read_step(reader, key: str, device) -> torch.Tensor:
    return reader.read(key).to(device=device, dtype=torch.int32)


def restore_train_state(reader, model: Model, tcfg: TrainConfig, device,
                        plan: Optional[MemoryPlan] = None, mesh=None) -> TrainState:
    """The TrainState of a checkpoint (`checkpoint.CheckpointReader`: the
    JAX package's keys, ``step``, ``params/...``, ``opt/step`` and
    ``opt/mu/...``, ``opt/nu/...``, ``opt/master/...`` or
    ``opt/momentum/...``), placed as the plan says, as
    `init_train_state(plan=)` places a fresh one (`_placed_state`: the host
    classes in one pinned arena, the reserved one when it is free), with a
    zero grads tree when the plan sinks grads. Leaf by leaf: each stored
    leaf is read straight into its slot before the next is read, so
    neither the state nor a whole leaf stands in pageable memory, nor the
    whole state on the device.

    On a tensor-parallel mesh (`mesh`, else this rank's place on
    `tcfg.mesh`) each leaf sharded over `model` gets this rank's block
    (`checkpoint.read_local`): from its own block where the checkpoint
    was written on as many `model` ranks, else cut from the global leaf,
    and a leaf of a checkpoint written in blocks is joined from them on a
    mesh without tensor parallelism."""
    from repro_torch.checkpoint.checkpointer import read_local
    device = torch.device(device)
    tp = _tp_mesh(tcfg, mesh)
    params_host, opt_host = _host_classes(plan)
    defs = _def_paths(model.param_defs())
    specs = _path_specs(model, defs, tp)
    paths = [(path, shd.local_shape(d.shape, sp, tp), DTYPES[d.dtype])
             for (path, d), sp in zip(defs, specs)]
    names = ("mu", "nu", "master") if tcfg.optimizer == "adamw" else ("momentum",)

    def fill(ix, path, p, st):
        key = "/".join(path)
        read_local(reader, f"params/{key}", p, defs[ix][1].shape, specs[ix], tp)
        for name, t in zip(names, st):
            read_local(reader, f"opt/{name}/{key}", t, defs[ix][1].shape, specs[ix], tp)
    out = _placed_state(tcfg.optimizer, paths, device, params_host, opt_host, fill,
                        model.param_defs(), _grads_host(plan), tcfg.microbatches > 1)
    opt = out.opt._replace(step=_read_step(reader, "opt/step", device))
    return TrainState(_read_step(reader, "step", device), out.params, opt, out.grads)


def build_train_step(model: Model, tcfg: TrainConfig, plan: Optional[MemoryPlan] = None,
                     mesh: Optional[Mesh] = None, spec: Optional[StepSpec] = None):
    """-> step_fn(state, batch) -> (state, metrics), for this rank of
    `mesh` (default: `make_mesh(tcfg.mesh)`), whose batch is the rank's
    rows of the global batch. step_fn.before_update (None unless set) is
    called just before the step's first in-place write to the state, the
    optimizer update (`_before_update`).

    The loss and its grads over every param leaf (`torch.autograd.grad`),
    with m = tcfg.microbatches > 1 accumulated in f32 over the microbatches
    and divided by m, as the JAX package's scan does. On a mesh of several
    data-parallel ranks the grads are then DDL-reduced to their mean over
    the ranks (`core/ddl`): with the overlapped backward (on by default,
    `_resolve_overlap`) the decoder stack's layer by layer while the
    backward goes on and the rest (embedding, final norm, head) after it;
    otherwise the whole tree after the backward. The overlapped backward
    does not differentiate the stack through autograd: each layer's hook
    hands the layer's grads to the DDL hook's reduction queue
    (`core/ddl/overlap.ReductionQueue`), which reduces them on a worker
    thread and stream of its own and writes their mean into a grads tree
    the step allocates; the step opens the queue before the loss and
    drains it before any collective of its own (the rest's, the metrics'),
    and abandons it if the backward raises. With the overlapped backward
    and m > 1 the accumulator is sharded, as in the JAX package: the hooks
    keep this rank's 1/|data| slot of each layer's mean (keep="shard"),
    which the queue adds into one f32 [local_size] vector (`ShardSpec`
    layout), the rest is reduce-scattered into it after each microbatch,
    and after the last one `allgather_local_shards(acc / m)` gives the mean
    tree.
    Then the grads are clipped to tcfg.grad_clip by their global norm and
    the optimizer steps with the lr of `warmup_cosine(state.step)`. The
    state is updated in place and returned in a new TrainState with step +
    1. The metrics are f32 scalars on the device: loss, grad_norm, lr, ce
    and aux, the loss, ce and aux as means over the ranks. Every rank ends
    the step with the same params. On one device every reduction is the
    identity, as the JAX package's collectives over axes of size 1 are.

    plan (or spec.plan): an LMS memory plan (`core/lms/planner.py`). Its
    policy (`plan_to_policy`) decides per tagged activation of each layer
    whether it is saved, offloaded to pinned host memory or recomputed;
    when it streams params, the state's stack lies in pinned host memory
    (`init_train_state(plan=)`) and each layer is copied in for its
    forward and again for its backward; when it streams the optimizer, the
    update is the streamed sweep (`_streamed_opt_update`), with the clip
    inside it. The stack's grads are written into a grads tree layer by
    layer. On a mesh of several ranks (LMS + DDL) with the overlapped
    backward each layer's grads go to the reduction queue, as on the
    resident path, which writes their mean into that tree: on the device,
    or, when the plan puts grads on the host (`_grads_host`) and m == 1,
    into the state's pinned grads tree (the backward's host sink), read
    back a layer at a time by the sweep.
    Without the overlapped backward a plan's sunk grads are placed on the
    host after the tree pass, as in the JAX package. With m > 1 the
    executor runs once a microbatch: without the overlap each microbatch's
    stack grads are added into the f32 accumulator as the resident path
    adds them; with it the queue adds each layer's slot into that layer's
    rows of the sharded accumulator. Streamed and resident steps give the
    same state bitwise, on one rank or several, at any m.

    ddl.mode "none" leaves the grads unreduced, as in the JAX package;
    "zero1" is `build_zero1_train_step`'s (here it reduces as "allreduce",
    as the JAX package's replicated step does). Under a plan, params on
    the host with the optimizer on the device raises (not ported yet).
    Every ported stack (dense, MoE, Mamba-2) runs under a plan.

    Tensor parallelism (a `model` axis above 1, the dense "attn" stack
    only): the state holds this rank's blocks of the leaves the rule table
    shards over `model` (`init_train_state`, `convert.train_state_from_jax(
    mesh=)`), the model runs its column- and row-parallel layers and the
    vocab-parallel loss with their sums over `model` (`models/
    sharding.py`), and the step runs as above on the local blocks: the
    DDL reduction over the data ranks that hold the same blocks, the
    sharded leaves kept out of the overlapped backward's buckets and of
    the int8 pod hop (`core/ddl`), resident or under a plan alike; the
    clip's global norm sums the sharded leaves' squares over `model`
    (`optim/adamw.norm_of`), so it and the metrics are the global tree's,
    the same on every rank."""
    spec = StepSpec() if spec is None else spec
    if spec.plan is None and plan is not None:
        spec = dataclasses.replace(spec, plan=plan)
    plan = spec.plan
    if shd.model_size(tcfg.mesh if mesh is None else mesh) > 1:
        tr._check_kinds(model.cfg, tcfg.mesh if mesh is None else mesh)
    mesh = make_mesh(tcfg.mesh) if mesh is None else mesh
    sizes = mesh_axis_sizes(mesh)
    dpa = dp_axes(mesh)
    data_size = sizes.get("data", 1)
    pod_size = sizes.get("pod", 1)
    pod_axis = "pod" if "pod" in sizes and pod_size > 1 else None
    mean_over = data_size * pod_size
    tp = shd.tp(mesh)
    # each leaf's spec (tree order), which ones hold a block, the stack's
    # per-layer specs and the rest's; all None without tensor parallelism
    leaf_specs = sharded_leaves = stack_specs = rest_specs = None
    if tp is not None:
        spec_tree = model.param_specs(tp)
        leaf_specs = tree_leaves(spec_tree)
        sharded_leaves = [shd.model_dim(sp) is not None for sp in leaf_specs]
        stack_specs = {"stack0": [sp[1:] for sp in
                                  tree_leaves(spec_tree["decoder"]["stack0"])]}
        rest_specs = tree_leaves(_split_stack_grads(spec_tree)[1])
    ddl = spec.ddl_for(tcfg)
    _, opt_update = OPTIMIZERS[tcfg.optimizer]
    sched = SCHEDULES["warmup_cosine"]
    m = tcfg.microbatches
    overlap = _resolve_overlap(spec.overlap_grads, plan, tcfg, mean_over)
    if plan is not None:
        _check_plan(plan, model)
    # a plan that assigns nothing recomputes every activation (JAX:
    # jax.checkpoint with policy None)
    policy = (plan_to_policy(plan) or Policy()) if plan is not None else None
    stream = _param_stream(plan)
    opt_stream = _opt_stream(plan)
    params_host = _host_classes(plan)[0]
    grads_host = _grads_host(plan)
    # the host sink exists at m == 1 only; at m > 1 with the overlap the
    # sharded accumulator stays on the device, and without it the
    # accumulated stack is placed on the host after the tree pass (JAX)
    sink = grads_host and m == 1 and overlap
    reduce = dict(mesh=mesh, data_axis="data", pod_axis=pod_axis,
                  data_size=data_size, pod_size=pod_size)
    hooks = (make_stack_hooks(["stack0"], ddl, **reduce, keep="shard" if m > 1 else "full",
                              sink=off.HOST if sink else None, stack_specs=stack_specs)
             if overlap else None)
    sharded = overlap and m > 1
    if sharded:
        shapes = _meta_params(model, tp)
        stacked = _stacked_mask(shapes)
        sspec = ddl_overlap.shard_spec(shapes, data_size, stacked)
        shard_axes = dict(mesh=mesh, data_axis="data", pod_axis=pod_axis,
                          mean_over=mean_over, compress_dcn=ddl.compress_dcn)
    queue = hooks["stack0"].queue if hooks is not None else None
    schedule = plan.swap_schedule if plan is not None else None

    def microbatches(batch):
        """The batch's m microbatches (the batch itself at m == 1)."""
        if m == 1:
            return [batch]
        parts = _microbatch_split(batch, m)
        return [{k: v[i] for k, v in parts.items()} for i in range(m)]

    def mean_metrics(sums):
        loss, mets = sums
        if m == 1:
            return loss, mets
        return loss / m, {k: v / m for k, v in mets.items()}

    def add_metrics(sums, loss, mets):
        if sums is None and m == 1:
            return loss.detach(), {k: v.detach() for k, v in mets.items()}
        if sums is None:
            zero = torch.zeros((), dtype=torch.float32, device=loss.device)
            sums = (zero, {"ce": zero, "aux": zero})
        l_acc, m_acc = sums
        return l_acc + loss.detach(), {k: m_acc[k] + mets[k].detach() for k in m_acc}

    def sunk_loss_and_grads(state, batch):
        """Under a plan or with the overlapped backward: the stack is not
        differentiated through autograd; the LMS executor or the hooks
        write its grads into a grads tree (zeros on the device, so a param
        no layer used keeps a zero grad; the state's pinned tree under the
        host sink, every layer written each step; with the sharded
        accumulator, the stack's rows of it), through the reduction queue
        with the overlapped backward, which is drained before this
        returns. -> (..., the stack's per-slice sums of squares when the
        queue made them, else None)."""
        stacks, rest = _split_stack_grads(state.params)
        leaves = tree_map(lambda p: p.detach().requires_grad_(), rest)
        device = state.step.device
        if sink:
            gstack = _sunk_grads(state)
        elif sharded:
            acc = torch.zeros(sspec.local_size, dtype=torch.float32, device=device)
            gstack = _stack_rows(acc, sspec, stacked)
        else:
            gstack = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device),
                              stacks["stack0"])
        if m > 1 and not sharded:
            acc = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32, device=device),
                           state.params)
        squares = StackSquares([tuple(t.shape) for t in tree_leaves(gstack)]) if sink else None
        sums = None
        for i, mb in enumerate(microbatches(batch)):
            if m > 1 and not sharded and i:
                for g in tree_leaves(gstack):
                    g.zero_()
            loss, mets, grads = _sunk_loss_and_grads(
                model, leaves, stacks, mb, gstack, schedule=schedule, policy=policy,
                stream=stream, hooks=hooks, queue=queue, squares=squares, accumulate=sharded,
                mesh=tp)
            sums = add_metrics(sums, loss, mets)
            rest_grads = tree_unflatten(rest, grads)
            if sharded:
                # the stack's slots are in acc (the queue added them); the
                # rest is reduce-scattered into it
                tree = _merge_stack_grads(rest_grads, {"stack0": tree_map(
                    lambda _: None, stacks["stack0"])})
                with torch.no_grad():
                    _write_parts(acc, ddl_overlap.local_shard_parts(
                        tree, sspec, stacked, **shard_axes), add=True)
            elif m > 1:
                with torch.no_grad():
                    for a, g in zip(tree_leaves(acc), tree_leaves(_merge_stack_grads(
                            rest_grads, {"stack0": gstack}))):
                        a.add_(g)
        loss, mets = mean_metrics(sums)
        if sharded:
            grads = ddl_overlap.allgather_local_shards(acc.div_(m), sspec, mesh=mesh,
                                                       data_axis="data")
        elif m > 1:
            grads = tree_map(lambda a: a.div_(m), acc)
        else:
            grads = _merge_stack_grads(rest_grads, {"stack0": gstack})
        return loss, mets, grads, squares.squares() if sink else None

    def loss_and_grads(state, batch):
        """-> (loss, {"ce", "aux"}, grads, stack squares or None): detached
        tensors; grads in the params' dtypes, or f32 when accumulated over
        microbatches. With the hooks the decoder stack's grads come back
        reduced; with the sharded accumulator the whole tree."""
        if plan is not None or hooks is not None:
            return sunk_loss_and_grads(state, batch)
        params = state.params
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        flat = tree_leaves(leaves)
        if m == 1:
            loss, mets = model.loss(leaves, batch, mesh=tp)
            grads = torch.autograd.grad(loss, flat)
            return (loss.detach(), {k: v.detach() for k, v in mets.items()},
                    tree_unflatten(params, grads), None)
        device = flat[0].device
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=device) for p in flat]
        sums = None
        for mb in microbatches(batch):
            loss, mets = model.loss(leaves, mb, mesh=tp)
            grads = torch.autograd.grad(loss, flat)
            with torch.no_grad():
                for a, g in zip(acc, grads):
                    a.add_(g)
            del grads
            sums = add_metrics(sums, loss, mets)
        loss, mets = mean_metrics(sums)
        return loss, mets, tree_unflatten(params, [a.div_(m) for a in acc]), None

    def reduce_grads(grads):
        """The DDL mean over the ranks of what the hooks left unreduced."""
        if mean_over == 1 or sharded:
            return grads
        if not overlap:
            return ddl_reduce_tree(grads, ddl, **reduce, param_specs=leaf_specs)[0]
        stacks, rest = _split_stack_grads(grads)
        rest, _ = ddl_reduce_tree(rest, ddl, **reduce, param_specs=rest_specs)
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
                gnorm = _global_norm_streamed(grads, stack_squares, tp, sharded_leaves)
                scale = clip_scale(gnorm, tcfg.grad_clip)
                placed = grads_host and stack_squares is None and not sharded
                if placed:
                    # no queue to sink each layer: place the reduced stack
                    # on the host after the tree pass (JAX's fallback)
                    stacks, rest = _split_stack_grads(grads)
                    host = _sunk_grads(state)
                    for h, g in zip(tree_leaves(host), tree_leaves(stacks["stack0"])):
                        if h.dtype != g.dtype:
                            raise ValueError(
                                f"the state's host grads are {h.dtype}, the step's {g.dtype}: "
                                "place the state with microbatches=tcfg.microbatches")
                    off.stream_layer_to_host(stacks["stack0"], host, cls="grads")
                    off.fence(state.step.device)
                    grads = _merge_stack_grads(rest, {"stack0": host})
                _before_update(step_fn)
                params, opt = _streamed_opt_update(
                    tcfg.optimizer, grads, state.opt, state.params, lr=lr,
                    beta1=tcfg.beta1, beta2=tcfg.beta2,
                    weight_decay=tcfg.weight_decay, schedule=opt_stream,
                    params_host=params_host, device=state.step.device, clip=scale,
                    grads_host=sink or placed)
            else:
                grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip, tp, sharded_leaves)
                _before_update(step_fn)
                params, opt = opt_update(grads, state.opt, state.params, lr=lr,
                                         beta1=tcfg.beta1, beta2=tcfg.beta2,
                                         weight_decay=tcfg.weight_decay)
            # the means over the ranks, in one collective per axis
            loss, ce, aux = mesh.pmean(torch.stack([loss, mets["ce"], mets["aux"]]), dpa)
            metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr, "ce": ce, "aux": aux}
        return state._replace(step=state.step + 1, params=params, opt=opt), metrics

    # the overlapped backward's reduction queue (its times of the last
    # step), None without the overlap
    step_fn.queue = queue
    step_fn.before_update = None
    return step_fn


def _before_update(step_fn) -> None:
    """Call the step's `before_update` hook, if one is set, just before
    the step's first in-place write to the state (the optimizer update):
    the trainer's wait for a checkpoint writer that reads the state where
    it lies (`checkpoint/checkpointer.py`). The forward and backward before
    it only read the state."""
    if step_fn.before_update is not None:
        step_fn.before_update()


def _sunk_loss_and_grads(model: Model, leaves, stacks, batch, stack_grads, *, schedule,
                         policy, stream, hooks, queue, squares=None, accumulate=False,
                         take=None, mesh=None):
    """One pass of the stack with its grads sunk: the loss of `batch` over
    the rest's leaves (differentiated) and the stack (not differentiated:
    its grads written into `stack_grads` by the LMS executor's sink, or by
    the reduction queue, opened for the pass with `schedule`'s prefetch
    depth, 1 without one, and drained before this returns; abandoned if
    the backward raises). The resident stack (no policy, no stream) takes
    the hooks' path. With the rest in host memory its grads come from the
    model's sinks: `take(path, grad)`, if given, may consume one as the
    backward makes it (-> True; its grad is then None here); the others
    are returned, the embedding's in its rows' form (`models/rest.py`
    `RowsGrad`) when `take` is given, else as tensors. -> (loss, {"ce",
    "aux"}, the rest's grads)."""
    layers = model.cfg.num_layers
    if queue is not None:
        queue.open(batch["tokens"].device, tr._stream_depth(schedule, layers),
                   squares, accumulate=accumulate)
    sunk, sink = {}, None
    if host_rest.on_host(stream):
        def sink(key, g):
            if take is not None and take(key, g):
                return
            if isinstance(g, host_rest.HeadGrad):
                g = g.dense()       # it holds the logits' grads: formed now
            sunk[key] = g if key not in sunk else host_rest.dense(sunk[key]) + host_rest.dense(g)
    try:
        loss, mets = model.loss(_merge_stack_grads(leaves, stacks), batch, policy=policy,
                                stream=stream, stack_grads=stack_grads, grad_hooks=hooks,
                                rest_sink=sink, mesh=mesh)
        grads = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=sink is not None)
    except BaseException:
        if queue is not None:
            queue.abandon()
        raise
    if queue is not None:
        queue.drain(layers)
    if sink is not None:
        keep = host_rest.dense if take is None else (lambda g: g)
        grads = [keep(sunk.get(path)) if g is None else g
                 for (path, _), g in zip(_paths(leaves), grads)]
    return loss, mets, grads


def _sunk_grads(state: TrainState):
    """The state's pinned grads tree of the stack, which a plan that sinks
    grads writes into."""
    if state.grads is None:
        raise ValueError("the plan puts grads on the host: place the state with it "
                         "(init_train_state(plan=), place_train_state)")
    return state.grads


def _global_norm_streamed(grads, stack_squares=None, mesh=None,
                          sharded=None) -> torch.Tensor:
    """`global_norm` of the grads tree whose stack's per-slice sums of
    squares may come made (`stack_squares`, in the stack's leaf order: the
    reduction queue summed them while the layers were on the device, and
    the grads now lie on the host); the other leaves' are summed here.
    `mesh`, `sharded`: tensor parallelism (`optim/adamw.norm_of`)."""
    stack = iter(stack_squares or ())
    return norm_of([next(stack) if stack_squares is not None and _stack_path(path)
                    else leaf_squares(leaf) for path, leaf in _paths(grads)], mesh, sharded)


def _check_plan(plan: MemoryPlan, model: Model) -> None:
    """Raise for what a plan asks that the port does not execute yet."""
    res = plan.residency
    unported = {
        "params on the host with the optimizer state on the device":
            res.get("params") == "host" and res.get("optimizer") != "host",
    }
    for what, on in unported.items():
        if on:
            raise NotImplementedError(f"{what} is not ported yet")


def init_train_state(model: Model, tcfg: TrainConfig, seed: int,
                     device, plan: Optional[MemoryPlan] = None, mesh=None) -> TrainState:
    """Params from `model.init(seed, device)` and a fresh optimizer state.

    With a plan that puts params or the optimizer on the host, the state is
    built one leaf (a stacked leaf: one layer) at a time, on the device and
    copied out, so it never stands whole on the device: the stack's params
    and the optimizer state go to pinned host memory as the plan says
    (`_host_classes`), the rest to the device; a plan that sinks grads
    (`_grads_host`) also gets the stack's grads tree there (f32 at
    microbatches > 1). The values are
    `model.init(seed, device)`'s bitwise: the same draws from the same
    generator. On a tensor-parallel mesh (`mesh`, else this rank's place
    on `tcfg.mesh`) the state holds this rank's blocks of those values
    (`model.init(mesh=)`), placed alike."""
    device = torch.device(device)
    tp = _tp_mesh(tcfg, mesh)
    params_host, opt_host = _host_classes(plan)
    if params_host or opt_host:
        defs = _def_paths(model.param_defs())
        specs = _path_specs(model, defs, tp)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        paths = [(path, shd.local_shape(d.shape, sp, tp), DTYPES[d.dtype])
                 for (path, d), sp in zip(defs, specs)]

        def fill(ix, path, p, st):
            for i, piece in local_pieces(defs[ix][1], gen, device, specs[ix], tp):
                p[i] = piece
                if tcfg.optimizer == "adamw":
                    st[2][i] = piece.float()
        return _placed_state(tcfg.optimizer, paths, device, params_host, opt_host, fill,
                             model.param_defs(), _grads_host(plan), tcfg.microbatches > 1)
    params = model.init(seed, device, mesh=tp)
    opt_init, _ = OPTIMIZERS[tcfg.optimizer]
    return TrainState(torch.zeros((), dtype=torch.int32, device=device),
                      params, opt_init(params))


# ---------------------------------------------------------------------------
# Beyond-paper mode: DDL-ZeRO1 (the optimizer update between RS and AG)
# ---------------------------------------------------------------------------

class Zero1State(NamedTuple):
    step: torch.Tensor    # int32 scalar on the device
    params: Any           # the whole params tree (bf16), as the replicated step's
    mu: torch.Tensor      # f32 [local], this rank's shard of the flat state
    nu: torch.Tensor
    master: torch.Tensor


def _zero1_layout(model: Model, tcfg: TrainConfig, data_size: int, dp_total: int):
    """-> (overlap, layout): the overlapped backward resolved from the
    DDLConfig alone, as the JAX package does (a plan's recommendation or
    `StepSpec.overlap_grads` would scramble the flat layout between
    `init_zero1_state` and the step), and the flat layout that goes with
    it: `ShardSpec` (shard-major, the hooks' slots) with the overlap, the
    `pack` order padded to |data| without."""
    overlap = _resolve_overlap(None, None, tcfg, dp_total)
    shapes = _meta_params(model)
    if overlap:
        return overlap, ddl_overlap.shard_spec(shapes, data_size, _stacked_mask(shapes))
    return overlap, pack_spec(shapes, pad_to=data_size)


def _local_size(layout) -> int:
    if isinstance(layout, PackSpec):
        return layout.padded // layout.pad_to
    return layout.local_size


def _zero1_params_from(master, layout, params, *, mesh, device) -> None:
    """Phase 3 of the DDL schedule on the params: all-gather the updated
    master shard over `data` and write each param as its f32 value cast
    to the param's dtype, a row of a leaf at a time (ShardSpec: one layer
    of a stacked leaf; `SLICE` columns of each rank's block of an
    unstacked leaf) or a slice of the flat vector at a time (the pack
    order), so neither the whole f32 tree nor a whole leaf in f32 stands
    on the card. A master shard in
    host memory is copied in a row or slice at a time. The cast runs on
    the card: a blocking copy into a param in host memory would convert
    on the CPU (torch does a blocking device-to-host copy's dtype
    conversion there), which took most of a 48-layer step."""
    leaves = tree_leaves(params)

    def on_device(t):
        if t.device == device:
            return t
        return off.stream_layer_to_device(t, device, cls="optimizer").wait()
    if isinstance(layout, ddl_overlap.ShardSpec):
        d = layout.data_size
        for j, p in enumerate(leaves):
            r = layout.rows[j]
            part = ddl_overlap.leaf_part(master, layout, j).view(r, -1)
            if r == 1:
                # an unstacked leaf: `SLICE` columns of every rank's block
                # at a time, so no whole leaf stands gathered in f32
                flat, sl, n = p.view(-1), part.shape[1], p.numel()
                for k in range(0, sl, SLICE):
                    got = mesh.all_gather(on_device(part[:, k:k + SLICE]), "data")
                    for q in range(d):
                        a, b = q * sl + k, min(q * sl + k + got.shape[1], n)
                        if a < b:
                            flat[a:b].copy_(got[q, :b - a].to(p.dtype))
                continue
            dst = p.view(r, -1)
            for i in range(r):
                row = ddl_overlap.gather_rows(on_device(part[i:i + 1]), layout, j,
                                              mesh=mesh, data_axis="data")
                dst[i:i + 1].copy_(row.to(p.dtype))
        return
    d = layout.pad_to
    n = layout.padded // d
    starts = [0]
    for size in layout.sizes:
        starts.append(starts[-1] + size)
    for k in range(0, n, SLICE):
        got = mesh.all_gather(on_device(master[k:k + SLICE]), "data").view(d, -1)
        s = got.shape[1]
        for r in range(d):
            g0 = r * n + k
            for p, lo, hi in zip(leaves, starts, starts[1:]):
                a, b = max(lo, g0), min(hi, g0 + s)
                if a < b:
                    p.view(-1)[a - lo:b - lo].copy_(got[r, a - g0:b - g0].to(p.dtype))


def build_zero1_train_step(model: Model, tcfg: TrainConfig, plan: Optional[MemoryPlan] = None,
                           mesh: Optional[Mesh] = None, spec: Optional[StepSpec] = None):
    """The zero1 step (JAX `build_zero1_train_step`): DDL's phases 1-2 on
    the grads, this rank's 1/|data| shard of the AdamW state updated, phase
    3 on the params. -> step_fn(Zero1State, batch) -> (Zero1State,
    metrics), updated in place; step_fn.layout is the flat layout
    (`ShardSpec` or `PackSpec`), step_fn.queue the overlapped backward's
    reduction queue or None, and step_fn.before_update, as the replicated
    step's, called before the flat update.

    As in the JAX package, whatever the config says otherwise:
    - the overlapped backward is resolved from the DDLConfig alone
      (`_resolve_overlap(None, None, tcfg, dp)`), so that the step and
      `init_zero1_state` lay the flat state out alike (`_zero1_layout`);
    - the step takes the whole batch in one pass whatever
      `tcfg.microbatches` says;
    - the state is AdamW's (mu, nu, master, f32) whatever `tcfg.optimizer`
      says;
    - the update is the JAX step's inline expression in its order,
      mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g g, master -= lr
      ((mu / b1c) / (sqrt(nu / b2c) + 1e-8) + wd master), which is
      `optim.adamw.adamw_slice_update`'s, applied to `SLICE`-element
      slices (elementwise, so slicing changes no number), and the clip's
      norm is the sqrt of the sum over `data` of the shard's sum of
      squares.

    Overlapped: the decoder stack is not differentiated through autograd;
    its hooks hand each layer's grads to the reduction queue, which
    reduces them in shard mode on its worker thread while the backward
    goes on and copies this rank's slot into the layer's rows of the flat
    grad shard; after the queue is drained `local_shard_parts`
    reduce-scatters the rest into it. The new params come from
    `gather_leaf`. Serialized: `pack`, `hierarchical_reduce_scatter_flat`,
    and the params from the gathered flat vector. The metrics are the
    replicated step's.

    plan: an LMS plan. The LMS executor runs the stack (its policy, and
    its params streamed from pinned host memory when the plan streams
    them), its grads put on the same queue with the overlap. When the
    params stream, the rest is in host memory too and its grads reach
    the shard from the model's sinks (overlapped): the head's reduced as
    the backward makes it, the embedding's from its rows' form a
    `POD_SLICE` at a time (`leaf_shard_parts`), so neither stands whole
    through the stack's backward.
    The flat state lies where the plan's optimizer class says: on the
    device, or in the pinned arena (`init_zero1_state(plan=)`), and then
    the update streams it through the card in `SLICE`-element chunks, two
    in flight (`_pipelined`). Either way the state equals the resident
    step's bitwise. As for the replicated step, a plan with params on the
    host and the optimizer on the device is not ported yet."""
    spec = StepSpec() if spec is None else spec
    if spec.plan is None and plan is not None:
        spec = dataclasses.replace(spec, plan=plan)
    plan = spec.plan
    if shd.model_size(tcfg.mesh if mesh is None else mesh) > 1:
        raise NotImplementedError(ZERO1_TP)
    mesh = make_mesh(tcfg.mesh) if mesh is None else mesh
    sizes = mesh_axis_sizes(mesh)
    dpa = dp_axes(mesh)
    data_size = sizes.get("data", 1)
    pod_size = sizes.get("pod", 1)
    pod_axis = "pod" if pod_size > 1 else None
    mean_over = data_size * pod_size
    ddl = spec.ddl_for(tcfg)
    sched = SCHEDULES["warmup_cosine"]
    if plan is not None:
        _check_plan(plan, model)
    policy = (plan_to_policy(plan) or Policy()) if plan is not None else None
    stream = _param_stream(plan)
    opt_host = _host_classes(plan)[1]
    overlap, layout = _zero1_layout(model, tcfg, data_size, mean_over)
    local = _local_size(layout)
    # the untied head's index in the layout's leaf order (None when tied)
    head_leaf = next((j for j, (path, _) in enumerate(_paths(_meta_params(model)))
                      if path == host_rest.HEAD), None)
    hooks, stacked = None, None
    if overlap:
        stacked = _stacked_mask(layout.treedef)
        hooks = make_stack_hooks(["stack0"], ddl, mesh=mesh, data_axis="data",
                                 pod_axis=pod_axis, data_size=data_size, pod_size=pod_size,
                                 keep="shard")
    queue = hooks["stack0"].queue if hooks is not None else None
    schedule = plan.swap_schedule if plan is not None else None
    shard_axes = dict(mesh=mesh, data_axis="data", pod_axis=pod_axis, mean_over=mean_over,
                      compress_dcn=ddl.compress_dcn)
    beta1, beta2, wd = tcfg.beta1, tcfg.beta2, tcfg.weight_decay

    def grad_shard(state: Zero1State, batch):
        """-> (loss, {"ce", "aux"}, this rank's f32 [local] grad shard)."""
        params = state.params
        if plan is None and not overlap:
            leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, mets = model.loss(leaves, batch)
            grads = tree_unflatten(params, torch.autograd.grad(loss, tree_leaves(leaves)))
        else:
            stacks, rest = _split_stack_grads(params)
            leaves = tree_map(lambda p: p.detach().requires_grad_(), rest)
            device = state.step.device
            if overlap:
                shard = torch.zeros(local, dtype=torch.float32, device=device)
                gstack = _stack_rows(shard, layout, stacked)
            else:
                gstack = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                                        device=device), stacks["stack0"])
            take = None
            if overlap and host_rest.on_host(stream):
                def take(key, g):
                    """The head's grad, reduced into the shard as the
                    backward makes it, formed a block of rows at a time
                    from its factors (`models/rest.HeadGrad`), so it never
                    stands whole: before the first layer's grads reach the
                    queue (the head's backward comes first), so no
                    collective runs beside the queue's."""
                    if key != host_rest.HEAD:
                        return False
                    _write_parts(shard, ddl_overlap.leaf_shard_parts(
                        g, layout, head_leaf, **shard_axes))
                    return True
            loss, mets, rest_grads = _sunk_loss_and_grads(
                model, leaves, stacks, batch, gstack, schedule=schedule, policy=policy,
                stream=stream, hooks=hooks, queue=queue, take=take)
            # with the queue, the stack's slots are in the shard already
            stack_done = tree_map(lambda _: None, stacks["stack0"]) if overlap else gstack
            grads = _merge_stack_grads(tree_unflatten(rest, rest_grads),
                                       {"stack0": stack_done})
        with torch.no_grad():
            if overlap:
                _write_parts(shard, ddl_overlap.local_shard_parts(grads, layout, stacked,
                                                                  **shard_axes))
            else:
                shard, _ = hierarchical_reduce_scatter_flat(
                    pack(grads, layout), mesh=mesh, data_axis="data", pod_axis=pod_axis,
                    compress_dcn=ddl.compress_dcn, mean_over=mean_over)
        return loss.detach(), {k: v.detach() for k, v in mets.items()}, shard

    def update(g, state: Zero1State, lr):
        """The AdamW update of the shard, in place: on the device slice by
        slice, or streamed through the card from pinned host memory."""
        step = state.step + 1
        sf = step.float()
        b1c = 1.0 - beta1 ** sf
        b2c = 1.0 - beta2 ** sf
        kw = dict(lr=lr, beta1=beta1, beta2=beta2, b1c=b1c, b2c=b2c, eps=1e-8,
                  weight_decay=wd)
        if not opt_host:
            for gs, ms, vs, mps in _slices(g, state.mu, state.nu, state.master):
                adamw_slice_update(gs, ms, vs, mps, **kw)
            return
        device = g.device

        def host_slices(k):
            return {"mu": state.mu[k:k + SLICE], "nu": state.nu[k:k + SLICE],
                    "master": state.master[k:k + SLICE]}

        def fetch(k):
            return {"state": off.stream_layer_to_device(host_slices(k), device,
                                                        cls="optimizer")}

        def upd(k, fetched):
            st = fetched["state"]
            adamw_slice_update(g[k:k + SLICE], st["mu"], st["nu"], st["master"], **kw)
            off.stream_layer_to_host(st, host_slices(k), cls="optimizer")
        _pipelined(list(range(0, local, SLICE)), 2, fetch, upd)
        off.fence(device)

    def step_fn(state: Zero1State, batch):
        loss, mets, g = grad_shard(state, batch)
        device = g.device
        with torch.no_grad():
            loss, ce, aux = mesh.pmean(torch.stack([loss, mets["ce"], mets["aux"]]), dpa)
            total = torch.zeros(1, dtype=torch.float32, device=device)
            for sq in leaf_squares(g):
                total = total + sq
            gnorm = torch.sqrt(mesh.psum(total, "data"))[0]
            g.mul_(clip_scale(gnorm, tcfg.grad_clip))
            lr = sched(state.step, base_lr=tcfg.learning_rate,
                       warmup_steps=tcfg.warmup_steps, total_steps=tcfg.total_steps)
            _before_update(step_fn)
            update(g, state, lr)
            del g
            _zero1_params_from(state.master, layout, state.params, mesh=mesh, device=device)
            metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr, "ce": ce, "aux": aux}
        return state._replace(step=state.step + 1), metrics

    step_fn.layout = layout
    step_fn.queue = queue
    step_fn.before_update = None
    return step_fn


def _zero1_placement(model: Model, tcfg: TrainConfig, data_size: int,
                     plan: Optional[MemoryPlan], device):
    """What a Zero1State's placement needs: (layout, local size, the param
    defs in init order, a placer of its host bytes, stack params on host,
    optimizer on host). The layout is the step's (`_zero1_layout`: the
    overlap from the DDLConfig, the `data` extent from tcfg.mesh, falling
    back to `data_size`); the host bytes are the flat mu, nu and master
    when the optimizer class is on the host, every param leaf when the
    params are (`_host_classes`)."""
    sizes = dict(zip(tcfg.mesh.axes, tcfg.mesh.shape))
    data = sizes.get("data", data_size)
    dp_total = data * sizes.get("pod", 1)
    overlap = _resolve_overlap(None, None, tcfg, dp_total)
    _, layout = _zero1_layout(model, tcfg, data if overlap else data_size, dp_total)
    local = _local_size(layout)
    params_host, opt_host = _host_classes(plan)
    defs = _def_paths(model.param_defs())
    host_bytes = 3 * off.PinnedArena.padded(4 * local) if opt_host else 0
    if params_host:
        host_bytes += sum(_leaf_bytes(d.shape, DTYPES[d.dtype]) for _, d in defs)
    return layout, local, defs, _Placer(device, host_bytes), params_host, opt_host


def init_zero1_state(model: Model, tcfg: TrainConfig, seed: int, device, data_size: int,
                     plan: Optional[MemoryPlan] = None, *, data_index: int) -> Zero1State:
    """Params from `model.init(seed, device)` (the same draws), zero mu and
    nu, and the master copy: this rank's shard of the global flat state,
    equal bitwise to its block of the JAX package's `pack_global` (the
    overlapped layout) or `pack` (the serialized one), the layout the
    step takes (`_zero1_layout`: the overlap from the DDLConfig, the
    `data` extent from tcfg.mesh, falling back to `data_size`).
    data_index: this rank's `data` coordinate (`Mesh.index("data")`).

    With a plan, the state is placed as it says: the params in pinned
    host memory when they stream (the rest too), the flat mu, nu and master there
    when the optimizer class is on the host; built leaf by leaf (a stacked
    leaf a layer at a time), so neither stands whole on the device."""
    device = torch.device(device)
    layout, local, defs, placer, params_host, opt_host = _zero1_placement(
        model, tcfg, data_size, plan, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {}
    for path, d in defs:
        p = placer.take(d.shape, DTYPES[d.dtype], params_host)
        for i, piece in init_pieces(d, gen, device):
            p[i] = piece
        _set(params, path, p)
    _with_empty(params, model.param_defs())
    flat = [placer.take((local,), torch.float32, opt_host) for _ in range(3)]
    if isinstance(layout, ddl_overlap.ShardSpec):      # the overlapped layout
        ddl_overlap.rank_block(params, layout, data_index, flat[2])
    else:
        pack_block(params, layout, data_index, flat[2])
    return Zero1State(torch.zeros((), dtype=torch.int32, device=device), params, *flat)


def restore_zero1_state(reader, model: Model, tcfg: TrainConfig, device, data_size: int,
                        plan: Optional[MemoryPlan] = None, *, data_index: int) -> Zero1State:
    """The Zero1State of a checkpoint (keys ``step``, ``params/...``,
    ``mu``, ``nu``, ``master``), placed as `init_zero1_state(plan=)`
    places a fresh one, leaf by leaf into its slot. The flat state: a
    checkpoint of one process (the JAX package's, or the port's at |data|
    1) holds the global flat vectors, of which this rank reads its block
    (as `convert.zero1_state_from_jax` takes it); one of |data| processes
    holds each rank's block in ``shard_<rank>``. Any other process count
    raises: the flat layout depends on the data extent, so zero1 cannot
    reshard across it."""
    device = torch.device(device)
    n = reader.num_processes
    if n not in (1, data_size):
        raise RuntimeError(
            f"zero1 optimizer shards are packed per data rank: a checkpoint of {n} "
            f"data ranks cannot restore onto {data_size}; restart at the original "
            "scale or with ddl mode allreduce")
    _, local, defs, placer, params_host, opt_host = _zero1_placement(
        model, tcfg, data_size, plan, device)
    stored = math.prod(reader.info("master")[0])
    if stored != (local * data_size if n == 1 else local):
        raise RuntimeError(
            f"the checkpoint's flat zero1 state holds {stored} elements; this "
            f"rank's layout takes {local} of {local * data_size}")
    start = data_index * local if n == 1 else 0
    params = {}
    for path, d in defs:
        p = placer.take(d.shape, DTYPES[d.dtype], params_host)
        reader.read_into("params/" + "/".join(path), p)
        _set(params, path, p)
    _with_empty(params, model.param_defs())
    flat = []
    for name in ("mu", "nu", "master"):
        t = placer.take((local,), torch.float32, opt_host)
        reader.read_into(name, t, start=start)
        flat.append(t)
    return Zero1State(_read_step(reader, "step", device), params, *flat)
