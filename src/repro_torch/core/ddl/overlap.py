"""Overlapped backward: DDL gradient reduction issued inside the backward
pass, layer by layer — the port of the JAX package's `core/ddl/overlap.py`,
in both its keep modes, and the shard-major flat layout of the zero1 step
and of the sharded microbatch accumulator.

The post-hoc `ddl_reduce_tree` pass serializes every RS/AR/AG behind the
last layer's backward. `make_grad_reduce_hook` instead wraps one layer's
params in an identity `torch.autograd.Function` whose backward hands that
layer's grads to the hook's `ReductionQueue`, so each layer's collectives
are issued as soon as the backward has produced them, while the layers
below are still to come. Forward is the identity: the model's graph is
untouched. The hook wraps the layer outside its activation checkpoint, so
the recompute in the backward reruns no collective.

Small leaves coalesce into fixed-size buckets (`make_buckets`, sized by
`DDLConfig.bucket_mb`), so the fabric sees few large collectives instead
of one per norm-scale vector. Bucketing is per layer: bucketing across
layers would serialize the backward sweep the hook exists to overlap.
Two keep modes, as in the JAX package:
  - "full": each bucket goes RS(data) -> AR(pod) -> AG(data) and comes
    back as the fully reduced mean gradient (the paper's allreduce
    schedule);
  - "shard": stop after AR(pod) and keep only this rank's 1/|data| slot of
    each leaf, written into a zero grad of the leaf's full shape. The zero1
    step and the sharded microbatch accumulator slice the slot back out
    (`collect_local_shards`): no all-gather on the gradient path. A JAX
    cotangent has the param's dtype, so the f32 mean is rounded to it on
    its way out of the hook; the port rounds at the same place.

The stack is never differentiated through autograd, resident or under
LMS: each layer's grads leave the backward through the hook's
`_ReduceGrads` (the resident stack) or the LMS executor's sink (a streamed
one, `models/transformer.py`), which both hand them to the queue with the
layer's slot of a grads tree the step allocated. One worker thread a rank,
on a CUDA stream of its own, reduces the layers one after another in the
order the backward produced them (so every rank issues the same
collectives in the same order, with the same buckets and so the same sums
as a reduction inline in the backward) and writes each layer's mean into
its slot, on the device or, with `sink=` the pinned host kind, in pinned
host memory: the gradient host sink of a plan that puts grads on the host.
The backward goes on to the layers below while a layer reduces; it waits
only when `depth` layers are queued. The JAX package's hook is a
`custom_vjp` whose collectives XLA schedules behind the rest of the
backward; the queue is the port's way to the same overlap.

`ShardSpec` is the shard-major flat layout those slots live in: each leaf
viewed as [rows, rowsize] (rows = the layer count for a stacked leaf, else
1), rowsize padded to a multiple of |data|; rank r owns column block r of
every leaf. The port's collectives scatter and gather along dim 0 only,
so where the JAX package scatters a [rows, padded_row] matrix along dim 1
the port lays it out as [|data|, rows, sl] and scatters dim 0: the same
sums in another layout. In shard mode the queue adds (the sharded
microbatch accumulator) or copies (zero1's grad shard) each layer's slot
into that layer's rows of a flat buffer.

Tensor parallelism: each leaf's spec (`models/sharding.py`, the layer's
with the layer dim dropped) goes with its grads. In "full" mode a leaf
sharded over `model` never goes into a bucket: it is this rank's block,
reduced alone over the data ranks that hold the same block
(`ddl_reduce_leaf`, scattered along a dim `model` does not shard, its
pod hop an f32 sum), as in the JAX package; the replicated leaves bucket
as before. "shard" mode flattens every leaf (zero1's layout is
TP-oblivious in the JAX package, and the port's zero1 raises under
tensor parallelism); the sharded microbatch accumulator lays out this
rank's blocks.

Two communicators in flight. Under tensor parallelism the backward
issues its sums over `model` (the activations' grads at the column-parallel
regions' inputs, and a recomputed layer's forward sums) from autograd's
thread on the compute stream, while the queue's worker reduces over the
data axes from its own thread on its own stream. No param's grad needs a
sum over `model` (a sharded leaf's grad is its block's; a replicated
leaf's is formed from replicated activations, the same on every `model`
rank), so a layer goes to the queue with nothing left to do over `model`.
Each process group is used by one thread at a time, in program order:
every rank issues each group's collectives in one order, and the two
groups' overlap. The worker depends only on its data-axis peers and on
the layers put, and the backward on its `model` peers and on the queue's
room, so no wait closes a cycle. On NCCL the two are separate
communicators on separate streams, which the card runs side by side; a
layer's reductions wait (on the card) for what the compute stream had
queued when its grads were put.

Error feedback is not threaded through the hooks, as in the JAX package
(its `custom_vjp` backward returns cotangents only): compressed buckets
quantize statelessly here.
"""
from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import DDLConfig
from repro_torch.core.ddl.allreduce import (POD_SLICE, _leaf_is_replicated, _pod_reduce_,
                                            ddl_reduce_leaf, flat_allreduce, make_buckets)
from repro_torch.core.lms import offload as off
from repro_torch.obs import get_obs
from repro_torch.tree import tree_leaves, tree_unflatten

# executor default when DDLConfig.bucket_mb is None (auto)
DEFAULT_BUCKET_MB = 64


def _bucket_elems(cfg: DDLConfig) -> int:
    """DDLConfig.bucket_mb in f32 elements (reductions run in f32);
    bucket_mb=None means the executor default."""
    mb = DEFAULT_BUCKET_MB if cfg.bucket_mb is None else int(cfg.bucket_mb)
    return max(mb * (1 << 20) // 4, 1)


def _flat_f32(x) -> torch.Tensor:
    return x.float().reshape(-1)


def _reduce_bucket_full(flat, *, mesh, data_axis, pod_axis, data_size, pod_size,
                        compress_dcn, topology_aware):
    """One flat f32 bucket -> fully reduced mean (RS/AR/AG or flat psum)."""
    mean_over = data_size * pod_size
    if not topology_aware:
        axes = (data_axis,) + ((pod_axis,) if pod_axis else ())
        return flat_allreduce(flat, axes, mesh=mesh, mean_over=mean_over)
    pad = (-flat.numel()) % max(data_size, 1)
    flatp = F.pad(flat, (0, pad)) if pad else flat
    # hierarchical_reduce_scatter_flat on a buffer of our own: the pod hop
    # may write into it (with |data| 1 the shard is the bucket itself)
    shard = mesh.psum_scatter(flatp, data_axis)
    _pod_reduce_(shard, shard, mesh=mesh, pod_axis=pod_axis,
                 compress_dcn=compress_dcn, mean_over=mean_over)
    full = mesh.all_gather(shard, data_axis)
    return full[:flat.numel()]


def _reduce_bucket_shard(parts, *, mesh, data_axis, pod_axis, data_size, pod_size,
                         compress_dcn):
    """Reduce a bucket of leaves keeping only this rank's 1/|data| slot of
    EACH leaf, written into a zero grad of the leaf's shape and dtype
    (phases 1-2 only; no all-gather).

    Rank r owns elements [r*sl, (r+1)*sl) of every leaf's padded flat row,
    the ShardSpec layout (not rank r's chunk of the concatenated bucket).
    Each leaf is laid out [d, sl], the leaves side by side: row r holds
    every leaf's rank-r chunk, and one reduce-scatter over the rows hands
    each rank exactly its chunks."""
    d = max(data_size, 1)
    mean_over = data_size * pod_size
    cols, sls = [], []
    for g in parts:
        flat = _flat_f32(g)
        pr = flat.numel() + ((-flat.numel()) % d)
        sls.append(pr // d)
        cols.append(F.pad(flat, (0, pr - flat.numel())).view(d, pr // d))
    mat = torch.cat(cols, dim=1)                             # [d, bucket_sl]
    shard = mesh.psum_scatter(mat, data_axis).reshape(-1)   # [bucket_sl]
    _pod_reduce_(shard, shard, mesh=mesh, pod_axis=pod_axis, compress_dcn=compress_dcn,
                 mean_over=mean_over)
    rank = mesh.index(data_axis)
    out, off = [], 0
    for g, sl in zip(parts, sls):
        full = torch.zeros(d * sl, dtype=torch.float32, device=shard.device)
        full[rank * sl:(rank + 1) * sl] = shard[off:off + sl]
        out.append(full[:max(g.numel(), 1)].reshape(g.shape).to(g.dtype))
        off += sl
    return out


def local_slot(g, data_size: int, rank: int) -> torch.Tensor:
    """Rank `rank`'s slot of one layer's (or unstacked leaf's) grad, as the
    shard mode lays it out: f32 elements [rank*sl, (rank+1)*sl) of the
    flat leaf padded to a multiple of |data| with zeros."""
    d = max(data_size, 1)
    flat = g.reshape(-1)
    sl = (flat.numel() + (-flat.numel()) % d) // d
    lo, hi = rank * sl, min((rank + 1) * sl, flat.numel())
    part = flat[lo:hi].float()
    return F.pad(part, (0, sl - part.numel())) if part.numel() < sl else part


def _split_bucket(flat, leaves):
    """Undo the concat of `leaves` (original shapes/dtypes) from flat f32."""
    out, off = [], 0
    for g in leaves:
        n = max(g.numel(), 1)
        out.append(flat[off:off + n].reshape(g.shape).to(g.dtype))
        off += n
    return out


def reduce_tree_bucketed(ct, cfg: DDLConfig, *, mesh, data_axis: str,
                         pod_axis: Optional[str], data_size: int, pod_size: int,
                         keep: str = "full", param_specs=None):
    """DDL-reduce one layer's grad tree with fixed-size bucketing: with
    keep="full" each bucket to its full mean, with keep="shard" to this
    rank's slot of each leaf in a zero grad (`_reduce_bucket_shard`). This
    is the hook's backward, exposed for direct testing. Counts the buckets
    and their f32 bytes on the global registry (`ddl.buckets`,
    `ddl.bucket_bytes`) and records a `ddl.bucket` event, once a call.
    `param_specs`: the leaves' specs in tree order; in "full" mode (and
    topology-aware) a leaf sharded over `model` reduces alone
    (`ddl_reduce_leaf`), never in a bucket, as in the JAX package."""
    if keep not in ("full", "shard"):
        raise ValueError(f"keep must be 'full' or 'shard', not {keep!r}")
    leaves = tree_leaves(ct)
    specs = param_specs if param_specs is not None else [None] * len(leaves)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(specs)} specs for {len(leaves)} leaves")
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    bucketable = []
    for i, (g, sp) in enumerate(zip(leaves, specs)):
        if keep == "full" and cfg.topology_aware and not _leaf_is_replicated(sp):
            r, _ = ddl_reduce_leaf(g, mesh=mesh, data_axis=data_axis, pod_axis=pod_axis,
                                   data_size=data_size, pod_size=pod_size,
                                   compress_dcn=cfg.compress_dcn,
                                   topology_aware=cfg.topology_aware, spec=sp)
            out[i] = r.to(g.dtype)
        else:
            bucketable.append(i)
    sizes = [max(leaves[i].numel(), 1) for i in bucketable]
    buckets = [[bucketable[j] for j in b] for b in make_buckets(sizes, _bucket_elems(cfg))]
    if buckets:
        obs = get_obs()
        obs.instant("ddl.bucket", buckets=len(buckets), bytes=4 * sum(sizes), keep=keep)
        obs.registry.counter("ddl.buckets").inc(len(buckets))
        obs.registry.counter("ddl.bucket_bytes").inc(4 * sum(sizes))
    axes = dict(mesh=mesh, data_axis=data_axis, pod_axis=pod_axis, data_size=data_size,
                pod_size=pod_size, compress_dcn=cfg.compress_dcn)
    for bucket in buckets:
        parts = [leaves[i] for i in bucket]
        if keep == "full":
            flat = torch.cat([_flat_f32(p) for p in parts])
            reduced = _split_bucket(_reduce_bucket_full(
                flat, topology_aware=cfg.topology_aware, **axes), parts)
        else:
            reduced = _reduce_bucket_shard(parts, **axes)
        for i, r in zip(bucket, reduced):
            out[i] = r
    return tree_unflatten(ct, out)


class _ReduceGrads(torch.autograd.Function):
    """Identity over a layer's param leaves (views of the resident stack)
    whose backward hands their grads to the hook's reduction queue with
    `dst`, the layer's slot of the step's grads tree, and returns no grad
    for them: autograd accumulates nothing into the stack. A None grad
    arrives as zeros, as a JAX cotangent would. `anchor`, the layer input,
    only ties the node into the graph (the stack's leaves need no grad),
    as the LMS executor's `_LayerParams` does; it gets no grad from here."""

    @staticmethod
    def forward(ctx, anchor, queue, i, dst, *leaves):
        ctx.queue, ctx.i, ctx.dst = queue, i, dst
        return tuple(t.detach() for t in leaves)

    @staticmethod
    def backward(ctx, *grads):
        ctx.queue.put(ctx.i, tree_unflatten(ctx.dst, list(grads)), ctx.dst)
        return (None,) * (4 + len(grads))


_WORKER_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def worker_stream(device) -> "torch.cuda.Stream":
    """The reduction queue's CUDA stream on `device`, made once."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _WORKER_STREAMS:
        _WORKER_STREAMS[device] = torch.cuda.Stream(device)
    return _WORKER_STREAMS[device]


class ReductionQueue:
    """The overlapped backward's reductions, one layer at a time, on a
    worker thread of their own (a FIFO: layers reduce in the order they
    were put, so every rank's collectives come in one order).

    A step opens the queue (`open`), the backward puts each layer's grads
    in (`put`, from the hook's `_ReduceGrads` or the LMS executor's sink:
    the layer's grads tree and its slot in the grads tree to write the mean
    into), and the step drains it (`drain`) before any other collective of
    its own: no collective runs on two threads at once.
    Each step has a worker and a FIFO of its own. After a backward that
    raised, `abandon` lets the worker reduce the layers already put (every
    rank whose backward raised at the same point so issues the same
    collectives) and waits for it, so the next step's collectives never
    run beside the abandoned step's.

    On the card the worker reduces on its own stream (`worker_stream`),
    which first waits for an event recorded when the layer's grads exist;
    every tensor it reads is recorded on its stream for the allocator; the
    mean is copied into the slot on that stream (`non_blocking` into
    pinned host memory). `drain` makes the current stream wait for the
    worker's. On the CPU the same code runs with plain copies.

    With `squares` (an `optim.adamw.StackSquares`), each layer's mean also
    goes into the per-slice sums of squares of the global norm there,
    while it is on the device: the clip then needs no second read of grads
    sunk to the host.

    With `slot` (the hook's shard mode): each layer's dst is its rows of
    a flat f32 buffer (one [sl] view a leaf), and the queue writes this
    rank's slot of the layer's reduced grads there (`slot`, rounded to the
    param's dtype first, as the hook's output is): added with
    `open(accumulate=True)` (the sharded microbatch accumulator), copied
    otherwise (zero1's grad shard).

    Timing, of the last step (host clock): `reduce_s`, the worker's time
    reducing; `under_backward_s`, the part of it before the backward
    ended (`drain` was called); `drain_wait_s`, how long `drain` waited."""

    def __init__(self, reduce: Callable, sink: Optional[str] = None,
                 slot: Optional[Callable] = None):
        self.reduce = reduce
        self.sink = sink
        self.slot = slot
        self._step = None
        self.reduce_s = self.under_backward_s = self.drain_wait_s = 0.0

    def open(self, device, depth: int, squares=None, accumulate: bool = False) -> None:
        """Start a step's queue: at most `depth` layers waiting; in shard
        mode `accumulate` adds each slot into its dst instead of copying."""
        if self._step is not None:
            raise RuntimeError("ReductionQueue.open: the last step's queue was not drained")
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = worker_stream(self.device) if self.cuda else None
        step = self._step = _QueueStep(max(int(depth), 1), squares, accumulate)
        step.thread = threading.Thread(target=self._work, args=(step,), name="ddl-reduce",
                                       daemon=True)
        step.thread.start()

    def put(self, i: int, grads, dst) -> None:
        """Queue layer i's grads tree; its mean goes into the tree `dst`
        (views into the stack's grads tree). Blocks while `depth` layers
        wait."""
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            for g in tree_leaves(grads):
                g.record_stream(self.stream)
        self._step.count += 1
        self._step.items.put((i, grads, dst, event))

    def _work(self, step: "_QueueStep") -> None:
        if self.cuda:
            torch.cuda.set_device(self.stream.device)
        while True:
            item = step.items.get()
            if item is None:
                return
            if step.error is not None:
                continue
            i, grads, dst, event = item
            t0 = time.monotonic()
            try:
                if self.cuda:
                    with torch.cuda.stream(self.stream):
                        self.stream.wait_event(event)
                        self._reduce_into(i, grads, dst, step.squares, step.accumulate)
                else:
                    self._reduce_into(i, grads, dst, step.squares, step.accumulate)
            except BaseException as e:      # the thread's boundary: drain raises it
                step.error = e
            step.spans.append((t0, time.monotonic()))
            del item, grads, dst

    def _reduce_into(self, i: int, grads, dst, squares, accumulate: bool = False) -> None:
        red = tree_leaves(self.reduce(grads))
        if self.slot is not None:
            red = [self.slot(r) for r in red]
        if squares is not None:
            squares.add(i, red)
        if self.sink == off.HOST:
            off.record_swap("lms.swap_out", sum(r.numel() * r.element_size() for r in red),
                            "grads")
        for d, r in zip(tree_leaves(dst), red):
            if accumulate:
                d.add_(r)
            else:
                d.copy_(r, non_blocking=self.cuda)

    def drain(self, layers: int) -> None:
        """Wait for every queued layer; raise what a reduction raised, or
        unless `layers` layers were put. The current stream then waits
        for the worker's."""
        t0 = time.monotonic()
        step, self._step = self._step, None
        step.items.put(None)
        step.thread.join()
        self.drain_wait_s = time.monotonic() - t0
        self.reduce_s = sum(b - a for a, b in step.spans)
        self.under_backward_s = sum(max(min(b, t0) - a, 0.0) for a, b in step.spans)
        if step.error is not None:
            raise step.error
        if step.count != layers:
            raise RuntimeError(f"ReductionQueue: {step.count} layers were put, not {layers}")
        if self.cuda:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_stream(self.stream)
            if step.squares is not None:
                for sums in step.squares.sums:
                    for t in sums:
                        t.record_stream(cur)

    def abandon(self) -> None:
        """After a failed backward: wait for the step's worker to reduce
        the layers already put and end, and order the current stream after
        its stream. A reduction's error is dropped (the backward's is the
        one raised)."""
        step, self._step = self._step, None
        if step is None:
            return
        step.items.put(None)
        step.thread.join()
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)


class _QueueStep:
    """One step of a ReductionQueue: its FIFO (at most `depth` layers
    waiting), worker, layers put, the worker's spans and error, and
    whether shard-mode slots are added or copied."""

    def __init__(self, depth: int, squares, accumulate: bool = False):
        self.items: "queue.Queue" = queue.Queue(maxsize=depth)
        self.squares = squares
        self.accumulate = accumulate
        self.thread = None
        self.count = 0
        self.spans: List[tuple] = []
        self.error: Optional[BaseException] = None


class GradReduceHook:
    """A layer's DDL reduction: called on a layer's param tree (`lp =
    hook(lp, i, dst, x)`), an identity whose backward queues the layer's
    grads on `queue` (the resident stack; the LMS executor puts them there
    itself), which reduces them on its worker thread and writes the mean
    into `dst`; `reduce(ct)` reduces one layer's grads tree (the queue's
    buckets, so its sums). `keep`: "full" or "shard" (the module
    docstring). `sink`: where the queue writes the means, None (the
    device) or the pinned host kind (`offload.HOST`: the gradient host
    sink)."""

    def __init__(self, cfg: DDLConfig, *, mesh, data_axis: str, pod_axis: Optional[str],
                 data_size: int, pod_size: int, keep: str = "full",
                 sink: Optional[str] = None, param_specs=None):
        if keep not in ("full", "shard"):
            raise ValueError(f"keep must be 'full' or 'shard', not {keep!r}")
        self.cfg, self.mesh, self.keep = cfg, mesh, keep
        self.param_specs = param_specs
        self.axes = dict(data_axis=data_axis, pod_axis=pod_axis, data_size=data_size,
                         pod_size=pod_size)
        self.queue = ReductionQueue(self.reduce, sink,
                                    self.slot if keep == "shard" else None)

    def reduce(self, ct):
        return reduce_tree_bucketed(ct, self.cfg, mesh=self.mesh, keep=self.keep,
                                    param_specs=self.param_specs, **self.axes)

    def slot(self, g) -> torch.Tensor:
        """This rank's slot of one layer's leaf (`local_slot`)."""
        return local_slot(g, self.axes["data_size"], self.mesh.index(self.axes["data_axis"]))

    def __call__(self, tree, i: int, dst, anchor):
        """Layer i's param tree through `_ReduceGrads`: its backward puts
        the layer's grads on the queue, their mean bound for `dst` (layer
        i's slot of the step's grads tree); `anchor`: the layer's input."""
        outs = _ReduceGrads.apply(anchor, self.queue, i, dst, *tree_leaves(tree))
        return tree_unflatten(tree, (outs,) if torch.is_tensor(outs) else outs)


def make_grad_reduce_hook(cfg: DDLConfig, *, mesh, data_axis: str = "data",
                          pod_axis: Optional[str] = None, data_size: int = 1,
                          pod_size: int = 1, keep: str = "full",
                          sink: Optional[str] = None, param_specs=None) -> GradReduceHook:
    """Identity-forward wrapper whose backward queues the grads for their
    DDL reduction: wrap a layer's param tree before the layer runs (`lp =
    hook(lp, i, dst, x)`), and the queue issues that layer's collectives as
    soon as its grads exist.
    `keep`: "full" or "shard". `sink`: the memory kind the LMS executor's
    queue writes the reduced grads to (`offload.HOST` for a plan with
    grads on the host; None keeps them on the device), as the JAX
    package's `sink`. `param_specs`: the layer's leaves' specs in tree
    order (`reduce_tree_bucketed`)."""
    return GradReduceHook(cfg, mesh=mesh, data_axis=data_axis, pod_axis=pod_axis,
                          data_size=data_size, pod_size=pod_size, keep=keep, sink=sink,
                          param_specs=param_specs)


def make_stack_hooks(stack_names: Iterable[str], cfg: DDLConfig, *, mesh,
                     data_axis: str = "data", pod_axis: Optional[str] = None,
                     data_size: int = 1, pod_size: int = 1, keep: str = "full",
                     sink: Optional[str] = None,
                     stack_specs: Optional[Dict[str, list]] = None) -> Dict[str, GradReduceHook]:
    """One hook per decoder stack group, by name. `keep`, `sink`: as
    `make_grad_reduce_hook`'s; `stack_specs`: {name: the group's layer
    leaves' specs in tree order}, as the JAX package's per-group spec
    trees."""
    stack_specs = stack_specs or {}
    return {name: make_grad_reduce_hook(
                cfg, mesh=mesh, data_axis=data_axis, pod_axis=pod_axis,
                data_size=data_size, pod_size=pod_size, keep=keep, sink=sink,
                param_specs=stack_specs.get(name))
            for name in stack_names}


# ---------------------------------------------------------------------------
# Shard-major flat layout (zero1 state / sharded microbatch accumulator)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardSpec:
    """Layout of one rank's flat shard of a reduce-scattered tree.

    Each leaf is a [rows, rowsize] matrix (rows: the layer count for a
    stacked decoder leaf, 1 otherwise) with rowsize zero-padded to
    `padded_row` (a multiple of |data|). Rank r's shard of a leaf is its
    column block [:, r*sl:(r+1)*sl] (sl = padded_row / |data|); the flat
    local vector is those blocks flattened and concatenated in leaf
    order."""
    shapes: List[Tuple[int, ...]]
    dtypes: List
    rows: List[int]
    rowsizes: List[int]
    padded_rows: List[int]
    treedef: object       # the laid-out tree: its structure for unflatten
    data_size: int

    @property
    def local_size(self) -> int:
        d = max(self.data_size, 1)
        return sum(r * (p // d) for r, p in zip(self.rows, self.padded_rows))

    @property
    def padded(self) -> int:
        """Global flat length (every rank's local vector, rank-major)."""
        return max(self.data_size, 1) * self.local_size

    def offsets(self) -> List[int]:
        """Each leaf's start in the local vector."""
        d = max(self.data_size, 1)
        out, off = [], 0
        for r, p in zip(self.rows, self.padded_rows):
            out.append(off)
            off += r * (p // d)
        return out


def shard_spec(tree, data_size: int, stacked=None) -> ShardSpec:
    """The layout of a tree of tensors (meta tensors will do). `stacked`: a
    matching tree of bools, True for leaves whose leading dim is the
    decoder stack's layer dim."""
    leaves = tree_leaves(tree)
    flags = [False] * len(leaves) if stacked is None else tree_leaves(stacked)
    if len(flags) != len(leaves):
        raise ValueError(f"stacked has {len(flags)} leaves, the tree {len(leaves)}")
    d = max(data_size, 1)
    shapes, dtypes, rows, rowsizes, padded = [], [], [], [], []
    for leaf, st in zip(leaves, flags):
        shape = tuple(leaf.shape)
        n = math.prod(shape)
        r = shape[0] if (st and shape) else 1
        rs = max(n // max(r, 1), 1)
        shapes.append(shape)
        dtypes.append(leaf.dtype)
        rows.append(r)
        rowsizes.append(rs)
        padded.append(rs + ((-rs) % d))
    return ShardSpec(shapes, dtypes, rows, rowsizes, padded, tree, d)


def _leaf_rows(g, r: int, rs: int, pr: int) -> torch.Tensor:
    """A leaf as f32 [r, pr]: its rows, zero-padded."""
    x = g.float().reshape(r, rs)
    return F.pad(x, (0, pr - rs)) if pr > rs else x


def _by_rank(x, d: int) -> torch.Tensor:
    """[r, d * sl] -> [d, r, sl] contiguous: column block k as block k of
    dim 0, where the port's collectives scatter and gather."""
    r, pr = x.shape
    return x.reshape(r, d, pr // d).transpose(0, 1).contiguous()


def local_shard_parts(tree, spec: ShardSpec, reduced, *, mesh, data_axis: str,
                      pod_axis: Optional[str], mean_over: int, compress_dcn: bool = False):
    """Yield (offset in the local vector, this rank's flat f32 part of the
    leaf) for each leaf of the DDL-reduced tree, in leaf order
    (`leaf_shard_parts`). `reduced`: a matching tree of bools, True for
    leaves the shard-mode hook already reduced, False for the rest. A leaf
    given as None is skipped (its part is elsewhere already: the LMS
    executor's queue, or a reduction as the backward made it, wrote it)."""
    leaves = tree_leaves(tree)
    flags = tree_leaves(reduced)
    if len(flags) != len(leaves):
        raise ValueError(f"reduced has {len(flags)} leaves, the tree {len(leaves)}")
    for j, (g, was_reduced) in enumerate(zip(leaves, flags)):
        if g is not None:
            yield from leaf_shard_parts(g, spec, j, was_reduced, mesh=mesh, data_axis=data_axis,
                                        pod_axis=pod_axis, mean_over=mean_over,
                                        compress_dcn=compress_dcn)


def leaf_shard_parts(g, spec: ShardSpec, j: int, was_reduced: bool = False, *, mesh,
                     data_axis: str, pod_axis: Optional[str], mean_over: int,
                     compress_dcn: bool = False):
    """Yield (offset in the local vector, this rank's flat f32 part) of
    leaf j's grad `g`: sliced out when the shard-mode hook already reduced
    it (zeros outside this rank's slot, no collective), else
    reduce-scattered over `data`, then the pod hop and the mean; an
    unstacked leaf of more than `POD_SLICE` elements a rank in pieces of
    that many, each yielded at its own offset. `g` may be a table's grad
    in its rows' form (`models/rest.RowsGrad`): the pieces form only their
    own elements."""
    d = spec.data_size
    r, rs, pr, off = spec.rows[j], spec.rowsizes[j], spec.padded_rows[j], spec.offsets()[j]
    sl = pr // d
    if r == 1 and sl > POD_SLICE and not was_reduced:
        # a large unstacked leaf (an embedding, a head): reduced POD_SLICE
        # columns of each rank's block at a time, so no f32 copy of the
        # whole leaf stands; the pod hop sees the slices it would have cut
        # from the whole part
        for k in range(0, sl, POD_SLICE):
            w = min(POD_SLICE, sl - k)
            x = torch.zeros(d, w, dtype=torch.float32, device=g.device)
            for q in range(d):
                a, b = q * sl + k, min(q * sl + k + w, rs)
                if a < b:
                    x[q, :b - a] = _flat_range(g, a, b)
            yield off + k, _reduced(x, mesh=mesh, data_axis=data_axis, pod_axis=pod_axis,
                                    compress_dcn=compress_dcn, mean_over=mean_over)
        return
    g = g.dense() if hasattr(g, "dense") else g
    if was_reduced:
        rank = mesh.index(data_axis)
        rows = g.reshape(r, rs)
        if r == 1:
            part = local_slot(rows, d, rank)
        else:
            part = torch.stack([local_slot(row, d, rank) for row in rows]).reshape(-1)
    else:
        x = _leaf_rows(g, r, rs, pr)
        x = x.reshape(d, sl) if r == 1 else _by_rank(x, d)
        part = _reduced(x, mesh=mesh, data_axis=data_axis, pod_axis=pod_axis,
                        compress_dcn=compress_dcn, mean_over=mean_over)
    yield off, part


def _flat_range(g, a: int, b: int) -> torch.Tensor:
    """Elements a:b of a grad's flattened form; a grad in its rows' form
    forms only those."""
    return g.flat_range(a, b) if hasattr(g, "flat_range") else g.reshape(-1)[a:b]


def _reduced(x, *, mesh, data_axis, pod_axis, compress_dcn, mean_over):
    """Phases 1-2 and the mean of `x` [d, ...] laid out by rank: this
    rank's flat f32 part."""
    part = mesh.psum_scatter(x, data_axis).reshape(-1)
    if part.data_ptr() == x.data_ptr():
        part = part.clone()     # |data| 1: the pod hop writes in place
    _pod_reduce_(part, part, mesh=mesh, pod_axis=pod_axis,
                 compress_dcn=compress_dcn, mean_over=mean_over)
    return part


def collect_local_shards(tree, spec: ShardSpec, reduced, *, mesh, data_axis: str,
                         pod_axis: Optional[str], mean_over: int,
                         compress_dcn: bool = False) -> torch.Tensor:
    """One rank's flat [local_size] f32 shard of the DDL-reduced tree
    (`local_shard_parts`, concatenated)."""
    parts = [p for _, p in local_shard_parts(
        tree, spec, reduced, mesh=mesh, data_axis=data_axis, pod_axis=pod_axis,
        mean_over=mean_over, compress_dcn=compress_dcn)]
    return torch.cat(parts)


def leaf_part(flat, spec: ShardSpec, j: int) -> torch.Tensor:
    """Leaf j's part of the local vector `flat`: [rows * sl], a view."""
    r, sl = spec.rows[j], spec.padded_rows[j] // spec.data_size
    off = spec.offsets()[j]
    return flat[off:off + r * sl]


def gather_rows(rows, spec: ShardSpec, j: int, *, mesh, data_axis: str) -> torch.Tensor:
    """Rows i0:i0 + n of leaf j (a stacked leaf's layers i0:i0 + n, or a
    whole unstacked leaf at n = 1) from the same rows of its local part,
    `rows` [n, sl]: the column blocks all-gathered over `data`, unpadded,
    f32 [n, rowsize]. Only those n rows stand gathered."""
    d = spec.data_size
    rs, sl = spec.rowsizes[j], spec.padded_rows[j] // d
    n = rows.shape[0]
    full = mesh.all_gather(rows, data_axis)                   # [d * n, sl]
    if n > 1 and d > 1:
        full = full.reshape(d, n, sl).transpose(0, 1)
    return full.reshape(n, d * sl)[:, :rs]


def gather_leaf(part, spec: ShardSpec, j: int, *, mesh, data_axis: str) -> torch.Tensor:
    """Leaf j from its local part (`leaf_part`): the column blocks
    all-gathered over `data`, unpadded, in the leaf's shape, f32."""
    r, sl = spec.rows[j], spec.padded_rows[j] // spec.data_size
    return gather_rows(part.reshape(r, sl), spec, j, mesh=mesh,
                       data_axis=data_axis).reshape(spec.shapes[j])


def allgather_local_shards(flat, spec: ShardSpec, *, mesh, data_axis: str):
    """Invert `collect_local_shards`: every leaf gathered (`gather_leaf`),
    f32, in the spec's tree."""
    return tree_unflatten(spec.treedef, [gather_leaf(leaf_part(flat, spec, j), spec, j,
                                                     mesh=mesh, data_axis=data_axis)
                                         for j in range(len(spec.shapes))])


def pack_global(tree, spec: ShardSpec) -> torch.Tensor:
    """Full tree -> the global flat [|data| * local_size] f32 vector in
    shard-major order (rank r's local vector is block r). No collectives."""
    d = spec.data_size
    blocks = [_by_rank(_leaf_rows(g, r, rs, pr), d).reshape(d, -1)
              for g, r, rs, pr in zip(tree_leaves(tree), spec.rows, spec.rowsizes,
                                      spec.padded_rows)]
    return torch.cat(blocks, dim=1).reshape(-1)


def rank_block(tree, spec: ShardSpec, rank: int, out: torch.Tensor) -> torch.Tensor:
    """Rank `rank`'s block of `pack_global(tree, spec)`, leaf by leaf into
    `out` (f32 [local_size], anywhere): no leaf's f32 copy stands whole."""
    d = spec.data_size
    for g, r, rs, pr, off in zip(tree_leaves(tree), spec.rows, spec.rowsizes,
                                 spec.padded_rows, spec.offsets()):
        sl = pr // d
        rows = g.reshape(r, rs)
        for i in range(r):
            out[off + i * sl:off + (i + 1) * sl].copy_(local_slot(rows[i], d, rank))
    return out


def unpack_global(flat, spec: ShardSpec):
    """Inverse of `pack_global` (f32 leaves, their shapes)."""
    d = spec.data_size
    mat = flat.reshape(d, spec.local_size)
    out = []
    for shape, r, rs, pr, off in zip(spec.shapes, spec.rows, spec.rowsizes,
                                     spec.padded_rows, spec.offsets()):
        sl = pr // d
        x = mat[:, off:off + r * sl].reshape(d, r, sl).transpose(0, 1).reshape(r, pr)
        out.append(x[:, :rs].reshape(shape))
    return tree_unflatten(spec.treedef, out)
