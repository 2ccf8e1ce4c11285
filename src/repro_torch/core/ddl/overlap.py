"""Overlapped backward: DDL gradient reduction issued inside the backward
pass, layer by layer — the port of the JAX package's `core/ddl/overlap.py`
in its "full" keep mode.

The post-hoc `ddl_reduce_tree` pass serializes every RS/AR/AG behind the
last layer's backward. `make_grad_reduce_hook` instead wraps one layer's
params in an identity `torch.autograd.Function` whose backward applies
the DDL schedule to that layer's grads, so each layer's collectives are
issued as soon as the backward has produced them, while the layers below
are still to come. Forward is the identity: the model's graph is
untouched. The hook wraps the layer outside its activation checkpoint, so
the recompute in the backward reruns no collective.

Small leaves coalesce into fixed-size buckets (`make_buckets`, sized by
`DDLConfig.bucket_mb`), so the fabric sees few large collectives instead
of one per norm-scale vector. Bucketing is per layer: bucketing across
layers would serialize the backward sweep the hook exists to overlap.
Each bucket goes RS(data) -> AR(pod) -> AG(data) and comes back as the
fully reduced mean gradient (the paper's allreduce schedule).

Under LMS (the layer-streaming executor, `models/transformer.py`) the
stack is not differentiated through autograd: each layer's grads leave the
backward through the executor's sink, which hands them to the hook's
`ReductionQueue`. One worker thread a rank, on a CUDA stream of its own,
reduces the layers one after another in the order the backward produced
them (so every rank issues the same collectives in the same order, with
the same buckets as the hook's backward: the same sums) and writes each
layer's mean into the grads tree, on the device or, with `sink=` the
pinned host kind, in pinned host memory: the gradient host sink of a plan
that puts grads on the host. The backward goes on to the layers below
while a layer reduces; it waits only when `depth` layers are queued. The
hook's own backward (`_ReduceGrads`, the resident path) still reduces
inline, blocking the backward.

Not ported yet: the JAX package's "shard" keep mode, `ShardSpec` and the
shard-major layout of the zero1 step and of the sharded microbatch
accumulator; its "full" mode is the only one here, without a `keep`
argument.
Error feedback is not threaded through the hooks, as in the JAX package
(its `custom_vjp` backward returns cotangents only): compressed buckets
quantize statelessly here.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.config.base import DDLConfig
from repro_torch.core.ddl.allreduce import (_pod_reduce_, flat_allreduce,
                                            make_buckets)
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


def _split_bucket(flat, leaves):
    """Undo the concat of `leaves` (original shapes/dtypes) from flat f32."""
    out, off = [], 0
    for g in leaves:
        n = max(g.numel(), 1)
        out.append(flat[off:off + n].reshape(g.shape).to(g.dtype))
        off += n
    return out


def reduce_tree_bucketed(ct, cfg: DDLConfig, *, mesh, data_axis: str,
                         pod_axis: Optional[str], data_size: int, pod_size: int):
    """DDL-reduce one layer's grad tree with fixed-size bucketing, each
    bucket to its full mean (the JAX package's keep="full"). This is the
    hook's backward, exposed for direct testing. Counts the buckets and
    their f32 bytes on the global registry (`ddl.buckets`,
    `ddl.bucket_bytes`) and records a `ddl.bucket` event, once a call."""
    leaves = tree_leaves(ct)
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    sizes = [max(g.numel(), 1) for g in leaves]
    buckets = make_buckets(sizes, _bucket_elems(cfg))
    if buckets:
        obs = get_obs()
        obs.instant("ddl.bucket", buckets=len(buckets), bytes=4 * sum(sizes), keep="full")
        obs.registry.counter("ddl.buckets").inc(len(buckets))
        obs.registry.counter("ddl.bucket_bytes").inc(4 * sum(sizes))
    for bucket in buckets:
        parts = [leaves[i] for i in bucket]
        flat = torch.cat([_flat_f32(p) for p in parts])
        red = _reduce_bucket_full(
            flat, mesh=mesh, data_axis=data_axis, pod_axis=pod_axis,
            data_size=data_size, pod_size=pod_size, compress_dcn=cfg.compress_dcn,
            topology_aware=cfg.topology_aware)
        for i, r in zip(bucket, _split_bucket(red, parts)):
            out[i] = r
    return tree_unflatten(ct, out)


class _ReduceGrads(torch.autograd.Function):
    """Identity over a layer's param leaves whose backward DDL-reduces
    their grads (a None grad arrives as zeros, as a JAX cotangent would)."""

    @staticmethod
    def forward(ctx, reduce, template, *leaves):
        ctx.reduce, ctx.template = reduce, template
        return tuple(x.view_as(x) for x in leaves)

    @staticmethod
    def backward(ctx, *grads):
        red = ctx.reduce(tree_unflatten(ctx.template, grads))
        return (None, None) + tuple(tree_leaves(red))


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
    """The LMS + DDL backward's reductions, one layer at a time, on a
    worker thread of their own (a FIFO: layers reduce in the order they
    were put, so every rank's collectives come in one order).

    A step opens the queue (`open`), the executor's sink puts each layer's
    grads in (`put`: the layer's grads tree and its slot in the grads tree
    to write the mean into), and the step drains it (`drain`) before any
    other collective of its own: no collective runs on two threads at once.
    Each step has a worker and a FIFO of its own, so a worker left behind
    by a failed step (`abandon`) never takes the next step's layers.

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

    Timing, of the last step (host clock): `reduce_s`, the worker's time
    reducing; `under_backward_s`, the part of it before the backward
    ended (`drain` was called); `drain_wait_s`, how long `drain` waited."""

    def __init__(self, reduce: Callable, sink: Optional[str] = None):
        self.reduce = reduce
        self.sink = sink
        self._step = None
        self.reduce_s = self.under_backward_s = self.drain_wait_s = 0.0

    def open(self, device, depth: int, squares=None) -> None:
        """Start a step's queue: at most `depth` layers waiting."""
        if self._step is not None:
            raise RuntimeError("ReductionQueue.open: the last step's queue was not drained")
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = worker_stream(self.device) if self.cuda else None
        step = self._step = _QueueStep(max(int(depth), 1), squares)
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
            if step.error is not None or step.stop:
                continue
            i, grads, dst, event = item
            t0 = time.monotonic()
            try:
                if self.cuda:
                    with torch.cuda.stream(self.stream):
                        self.stream.wait_event(event)
                        self._reduce_into(i, grads, dst, step.squares)
                else:
                    self._reduce_into(i, grads, dst, step.squares)
            except BaseException as e:      # the thread's boundary: drain raises it
                step.error = e
            step.spans.append((t0, time.monotonic()))
            del item, grads, dst

    def _reduce_into(self, i: int, grads, dst, squares) -> None:
        red = tree_leaves(self.reduce(grads))
        if squares is not None:
            squares.add(i, red)
        if self.sink == off.HOST:
            off.record_swap("lms.swap_out", sum(r.numel() * r.element_size() for r in red),
                            "grads")
        for d, r in zip(tree_leaves(dst), red):
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
        """After a failed backward: the step's worker runs no further
        reduction and ends; nothing waits for it."""
        step, self._step = self._step, None
        if step is not None:
            step.stop = True
            step.items.put(None)


class _QueueStep:
    """One step of a ReductionQueue: its FIFO (at most `depth` layers
    waiting), worker, layers put, the worker's spans and error."""

    def __init__(self, depth: int, squares):
        self.items: "queue.Queue" = queue.Queue(maxsize=depth)
        self.squares = squares
        self.thread = None
        self.count = 0
        self.spans: List[tuple] = []
        self.error: Optional[BaseException] = None
        self.stop = False


class GradReduceHook:
    """A layer's DDL reduction, two ways: called on a layer's param tree
    (`lp = hook(lp)`), an identity whose backward reduces the layer's
    grads inline (the resident path); `reduce(ct)` reduces one layer's
    grads tree (the same buckets, so the same sums); `queue` reduces
    layers on a worker thread for the LMS executor. `sink`: where the
    queue writes the means, None (the device) or the pinned host kind
    (`offload.HOST`: the gradient host sink)."""

    def __init__(self, cfg: DDLConfig, *, mesh, data_axis: str, pod_axis: Optional[str],
                 data_size: int, pod_size: int, sink: Optional[str] = None):
        self.cfg, self.mesh = cfg, mesh
        self.axes = dict(data_axis=data_axis, pod_axis=pod_axis, data_size=data_size,
                         pod_size=pod_size)
        self.queue = ReductionQueue(self.reduce, sink)

    def reduce(self, ct):
        return reduce_tree_bucketed(ct, self.cfg, mesh=self.mesh, **self.axes)

    def __call__(self, tree):
        outs = _ReduceGrads.apply(self.reduce, tree, *tree_leaves(tree))
        return tree_unflatten(tree, (outs,) if torch.is_tensor(outs) else outs)


def make_grad_reduce_hook(cfg: DDLConfig, *, mesh, data_axis: str = "data",
                          pod_axis: Optional[str] = None, data_size: int = 1,
                          pod_size: int = 1, sink: Optional[str] = None) -> GradReduceHook:
    """Identity-forward wrapper whose backward DDL-reduces the grads: wrap a
    layer's param tree before the layer runs (`lp = hook(lp)`), and the
    backward issues that layer's collectives as soon as its grads exist.
    `sink`: the memory kind the LMS executor's queue writes the reduced
    grads to (`offload.HOST` for a plan with grads on the host; None keeps
    them on the device), as the JAX package's `sink`."""
    return GradReduceHook(cfg, mesh=mesh, data_axis=data_axis, pod_axis=pod_axis,
                          data_size=data_size, pod_size=pod_size, sink=sink)


def make_stack_hooks(stack_names: Iterable[str], cfg: DDLConfig, *, mesh,
                     data_axis: str = "data", pod_axis: Optional[str] = None,
                     data_size: int = 1, pod_size: int = 1,
                     sink: Optional[str] = None) -> Dict[str, GradReduceHook]:
    """One hook per decoder stack group, by name (the JAX package keys them
    by the groups' PartitionSpec trees, which the port does not have).
    `sink`: as `make_grad_reduce_hook`'s."""
    return {name: make_grad_reduce_hook(
                cfg, mesh=mesh, data_axis=data_axis, pod_axis=pod_axis,
                data_size=data_size, pod_size=pod_size, sink=sink)
            for name in stack_names}
