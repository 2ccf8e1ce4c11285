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

Not ported yet: the JAX package's "shard" keep mode, `ShardSpec` and the
shard-major layout of the zero1 step and of the sharded microbatch
accumulator; its "full" mode is the only one here, without a `keep`
argument.
Error feedback is not threaded through the hooks, as in the JAX package
(its `custom_vjp` backward returns cotangents only): compressed buckets
quantize statelessly here.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.config.base import DDLConfig
from repro_torch.core.ddl.allreduce import (_pod_reduce_, flat_allreduce,
                                            make_buckets)
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


def make_grad_reduce_hook(cfg: DDLConfig, *, mesh, data_axis: str = "data",
                          pod_axis: Optional[str] = None, data_size: int = 1,
                          pod_size: int = 1) -> Callable:
    """Identity-forward wrapper whose backward DDL-reduces the grads: wrap a
    layer's param tree before the layer runs (`lp = hook(lp)`), and the
    backward issues that layer's collectives as soon as its grads exist."""

    def reduce(ct):
        return reduce_tree_bucketed(
            ct, cfg, mesh=mesh, data_axis=data_axis, pod_axis=pod_axis,
            data_size=data_size, pod_size=pod_size)

    def hook(tree):
        outs = _ReduceGrads.apply(reduce, tree, *tree_leaves(tree))
        return tree_unflatten(tree, (outs,) if torch.is_tensor(outs) else outs)

    return hook


def make_stack_hooks(stack_names: Iterable[str], cfg: DDLConfig, *, mesh,
                     data_axis: str = "data", pod_axis: Optional[str] = None,
                     data_size: int = 1, pod_size: int = 1) -> Dict[str, Callable]:
    """One hook per decoder stack group, by name (the JAX package keys them
    by the groups' PartitionSpec trees, which the port does not have)."""
    return {name: make_grad_reduce_hook(
                cfg, mesh=mesh, data_axis=data_axis, pod_axis=pod_axis,
                data_size=data_size, pod_size=pod_size)
            for name in stack_names}
