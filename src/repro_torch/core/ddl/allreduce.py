"""DDL's topology-aware gradient reduction over `torch.distributed`: the
port of the JAX package's `core/ddl/allreduce.py`.

The paper's key mechanism: decompose one logical all-reduce into
reduce-scatter + all-gather phases per fabric tier. On a ("pod", "data")
mesh, with each rank's gradients from its own rows of the batch:

    1. reduce-scatter over `data`   (NVLink, fast)     -> 1/data shard
    2. all-reduce over `pod`        (InfiniBand, slow; shard only,
                                     optionally int8)
    3. all-gather over `data`       (NVLink)           -> full gradient

Every collective goes through the rank's `launch.mesh.Mesh` (`mesh=`),
where the JAX package names an axis of its `shard_map`. The port has no
tensor parallelism yet: every leaf is replicated, so the JAX package's
per-leaf PartitionSpecs (`param_specs`, `spec`) have no counterpart here.
The beyond-paper zero1 mode (`train/steps.build_zero1_train_step`) stops at
phase 2 (`hierarchical_reduce_scatter_flat`), updates its 1/|data| shard of
the optimizer state and all-gathers the params.

Memory. Phase 2 runs on slices of at most `POD_SLICE` = 2**24 elements of
the flat shard, so its f32 work buffers stay at a few x 64 MiB whatever
the leaf (the [152064, 5120] embedding of qwen2.5-14b would need ~11 GB of
them at once). 2**24 is a multiple of the 1024-element quantization row,
so the rows, scales and codes are the whole shard's, and every other step
is elementwise: slicing changes no number.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import DDLConfig
from repro_torch.core.ddl.compress import compressed_allreduce_pod
from repro_torch.tree import tree_leaves, tree_unflatten

# elements of the flat shard per pod-hop slice: the default DDL bucket
# (64 MiB of f32) and a multiple of the quantization row
POD_SLICE = 1 << 24


# ---------------------------------------------------------------------------
# Flat packing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackSpec:
    shapes: List[Tuple[int, ...]]
    dtypes: List
    sizes: List[int]
    treedef: object       # the packed tree: its structure for unpack
    total: int
    pad_to: int

    @property
    def padded(self) -> int:
        n = self.total
        return n + ((-n) % self.pad_to)


def pack_spec(tree, pad_to: int) -> PackSpec:
    leaves = tree_leaves(tree)
    shapes = [tuple(l.shape) for l in leaves]
    dtypes = [l.dtype for l in leaves]
    sizes = [l.numel() for l in leaves]
    return PackSpec(shapes, dtypes, sizes, tree, int(sum(sizes)), pad_to)


def pack(tree, spec: PackSpec, dtype=torch.float32) -> torch.Tensor:
    flat = torch.cat([l.to(dtype).reshape(-1) for l in tree_leaves(tree)])
    return F.pad(flat, (0, spec.padded - spec.total))


def pack_block(tree, spec: PackSpec, rank: int, out: torch.Tensor) -> torch.Tensor:
    """Rank `rank`'s block of `pack(tree, spec)` split in `spec.pad_to`
    equal blocks (zero1's shard), leaf by leaf into `out` (f32, anywhere):
    no leaf's f32 copy stands whole."""
    n = spec.padded // spec.pad_to
    lo = rank * n
    out.zero_()
    off = 0
    for leaf, size in zip(tree_leaves(tree), spec.sizes):
        a, b = max(off, lo), min(off + size, lo + n)
        if a < b:
            out[a - lo:b - lo].copy_(leaf.reshape(-1)[a - off:b - off].float())
        off += size
    return out


def unpack(flat: torch.Tensor, spec: PackSpec):
    out, off = [], 0
    for shape, dt, size in zip(spec.shapes, spec.dtypes, spec.sizes):
        out.append(flat[off:off + size].reshape(shape).to(dt))
        off += size
    return tree_unflatten(spec.treedef, out)


# ---------------------------------------------------------------------------
# The pod hop, slice by slice
# ---------------------------------------------------------------------------

def _pod_reduce_(shard, out, *, mesh, pod_axis: Optional[str], compress_dcn: bool,
                 error_feedback=None, mean_over: int = 1):
    """Phase 2 and the mean on a flat shard: out[i] = (sum over pods of
    shard[i], int8 on the wire if compress_dcn) / mean_over, written into
    the flat `out` (of any float dtype; it may be `shard` itself) slice by
    slice. -> the new flat EF: `error_feedback` itself unless the hop is
    compressed, as in the JAX package."""
    compressed = pod_axis is not None and compress_dcn
    if not compressed or error_feedback is None:
        new_ef = error_feedback
    else:
        new_ef = torch.empty_like(error_feedback)
    for i in range(0, shard.numel(), POD_SLICE):
        x = shard[i:i + POD_SLICE].float()
        if compressed:
            ef = None if error_feedback is None else error_feedback[i:i + POD_SLICE]
            x, ef = compressed_allreduce_pod(x, pod_axis, mesh=mesh, error_feedback=ef)
            if ef is not None:
                new_ef[i:i + POD_SLICE] = ef
        elif pod_axis is not None:
            x = mesh.psum(x, pod_axis)
        if mean_over > 1:
            x = x / mean_over
        out[i:i + POD_SLICE].copy_(x)
    return new_ef


# ---------------------------------------------------------------------------
# Hierarchical reduction of one flat bucket
# ---------------------------------------------------------------------------

def hierarchical_allreduce_flat(x, *, mesh, data_axis: str = "data",
                                pod_axis: Optional[str] = None,
                                compress_dcn: bool = False,
                                error_feedback=None, mean_over: int = 1):
    """Full DDL schedule on a flat [N] tensor (N divisible by |data|).
    Returns (reduced_full [N] f32, new_error_feedback)."""
    shard, ef = hierarchical_reduce_scatter_flat(
        x, mesh=mesh, data_axis=data_axis, pod_axis=pod_axis,
        compress_dcn=compress_dcn, error_feedback=error_feedback,
        mean_over=mean_over)
    return mesh.all_gather(shard, data_axis), ef


def hierarchical_reduce_scatter_flat(x, *, mesh, data_axis: str = "data",
                                     pod_axis: Optional[str] = None,
                                     compress_dcn: bool = False,
                                     error_feedback=None, mean_over: int = 1):
    """Phases 1-2 of the DDL schedule: returns this rank's reduced f32 shard
    [N/|data|] (the zero1 entry point) and the new EF."""
    shard = mesh.psum_scatter(x.float(), data_axis)
    if shard.data_ptr() == x.data_ptr():
        shard = shard.clone()       # |data| 1: the pod hop writes in place
    ef = _pod_reduce_(shard, shard, mesh=mesh, pod_axis=pod_axis,
                      compress_dcn=compress_dcn, error_feedback=error_feedback,
                      mean_over=mean_over)
    return shard, ef


def flat_allreduce(x, axes: Tuple[str, ...], *, mesh, mean_over: int = 1):
    """The non-topology-aware baseline: one sum over every DP axis (what a
    flat NCCL ring would do), here axis by axis."""
    for a in axes:
        x = mesh.psum(x, a)
    if mean_over > 1:
        x = x / mean_over
    return x


# ---------------------------------------------------------------------------
# Tree-level API (per leaf)
# ---------------------------------------------------------------------------
#
# The DDL schedule is applied PER LEAF, never across leaves: each leaf is
# reduce-scattered over the first dimension that is divisible by |data| and
# not sharded over `model` (its spec, `models/sharding.py`: a
# tensor-parallel leaf is this rank's block, reduced over the data ranks
# that hold the same block); a leaf with no such dimension takes a plain
# hierarchical psum. The int8 pod hop compresses replicated leaves only; a
# sharded leaf's pod hop is a plain f32 sum, as in the JAX package.

def _choose_scatter_dim(shape, data_size: int, spec=None) -> Optional[int]:
    spec = tuple(spec) if spec is not None else ()
    spec = spec + (None,) * (len(shape) - len(spec))
    for i, (s, ax) in enumerate(zip(shape, spec)):
        if ax is None and s % data_size == 0 and s > 0:
            return i
    return None


def _leaf_is_replicated(spec) -> bool:
    return spec is None or all(a is None for a in tuple(spec))


def ddl_reduce_leaf(g, *, mesh, data_axis: str, pod_axis: Optional[str],
                    data_size: int, pod_size: int, compress_dcn: bool,
                    topology_aware: bool, error_feedback=None, out=None, spec=None):
    """DDL schedule on one gradient leaf. Returns (mean grad, new EF): an
    f32 tensor, or `out` (any float dtype, g's shape) with the mean written
    into it — `out` may be g itself, which saves a leaf-sized buffer.

    Reductions run in f32. The leaf is reduce-scattered along its scatter
    dimension, and the shard flattened in g's own dimension order, so the
    1024-element rows the pod hop quantizes are the JAX package's.
    `spec`: the leaf's spec; a leaf sharded over `model` is never
    scattered along its sharded dim, and its pod hop is not compressed."""
    compress_dcn = compress_dcn and _leaf_is_replicated(spec)
    mean_over = data_size * pod_size
    if not topology_aware:
        axes = (data_axis,) + ((pod_axis,) if pod_axis else ())
        r = flat_allreduce(g.float(), axes, mesh=mesh, mean_over=mean_over)
        return _into(r, out), error_feedback
    sdim = _choose_scatter_dim(g.shape, data_size, spec)
    if sdim is None:
        # fallback: plain hierarchical psum (no RS/AG decomposition)
        r = mesh.psum(g.float(), data_axis)
        if pod_axis is not None:
            r = mesh.psum(r, pod_axis)
        return _into(r / mean_over, out), error_feedback
    ef = None if error_feedback is None else error_feedback.reshape(-1)
    if mesh.size(data_axis) == 1:
        # the shard is the whole leaf: reduce it slice by slice into out
        dst = out if out is not None else torch.empty(g.shape, dtype=torch.float32,
                                                      device=g.device)
        new_ef = _pod_reduce_(g.reshape(-1), dst.view(-1), mesh=mesh, pod_axis=pod_axis,
                              compress_dcn=compress_dcn,
                              error_feedback=ef, mean_over=mean_over)
        return dst, _ef_like(new_ef, error_feedback)
    moved = g.float().movedim(sdim, 0).contiguous()
    shard = mesh.psum_scatter(moved, data_axis).movedim(0, sdim).contiguous()
    # a bf16 leaf's f32 copy (3.1 GB for qwen2.5-14b's head) goes before
    # the gathered leaf comes
    del moved
    new_ef = _pod_reduce_(shard.view(-1), shard.view(-1), mesh=mesh, pod_axis=pod_axis,
                          compress_dcn=compress_dcn,
                          error_feedback=ef, mean_over=mean_over)
    full = mesh.all_gather(shard.movedim(sdim, 0).contiguous(), data_axis).movedim(0, sdim)
    return _into(full, out), _ef_like(new_ef, error_feedback)


def _into(r, out):
    if out is None:
        return r.contiguous()
    return out.copy_(r)


def _ef_like(new_ef, error_feedback):
    if error_feedback is None:
        return None
    return new_ef.view(error_feedback.shape)


def ddl_reduce_tree(grads, cfg: DDLConfig, *, mesh, data_axis: str = "data",
                    pod_axis: Optional[str] = None, data_size: int,
                    pod_size: int = 1, error_feedback=None, param_specs=None):
    """DDL-reduce a gradient tree. Returns (mean grads, new EF list).
    `param_specs`: a list of the leaves' specs in tree order (`models/
    sharding.py`), for the scatter dim and the compression (None: every
    leaf replicated).

    IN PLACE: each leaf's mean is written into the leaf and rounded to its
    dtype (what the JAX package's `astype(g.dtype)` gives), so the grads
    given are consumed."""
    if cfg.mode == "none":
        return grads, error_feedback
    leaves = tree_leaves(grads)
    efs = error_feedback if error_feedback is not None else [None] * len(leaves)
    specs = param_specs if param_specs is not None else [None] * len(leaves)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(specs)} specs for {len(leaves)} leaves")
    out, new_ef = [], []
    for g, ef, sp in zip(leaves, efs, specs):
        r, e = ddl_reduce_leaf(
            g, mesh=mesh, data_axis=data_axis, pod_axis=pod_axis, data_size=data_size,
            pod_size=pod_size, compress_dcn=cfg.compress_dcn,
            topology_aware=cfg.topology_aware, error_feedback=ef, out=g, spec=sp)
        out.append(r)
        new_ef.append(e)
    ef_out = new_ef if error_feedback is not None else None
    return tree_unflatten(grads, out), ef_out


def init_error_feedback(grads_shapes, cfg: DDLConfig, data_size: int):
    """Zero per-leaf f32 EF buffers of each leaf's shard shape (compressed
    replicated leaves only), on each leaf's device."""
    if not (cfg.compress_dcn and cfg.topology_aware):
        return None
    return [torch.zeros(_ef_shape(tuple(l.shape), data_size), dtype=torch.float32,
                        device=l.device) for l in tree_leaves(grads_shapes)]


def _ef_shape(shape, data_size):
    sdim = _choose_scatter_dim(shape, data_size)
    if sdim is None:
        return shape
    s = list(shape)
    s[sdim] //= data_size
    return tuple(s)


def make_buckets(spec_sizes: List[int], bucket_elems: int) -> List[List[int]]:
    """Group leaf indices into ~bucket_elems buckets (used by the pure-DP
    flat paths and the collective-latency benchmarks)."""
    buckets, cur, acc = [], [], 0
    for i, s in enumerate(spec_sizes):
        cur.append(i)
        acc += s
        if acc >= bucket_elems:
            buckets.append(cur)
            cur, acc = [], 0
    if cur:
        buckets.append(cur)
    return buckets
