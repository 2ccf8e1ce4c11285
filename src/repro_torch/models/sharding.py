"""Logical-axis sharding: the JAX package's `models/sharding.py` rule table
(logical axis -> mesh axes) and its spec functions, and what the port does
in their place where GSPMD places tensors in the JAX package.

A spec is a plain tuple, one entry a dim (None, a mesh axis name, or a
tuple of names), trailing Nones trimmed: the entries of the JAX package's
`PartitionSpec`. The planner reads the table to size what a mesh axis
shards (`planner._logical_factor`, `shard_factor`).

Tensor parallelism. The JAX package runs the model on global arrays and
GSPMD partitions it over `model`. The port runs eagerly, one process a
mesh device, so it does by hand what GSPMD inserts:

* each rank holds only its block of every leaf that a spec maps to
  `model` (`local_shard`, `shard_params`, `local_defs`): the MoE's
  experts too (expert parallelism: `[E, d, ff]` and `[E, ff, d]` keep
  `experts` on `model`, and `spec` drops their `ff` entry), and a serve
  cache's `kv_heads` (`local_defs` of `transformer.cache_defs`); a dim
  the rule maps to `model` that |model| does not divide raises (the JAX
  package replicates such a leaf, `prune_spec`: not ported yet);
* a column-parallel region (the q/k/v projections, the MLP's gate and
  up, the head) takes its replicated input through `copy_to_model`
  (forward the identity, backward the sum of the input's grads over
  `model`), and a row-parallel output (the attention's out projection,
  the MLP's down projection, the embedding lookup) leaves through
  `reduce_from_model` (forward the sum over `model`, backward the
  identity). The forward's row-parallel sum runs in f32 over the bf16
  partial products and is rounded once to bf16 (`sum_partials`); the
  backward's sum of the input grads runs in bf16 (`sum_input_grads`).
  The serve paths hand the logits out whole on every rank, as the JAX
  package's serve steps do (`out_shardings=P()`): `gather_from_model`
  all-gathers each rank's vocab columns, so every rank reads the same
  bits. At |model| 2 either dtype gives the same bits; at 4 the CPU tests
  measured each choice against the JAX package (olmo-1b smoke,
  `tests/test_torch_tp_model.py`), relative Frobenius of the grads and
  the loss: forward f32 and backward bf16 1.46e-2 and 4.2e-5; both bf16
  1.61e-2 and 4.9e-4; both f32 1.55e-2 and 4.2e-5. The embedding lookup's
  sum (one nonzero row a token) is exact either way.

Every collective here is a `Mesh.psum` over "model": NCCL with a card a
rank, gloo (staged through pinned buffers) where ranks share one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "experts": ("model",),
    "d_inner": ("model",),
    "ssm_heads": ("model",),
    "lru": ("model",),
    # deliberately unsharded logical axes
    "layers": (), "seq": (), "d_model": (), "head_dim": (), "state": (),
    "conv": (), "pos3": (), "window": (), "chunk": (),
    # decode KV-cache sequence dim: unsharded by default
    "kv_seq": (),
    # the residual stream's sequence dim (sequence parallelism off)
    "seq_resid": (),
}

MODEL = "model"


def axis_sizes(mesh) -> dict:
    """{axis: size} of a port `Mesh`, a `MeshSpec`, or anything with
    `axis_names` and a `shape` mapping (as a JAX mesh)."""
    if mesh is None:
        return {}
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    axes = getattr(mesh, "axes", None) or getattr(mesh, "axis_names")
    return dict(zip(axes, shape))


def rules_without(axes=("pod", "data"), rules: Optional[dict] = None) -> dict:
    """The rule table with the given mesh axes removed."""
    rules = rules or DEFAULT_RULES
    drop = set(axes)
    return {k: tuple(a for a in v if a not in drop) for k, v in rules.items()}


def spec(*logical_axes: Optional[str], mesh=None, rules: Optional[dict] = None) -> tuple:
    """The spec of logical axis names (None: a replicated dim) on `mesh`:
    axes the mesh lacks are dropped, and a mesh axis appears at most once
    (its first logical axis takes it)."""
    rules = rules or DEFAULT_RULES
    mesh_axes = set(axis_sizes(mesh))
    parts, used = [], set()
    for ax in logical_axes:
        if ax is None:
            parts.append(None)
            continue
        mapped = tuple(a for a in rules.get(ax, ()) if a in mesh_axes and a not in used)
        used.update(mapped)
        parts.append(mapped if len(mapped) > 1 else (mapped[0] if mapped else None))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def prune_spec(shape: Sequence[int], s: tuple, mesh) -> tuple:
    """Drop the entries of `s` whose dim the mapped mesh extent does not
    divide; a mesh axis appears once a spec (the first divisible dim
    wins)."""
    if mesh is None:
        return tuple(s)
    sizes = axis_sizes(mesh)
    parts = list(s) + [None] * (len(shape) - len(s))
    out, used = [], set()
    for dim, ax in zip(shape, parts):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        f = math.prod(sizes[a] for a in axes)
        ok = f > 0 and dim % f == 0 and not any(a in used for a in axes)
        if ok:
            used.update(axes)
        out.append(ax if ok else None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def shard_factor(mesh, logical_axis: str, rules: Optional[dict] = None) -> int:
    """How many ways `logical_axis` is split on `mesh` (for the planner)."""
    if mesh is None:
        return 1
    rules = rules or DEFAULT_RULES
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in rules.get(logical_axis, ()) if a in sizes)


# ---------------------------------------------------------------------------
# Leaves on a tensor-parallel mesh
# ---------------------------------------------------------------------------

def model_size(mesh) -> int:
    return axis_sizes(mesh).get(MODEL, 1)


def tp(mesh):
    """`mesh` when it has a `model` axis above 1 (tensor parallelism), else
    None: the model's layers take the one-device path then."""
    return mesh if mesh is not None and model_size(mesh) > 1 else None


def model_dim(s: tuple) -> Optional[int]:
    """The dim a spec shards over `model`, or None (replicated over it)."""
    for i, ax in enumerate(s):
        if ax == MODEL or (isinstance(ax, tuple) and MODEL in ax):
            return i
    return None


def leaf_spec(name: str, shape, axes, mesh) -> tuple:
    """The spec of one param leaf (`spec` of its logical axes, pruned as
    the JAX package prunes it). A dim the rules map to `model` that
    |model| does not divide raises: the JAX package replicates such a
    leaf, which the port does not do yet."""
    s = spec(*axes, mesh=mesh)
    pruned = prune_spec(shape, s, mesh)
    if model_dim(s) is not None and model_dim(pruned) is None:
        d = model_dim(s)
        raise NotImplementedError(
            f"not ported yet: param {name!r} dim {d} ({axes[d]}, size {shape[d]}) does not "
            f"divide |model| = {model_size(mesh)} (the JAX package replicates it)")
    return pruned


def _map_defs(fn, defs, prefix=""):
    if isinstance(defs, dict):
        return {k: _map_defs(fn, v, f"{prefix}{k}/") for k, v in defs.items()}
    return fn(prefix[:-1], defs)


def spec_tree(defs, mesh):
    """A tree like `defs` (ParamDefs) of each leaf's spec on `mesh`."""
    return _map_defs(lambda name, d: leaf_spec(name, d.shape, d.axes, mesh), defs)


def sharded_tree(defs, mesh):
    """A tree like `defs` of bools: True where the leaf is sharded over
    `model` on `mesh` (False everywhere without tensor parallelism)."""
    if tp(mesh) is None:
        return _map_defs(lambda name, d: False, defs)
    return _map_defs(lambda name, d: model_dim(leaf_spec(name, d.shape, d.axes, mesh))
                     is not None, defs)


def local_shape(shape, s: tuple, mesh) -> tuple:
    """This rank's block shape of a leaf of `shape` with spec `s`."""
    d = model_dim(s)
    out = list(shape)
    if d is not None:
        out[d] //= model_size(mesh)
    return tuple(out)


def local_defs(defs, mesh):
    """`defs` with each ParamDef's shape this rank's block's."""
    if tp(mesh) is None:
        return defs
    return _map_defs(lambda name, d: dataclasses.replace(
        d, shape=local_shape(d.shape, leaf_spec(name, d.shape, d.axes, mesh), mesh)), defs)


def local_shard(leaf: torch.Tensor, s: tuple, mesh) -> torch.Tensor:
    """This rank's block of a global leaf (a view) with spec `s` on the
    port's `Mesh` (its coordinates: no collective)."""
    d = model_dim(s)
    if d is None or tp(mesh) is None:
        return leaf
    n = leaf.shape[d] // model_size(mesh)
    return leaf.narrow(d, mesh.index(MODEL) * n, n)


def global_leaf(shard: torch.Tensor, s: tuple, mesh) -> torch.Tensor:
    """The inverse of `local_shard`: the global leaf from the `model`
    ranks' blocks (an all-gather over `model`; every rank gets it)."""
    d = model_dim(s)
    if d is None or tp(mesh) is None:
        return shard
    got = mesh.all_gather(shard.movedim(d, 0).contiguous(), MODEL)
    return got.movedim(0, d).contiguous()


def shard_params(tree, defs, mesh):
    """A global params tree -> this rank's blocks (contiguous copies)."""
    if tp(mesh) is None:
        return tree
    specs = spec_tree(defs, mesh)

    def go(t, s):
        if isinstance(t, dict):
            return {k: go(v, s[k]) for k, v in t.items()}
        return local_shard(t, s, mesh).contiguous()
    return go(tree, specs)


def vocab_range(vocab: int, mesh) -> tuple:
    """(first id, count) of the vocab rows this rank holds."""
    m = tp(mesh)
    if m is None:
        return 0, vocab
    n = vocab // model_size(m)
    return m.index(MODEL) * n, n


# ---------------------------------------------------------------------------
# The collectives at a tensor-parallel region's edges
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """Into a column-parallel region: forward the identity, backward the
    sum of the grads over `model` (each rank's part of the input's grad
    comes from its own columns: `sum_input_grads`)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_input_grads(g, ctx.mesh), None


def sum_partials(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over `model` of a row-parallel region's partial products:
    in f32, rounded once to their dtype (the module docstring)."""
    return mesh.psum(x.float(), MODEL).to(x.dtype)


def sum_input_grads(g: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over `model` of the grads a column-parallel region's ranks
    give its input: in their own dtype (the module docstring)."""
    return mesh.psum(g, MODEL)


class _ReduceFromModel(torch.autograd.Function):
    """Out of a row-parallel region: forward the sum of the partial
    outputs over `model` (`sum_partials`), backward the identity (the
    output is replicated, so its grad is too)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return sum_partials(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """`x` entering a column-parallel region (the identity without tensor
    parallelism)."""
    return x if tp(mesh) is None else _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over `model` of a row-parallel region's partial output (the
    identity without tensor parallelism)."""
    return x if tp(mesh) is None else _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's vocab columns [..., V / |model|] -> the whole [..., V],
    the ranks' blocks in `model` order, bitwise the same on every rank (an
    all-gather; forward only: the serve paths take no grads through it).
    The identity without tensor parallelism."""
    if tp(mesh) is None:
        return x
    got = mesh.all_gather(x.movedim(-1, 0).contiguous(), MODEL)
    return got.movedim(0, -1)
