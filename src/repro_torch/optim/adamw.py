"""AdamW and momentum SGD over trees of tensors: f32 moments and an f32
master copy over bf16 params, as in the JAX package, each expression in
its order and precision.

Unlike the JAX package's pure functions, the updates here work IN PLACE,
one slice of a leaf at a time (`SLICE` elements): the state's moments and
master copy, the params and, in `clip_by_global_norm`, the grads are
overwritten, so no whole-leaf f32 temporary is made (the [152064, 5120]
embedding of qwen2.5-14b would need several of 3.1 GB each). Elementwise
math does not depend on the slicing, so the result is the whole-leaf one.
Call them under `torch.no_grad()`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models import sharding as shd
from repro_torch.tree import tree_leaves, tree_map

# elements per slice of a leaf: the f32 temporaries stay at a few x 64 MiB
SLICE = 1 << 24


class AdamState(NamedTuple):
    step: torch.Tensor    # int32 scalar, on the params' device
    mu: dict
    nu: dict
    master: dict          # f32 master params


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: dict


def _device(tree):
    return tree_leaves(tree)[0].device


def _slices(*leaves):
    """Matching 1-d slices of contiguous leaves of one shape: views, so a
    write to a slice lands in its leaf."""
    flat = [t.view(-1) for t in leaves]
    for i in range(0, flat[0].numel(), SLICE):
        yield tuple(t[i:i + SLICE] for t in flat)


def adamw_init(params) -> AdamState:
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    # the master copy is a distinct buffer even for f32 params
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
        mu=tree_map(f32, params),
        nu=tree_map(f32, params),
        master=tree_map(lambda p: p.detach().float().clone(), params))


def clip_leaf(g, scale):
    """One leaf (or slice) of `clip_by_global_norm`: rounds back to g's
    dtype."""
    return (g.float() * scale).to(g.dtype)


def adamw_slice_update(g, m, v, mp, *, lr, beta1, beta2, b1c, b2c, eps=1e-8,
                       weight_decay=0.1):
    """The AdamW update on ONE array (a leaf or a slice of one), IN PLACE:
    m, v and mp become m2, v2 and the new master and are returned. b1c/b2c
    are the step's bias corrections and lr the step's rate, f32 scalar
    tensors on the array's device (a true division by b1c, as in JAX)."""
    gf = g.float()
    m.mul_(beta1).add_(gf * (1 - beta1))
    v.mul_(beta2).add_(gf * (1 - beta2) * gf)
    upd = (m / b1c).div_((v / b2c).sqrt_().add_(eps))      # mhat / (sqrt(vhat) + eps)
    upd.add_(mp * weight_decay)
    mp.sub_(upd.mul_(lr))
    return m, v, mp


def adamw_update(grads, state: AdamState, params, *, lr, beta1=0.9, beta2=0.95,
                 eps=1e-8, weight_decay=0.1):
    """-> (params, AdamState(step + 1, mu, nu, master)): the same trees,
    updated in place slice by slice; each param is its new master copy
    cast to the param's dtype."""
    step = state.step + 1
    sf = step.float()
    b1c = 1.0 - beta1 ** sf
    b2c = 1.0 - beta2 ** sf
    for leaves in zip(*(tree_leaves(t) for t in (grads, state.mu, state.nu,
                                                 state.master, params))):
        for g, m, v, mp, p in _slices(*leaves):
            adamw_slice_update(g, m, v, mp, lr=lr, beta1=beta1, beta2=beta2,
                               b1c=b1c, b2c=b2c, eps=eps,
                               weight_decay=weight_decay)
            p.copy_(mp)
    return params, AdamState(step, state.mu, state.nu, state.master)


def sgdm_init(params) -> SGDState:
    return SGDState(
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
        momentum=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params))


def sgdm_slice_update(g, m, p, *, lr, beta1, weight_decay=0.0):
    """Momentum SGD on ONE array, IN PLACE: m becomes the new momentum and
    p the new params; -> (m, p)."""
    gf = g.float() + p.float() * weight_decay
    m.mul_(beta1).add_(gf)
    p.copy_(p.float() - m * lr)
    return m, p


def sgdm_update(grads, state: SGDState, params, *, lr, beta1=0.9,
                weight_decay=0.0, **_):
    step = state.step + 1
    for leaves in zip(*(tree_leaves(t) for t in (grads, state.momentum, params))):
        for g, m, p in _slices(*leaves):
            sgdm_slice_update(g, m, p, lr=lr, beta1=beta1,
                              weight_decay=weight_decay)
    return params, SGDState(step, state.momentum)


def leaf_squares(leaf) -> list:
    """The f32 sum of squares of each `SLICE`-element slice of a leaf (flat,
    in order): the partial sums `global_norm` adds."""
    return [torch.sum(s.float() ** 2) for (s,) in _slices(leaf)]


def norm_of(squares, mesh=None, sharded=None) -> torch.Tensor:
    """sqrt of the partial sums, [per leaf, in tree order: [per slice]],
    added leaf by leaf, each leaf's slices in order (`global_norm`'s
    order, so a norm from partial sums made elsewhere is the same
    number). On a tensor-parallel `mesh`, `sharded` (a bool per leaf)
    marks the leaves that hold only this rank's block: their sums are
    added apart and summed over `model` in one collective, the
    replicated leaves' counted once, so the norm is the global tree's,
    the same on every rank."""
    if shd.tp(mesh) is None or sharded is None:
        total = 0
        for parts in squares:
            total = total + sum(parts)
        return torch.sqrt(total)
    rep, part = 0, 0
    for parts, sh in zip(squares, sharded):
        if sh:
            part = part + sum(parts)
        else:
            rep = rep + sum(parts)
    if not torch.is_tensor(part):
        part = torch.zeros((), dtype=torch.float32, device=rep.device)
    return torch.sqrt(rep + mesh.psum(part, shd.MODEL))


def global_norm(tree, mesh=None, sharded=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares (of
    the global tree on a tensor-parallel `mesh`: `norm_of`)."""
    return norm_of([leaf_squares(leaf) for leaf in tree_leaves(tree)], mesh, sharded)


class StackSquares:
    """`leaf_squares` of stacked leaves ([L, ...], one layer a row) made
    from their layers as they come, in any order, as the reduction queue
    of the LMS + DDL backward hands them out (`core/ddl/overlap.py`): a
    slice that lies inside one layer is summed as soon as the layer comes;
    a slice that spans layers keeps a copy of each part until its last
    part comes, then sums the parts joined in order. The sums are those of
    `leaf_squares` over the whole stacked leaf, bit for bit: the same
    elements, in one tensor of the same length, summed by the same call."""

    def __init__(self, shapes):
        self.layers = shapes[0][0] if shapes else 0
        self.sizes = [math.prod(s[1:]) for s in shapes]
        self.sums = [[None] * (-(-self.layers * n // SLICE)) for n in self.sizes]
        self.parts = [{} for _ in shapes]     # slice -> {flat start: piece}

    def add(self, i: int, leaves) -> None:
        """Layer i's leaves (each the shape of a stacked leaf's row)."""
        for j, g in enumerate(leaves):
            n = self.sizes[j]
            flat = g.reshape(-1)
            start, end = i * n, (i + 1) * n
            for k in range(start // SLICE, (end - 1) // SLICE + 1):
                lo, hi = max(k * SLICE, start), min((k + 1) * SLICE, end)
                length = min((k + 1) * SLICE, self.layers * n) - k * SLICE
                piece = flat[lo - start:hi - start]
                if hi - lo == length:
                    self.sums[j][k] = torch.sum(piece.float() ** 2)
                    continue
                got = self.parts[j].setdefault(k, {})
                got[lo] = piece.clone()
                if sum(p.numel() for p in got.values()) == length:
                    whole = torch.cat([got[o] for o in sorted(got)])
                    del self.parts[j][k]
                    self.sums[j][k] = torch.sum(whole.float() ** 2)

    def squares(self) -> list:
        """[per leaf: [per slice]]; raises unless every layer came."""
        if any(s is None for sums in self.sums for s in sums):
            raise RuntimeError("StackSquares: not every layer's grads came")
        return self.sums


def clip_scale(gnorm, max_norm):
    """The clip factor min(1, max_norm / max(gnorm, 1e-9)), an f32 scalar."""
    top = torch.full_like(gnorm, max_norm)
    return torch.clamp(top / torch.clamp(gnorm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float, mesh=None, sharded=None):
    """-> (grads, global norm): the grads scaled IN PLACE, slice by slice
    (`mesh`, `sharded`: `norm_of`'s)."""
    gn = global_norm(grads, mesh, sharded)
    scale = clip_scale(gn, max_norm)
    for leaf in tree_leaves(grads):
        for (s,) in _slices(leaf):
            s.copy_(clip_leaf(s, scale))
    return grads, gn


OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update),
    "sgdm": (sgdm_init, sgdm_update),
}
