"""Weights and train states (replicated or zero1) from the JAX package
into the port.

The port keeps the JAX param tree's key names and stacked `[L, ...]`
layout, so converting is a tree map over numpy arrays (as `np.asarray`
gives them from JAX arrays). bf16 arrays arrive with numpy's `bfloat16`
extension dtype, which torch cannot read directly; they go by way of f32,
which holds every bf16 value exactly, so the conversion is exact.

On a tensor-parallel mesh (a `model` axis above 1) each rank takes its
block of every leaf the rule table shards over `model`
(`models/sharding.py`): the params and the optimizer trees alike.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import sharding as shd
from repro_torch.models.model import Model


def array_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=torch.bfloat16)
    # a copy: arrays from JAX are read-only, torch tensors are writable
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree, device, mesh=None, cfg=None):
    """Nested dict of numpy arrays (the JAX package's params) -> the same
    dict of tensors on `device`, dtypes kept (bf16 exact via f32). On a
    tensor-parallel `mesh`, this rank's blocks of the leaves of `cfg`'s
    model (a tree like its params: the optimizer's mu, nu and master
    too)."""
    if shd.tp(mesh) is not None:
        if cfg is None:
            raise ValueError("params_from_jax on a tensor-parallel mesh needs the "
                             "model's cfg (its leaves' specs)")
        local = shd.shard_params(params_from_jax(tree, "cpu"), Model(cfg).param_defs(), mesh)
        return _to(local, device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return array_to_torch(tree, device)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def serve_params_from_jax(tree, plan, device):
    """The JAX package's params (numpy arrays) placed for serving under
    `plan` as `train.steps.init_params(plan=)` places the port's own: in
    one pinned arena when the plan puts params on the host (converted a
    leaf at a time on the host, then copied into the arena), else on
    `device`."""
    from repro_torch.train.steps import place_params
    return place_params(params_from_jax(tree, "cpu"), plan, device)


def train_state_from_jax(state, device, mesh=None, cfg=None):
    """A JAX `TrainState` whose leaves are numpy arrays (`jax.tree.map(
    np.asarray, state)`) -> the port's `TrainState` on `device`: the step
    counters as int32 scalars, params and the optimizer's trees through
    `params_from_jax` (an AdamState's mu/nu/master, or an SGDState's
    momentum), so both sides can start from one state; on a
    tensor-parallel `mesh` this rank's blocks (`params_from_jax`)."""
    from repro_torch.optim.adamw import AdamState, SGDState
    from repro_torch.train.steps import TrainState

    def step(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32, device=device)

    def tree(t):
        return params_from_jax(t, device, mesh, cfg)
    opt = state.opt
    if hasattr(opt, "master"):
        opt = AdamState(step(opt.step), tree(opt.mu), tree(opt.nu), tree(opt.master))
    else:
        opt = SGDState(step(opt.step), tree(opt.momentum))
    return TrainState(step(state.step), tree(state.params), opt)


def zero1_state_from_jax(state, device, rank: int, data_size: int):
    """A JAX `Zero1State` whose leaves are numpy arrays -> the port's
    `Zero1State` of the rank at `data` coordinate `rank` on `device`: the
    params through `params_from_jax`, and of the global flat mu, nu and
    master vectors (sharded over `data`, rank-major in both of the JAX
    package's layouts) this rank's block of padded / |data| elements,
    exactly."""
    from repro_torch.train.steps import Zero1State

    def block(flat):
        flat = np.asarray(flat)
        n = flat.shape[0] // data_size
        return array_to_torch(flat[rank * n:(rank + 1) * n], device)
    return Zero1State(torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                                   device=device),
                      params_from_jax(state.params, device),
                      block(state.mu), block(state.nu), block(state.master))
