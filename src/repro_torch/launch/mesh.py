"""The device mesh of a run over `torch.distributed`: data parallel over
`pod` and `data`, tensor parallel over `model`.

The JAX package runs one process over a `("pod", "data", "model")` mesh of
devices and reduces gradients with collectives over named axes inside a
`shard_map` (GSPMD partitions the model over `model`). The port runs one
process per mesh device, in the torchrun idiom (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`), numbered row-major over the mesh's axes, which is the JAX
mesh's device order: on a `("pod", "data", "model")` mesh, rank =
(pod * |data| + data) * |model| + model. `make_mesh` gives each rank a
`Mesh`: its coordinates, the axis sizes, one process group per axis of
size > 1, and the collectives over a named axis: the three the DDL
schedule needs (`psum`, `psum_scatter`, `all_gather`) and those of the
tensor-parallel layers over `model` (`psum`, `all_gather`,
`models/sharding.py`).

Backends. NCCL needs a card of its own for each rank, so ranks that share
one card (and ranks on the CPU) talk over gloo. A group's collectives pick
their path by the group's backend, never by catching an error: on NCCL
they run on the tensors where they lie; on gloo a CUDA tensor is staged
through a host buffer explicitly, so the port relies on no gloo support
for CUDA tensors. The staging buffers are pinned (torch's pinned
allocator, which keeps and reuses its blocks): the copy out waits only
for the calling thread's current stream, and the copy back in is queued
on that stream without blocking the host, so a thread reducing on a
stream of its own (the LMS + DDL reduction queue, `core/ddl/overlap.py`)
leaves the other streams running. The DDL schedule's reductions run in
f32, as its callers cast (`core/ddl/allreduce.py`); the tensor-parallel
layers' sums in the dtypes `models/sharding.py` gives them.
"""
from __future__ import annotations

import datetime
import itertools
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.config.base import MeshSpec


class Mesh:
    """One rank's view of the mesh: `shape` {axis: size}, `coords` {axis:
    this rank's index}, and `groups` {axis: the process group of the ranks
    that differ from this one only along that axis} for each axis of size
    > 1."""

    def __init__(self, spec: MeshSpec, rank: int = 0,
                 groups: Optional[Dict[str, object]] = None):
        self.spec = spec
        self.axis_names: Tuple[str, ...] = tuple(spec.axes)
        self.shape = {a: int(s) for a, s in zip(spec.axes, spec.shape)}
        self.rank = rank
        self.coords = dict(zip(self.axis_names, _unravel(rank, spec.shape)))
        self.groups = groups or {}

    def size(self, axis: str) -> int:
        """|axis|, 1 for an axis the mesh lacks (its collectives are the
        identity, as over a JAX axis of size 1)."""
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    @property
    def dp_index(self) -> int:
        """This rank's block of the global batch: the batch is split over
        ("pod", "data") row-major, as the JAX package's batch sharding."""
        return self.index("pod") * self.size("data") + self.index("data")

    @property
    def dp_size(self) -> int:
        return self.size("pod") * self.size("data")

    # ---- collectives over one named axis --------------------------------
    def _group(self, axis: str):
        """The axis's process group; None for an axis of size 1. A mesh built
        without groups (coordinates only, to cut blocks) raises at its
        first collective over a larger axis: never the identity."""
        if self.size(axis) <= 1:
            return None
        group = self.groups.get(axis)
        if group is None:
            raise RuntimeError(
                f"a collective over {axis!r} (size {self.size(axis)}) needs this rank's "
                "process group: build the mesh with make_mesh after "
                "torch.distributed.init_process_group")
        return group

    def _staged(self, group) -> bool:
        return dist.get_backend(group) == "gloo"

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of x over `axis` (a new tensor; x is not changed)."""
        group = self._group(axis)
        if group is None:
            return x
        if x.is_cuda and self._staged(group):
            y = _stage_out(x)
            dist.all_reduce(y, group=group)
            return _stage_in(y, x.device)
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    def psum_scatter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Tiled reduce-scatter along dim 0: x [n * |axis|, ...] contiguous
        -> this rank's [n, ...] block of the sum over `axis`."""
        group = self._group(axis)
        if group is None:
            return x
        size = self.size(axis)
        if x.shape[0] % size:
            raise ValueError(f"psum_scatter over {axis!r}: dim 0 of {tuple(x.shape)} is "
                             f"not divisible by {size}")
        x = x.contiguous()
        out_shape = (x.shape[0] // size,) + tuple(x.shape[1:])
        if x.is_cuda and self._staged(group):
            src = _stage_out(x)
            out = torch.empty(out_shape, dtype=x.dtype, pin_memory=True)
            dist.reduce_scatter_tensor(out, src, group=group)
            return _stage_in(out, x.device)
        out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x.detach(), group=group)
        return out

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Tiled all-gather along dim 0: x [n, ...] -> [n * |axis|, ...],
        the blocks in axis order."""
        group = self._group(axis)
        if group is None:
            return x
        size = self.size(axis)
        x = x.contiguous()
        out_shape = (x.shape[0] * size,) + tuple(x.shape[1:])
        if x.is_cuda and self._staged(group):
            src = _stage_out(x)
            out = torch.empty(out_shape, dtype=x.dtype, pin_memory=True)
            dist.all_gather_into_tensor(out, src, group=group)
            return _stage_in(out, x.device)
        out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.detach(), group=group)
        return out

    def pmean(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The mean of x over `axes` (summed axis by axis, in order)."""
        n = 1
        for a in axes:
            x = self.psum(x, a)
            n *= self.size(a)
        return x / n if n > 1 else x


def _stage_out(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the CUDA tensor x, contiguous, complete when
    this returns: the host waits for the current stream only (the copy
    and what it queued before), not for the card."""
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x.detach(), non_blocking=True)
    torch.cuda.current_stream(x.device).synchronize()
    return host


def _stage_in(host: torch.Tensor, device) -> torch.Tensor:
    """A device copy of the pinned host tensor, queued on the current
    stream without blocking the host; the pinned allocator does not hand
    the host block out again until the copy is done."""
    out = torch.empty(host.shape, dtype=host.dtype, device=device)
    out.copy_(host, non_blocking=True)
    return out


def local_device() -> torch.device:
    """This rank's card: cuda:(LOCAL_RANK % the host's card count), so
    ranks beyond the host's cards share them. Raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())


def _unravel(rank: int, shape) -> Tuple[int, ...]:
    out = []
    for s in reversed(tuple(shape)):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def make_mesh(spec: MeshSpec) -> Mesh:
    """This rank's `Mesh` of `spec`. A mesh of one device needs no process
    group; a larger one needs `torch.distributed` initialised with a world
    of `spec.num_devices` ranks. Every rank creates every axis group, in
    the same order, as `dist.new_group` requires."""
    n = spec.num_devices
    if n == 1:
        return Mesh(spec)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(
            f"a mesh of {n} devices {tuple(spec.shape)} needs torch.distributed "
            f"initialised with WORLD_SIZE {n}, not {world} (run one process per "
            "device, e.g. under torchrun)")
    rank = dist.get_rank()
    groups = {}
    for ai, axis in enumerate(spec.axes):
        if spec.shape[ai] <= 1:
            continue
        others = [range(s) if j != ai else [None] for j, s in enumerate(spec.shape)]
        for fixed in itertools.product(*others):
            ranks = []
            for k in range(spec.shape[ai]):
                coord = list(fixed)
                coord[ai] = k
                ranks.append(_ravel(coord, spec.shape))
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    return Mesh(spec, rank, groups)


def _ravel(coord, shape) -> int:
    r = 0
    for c, s in zip(coord, shape):
        r = r * s + c
    return r


def mesh_axis_sizes(mesh: Mesh) -> dict:
    return dict(mesh.shape)


def dp_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def parse_mesh(s: str) -> MeshSpec:
    """A launcher's `--mesh` ("AxBxC", "AxB" or "A") -> its MeshSpec, with
    the JAX launchers' axis names."""
    dims = tuple(int(x) for x in s.split("x"))
    if len(dims) == 3:
        return MeshSpec(dims, ("pod", "data", "model"))
    if len(dims) == 2:
        return MeshSpec(dims, ("data", "model"))
    return MeshSpec(dims, ("data",))


def init_process_group(device, world: int) -> None:
    """Join the torchrun world: NCCL when the ranks are on the card and each
    has a card of its own (`local_device`), gloo otherwise."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    on_card = device is None or torch.device(device).type == "cuda"
    if on_card and torch.cuda.is_available() and local_world <= torch.cuda.device_count():
        torch.cuda.set_device(local_device())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, timeout=datetime.timedelta(minutes=10))
