"""Sharded, asynchronous, atomic checkpointing of the port's train states:
the JAX package's `checkpoint/checkpointer.py` in its on-disk layout, for
state that changes in place and may lie in a pinned host arena.

Layout (the JAX package's, so a one-process checkpoint of either package
restores in the other): ``<dir>/step_<N:08d>/shard_<p>.npz`` and
``manifest.json``, written LAST as the commit. Keys are the state tree's
paths joined by ``/`` with the ``__emptydict__``, ``__len__`` and
``__type__`` markers; a bf16 leaf is stored as its ``uint16`` bits under
``BF16::<key>``; the manifest holds ``step``, ``time``, ``num_processes``,
the shard's ``keys`` and the caller's ``extra``. `all_steps` treats a torn
or unparseable manifest exactly like a missing one, and a latest-mode
restore falls back past a step whose shard cannot be opened; an explicitly
requested step raises.

The snapshot. The port's optimizer updates the state in place, and under
an LMS plan the host-resident leaves are carved from one pinned arena of
tens of GB, which the host cannot hold twice. So `save` copies only the
leaves that lie on the card to the host (as the JAX package copies
everything); a leaf already in host memory is written by the writer thread
straight from where it lies, never copied whole. The caller must not write
those leaves before the writer is done: the train step calls
`Trainer`'s wait, which calls `wait()`, just before its first in-place
write (the optimizer update), so the next step's forward and backward,
which only read the state, overlap the write, and a checkpoint of step N
holds exactly the state after step N.

Several ranks. One `Checkpointer` a rank, over one directory, with a
process group over every rank of the run (`group`, gloo: its barriers run
on the writer thread, beside the step's collectives on other groups).
Each rank writes the leaves it was handed (the trainer hands replicated
leaves to data rank 0 only, and each rank its own zero1 blocks) as
``shard_<process>.npz`` into the step's temporary directory; after a
barrier (every shard on disk) rank 0 moves the directory into place; each
rank then passes its ``ckpt.commit`` window; after a second barrier rank 0
writes the manifest, and a third lets no rank's writer end before the
commit is on disk (so every rank's `wait()`, and a restart after it, sees
the same newest step). A rank that dies before the second barrier leaves
no committed step. On one process the barriers are nothing, and the order
is the JAX package's.

Tensor parallelism. Checkpoints keep the global layout, as the JAX
package's do, written in blocks: on a mesh with a `model` axis above 1
the data-0 rank of each `model` index m writes ``shard_<m>.npz`` with its
block of every leaf sharded over `model` under the leaf's own key, and
`model` 0 also writes the replicated leaves and the step counters
(`Trainer.save`). A leaf's blocks, joined along its sharded dim in `model`
order, are the global leaf. A restore on as many `model` ranks reads each
rank's own block (its shard wins); elsewhere `read_local` joins the blocks
or cuts the global leaf to the block the reading rank holds.

Restore reads an ``.npz`` one member at a time (`CheckpointReader`): each
leaf is read into the tensor it goes to, in chunks, so neither the whole
state nor a whole leaf stands in pageable memory
(`train/steps.restore_train_state`, `restore_zero1_state`).

An async writer that dies re-raises its exception at the next `wait()` or
`save()`. Fault injection (`runtime/inject.py`): ``ckpt.save`` at the entry
of `save`, ``ckpt.commit`` between the shard write and the manifest. The
writer records the ``ckpt.save`` span and the ``ckpt.commit`` instant (on
`get_obs()`'s ring), and the metrics ``ckpt.bytes``, ``ckpt.save_block_s``
(the save call) and ``ckpt.write_s`` (the writer) on `obs`'s registry.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models import sharding as shd
from repro_torch.obs import get_obs
from repro_torch.runtime import inject

BF16 = "BF16::"
CHUNK = 64 << 20        # bytes a read or write moves at once


def _flatten(tree, prefix=""):
    """The JAX package's `_flatten`: {key: leaf} with the structure
    markers (a leaf is anything with a shape, or a scalar)."""
    out = {}
    if isinstance(tree, dict):
        if not tree:  # keep empty subtrees (e.g. non-parametric norms)
            out[f"{prefix}__emptydict__"] = np.asarray(0)
            return out
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        out[f"{prefix}__len__"] = np.asarray(len(tree))
        out[f"{prefix}__type__"] = np.asarray(
            1 if isinstance(tree, tuple) else 0)
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    """The JAX package's `_unflatten`: nested dict/list/tuple back from
    {key: leaf}."""
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _rebuild(root)


def _rebuild(node):
    if not isinstance(node, dict):
        return node
    if "__emptydict__" in node:
        return {}
    if "__len__" in node:
        n = int(node["__len__"])
        items = [_rebuild(node[str(i)]) for i in range(n)]
        return tuple(items) if int(node.get("__type__", 0)) == 1 else items
    return {k: _rebuild(v) for k, v in node.items()}


def _host_leaf(x):
    """What `save` keeps of a leaf: a card tensor copied to the host (the
    caller may change it once `save` returns), a host tensor or array as
    it is (the writer reads it where it lies)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.cpu() if x.device.type != "cpu" else x
    return np.asarray(x)


def _encode(key: str, x):
    """-> (member key, numpy array sharing the leaf's memory): bf16 as its
    uint16 bits under BF16:: (through an int16 view: no f32 round trip)."""
    if not isinstance(x, torch.Tensor):
        return key, x
    if x.dtype == torch.bfloat16:
        return BF16 + key, x.contiguous().view(torch.int16).numpy().view(np.uint16)
    return key, x.contiguous().numpy()


def _leaf_nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def write_npz(path: str, arrays: Dict[str, np.ndarray]) -> int:
    """The file `np.savez(path, **arrays)` writes (a stored zip of one
    ``.npy`` member a key), written from each array's memory in CHUNK
    pieces instead of through copies. -> bytes of array data written."""
    total = 0
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, arr in arrays.items():
            arr = np.asarray(arr, order="C")     # ascontiguousarray makes 0-d 1-d
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                header = np.lib.format.header_data_from_array_1_0(arr)
                try:
                    np.lib.format.write_array_header_1_0(f, header)
                except ValueError:
                    np.lib.format.write_array_header_2_0(f, header)
                data = memoryview(arr.reshape(-1).view(np.uint8)) if arr.size else b""
                for lo in range(0, len(data), CHUNK):
                    f.write(data[lo:lo + CHUNK])
            total += arr.nbytes
    return total


def _torch_dtype(dtype: np.dtype, bf16: bool):
    if bf16:
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


class CheckpointReader:
    """One committed step opened for reading member by member: the
    manifest, ``shard_0.npz`` (every replicated leaf) and this process's
    shard when it is another. Opening reads each zip's directory only, so
    a truncated shard fails here (the latest-mode fallback)."""

    def __init__(self, directory: str, step: int, process: int = 0):
        self.step = step
        self.root = directory
        self.dir = os.path.join(directory, f"step_{step:08d}")
        with open(os.path.join(self.dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        self.extra = self.manifest.get("extra", {})
        self.num_processes = int(self.manifest.get("num_processes", 1))
        self._zips = []
        try:
            for p in dict.fromkeys((process, 0)):
                if p == process and p != 0 and not os.path.exists(self._shard(p)):
                    continue        # this process wrote no shard
                self._zips.append(zipfile.ZipFile(self._shard(p)))
        except BaseException:
            self.close()
            raise
        # key -> (zip, member name, stored as bf16 bits)
        self._members = {}
        for zf in reversed(self._zips):      # this process's shard wins
            for name in zf.namelist():
                key = name[:-4] if name.endswith(".npy") else name
                bf16 = key.startswith(BF16)
                self._members[key[len(BF16):] if bf16 else key] = (zf, name, bf16)

    def _shard(self, p: int) -> str:
        return os.path.join(self.dir, f"shard_{p}.npz")

    def keys(self):
        return sorted(self._members)

    def __contains__(self, key: str) -> bool:
        return key in self._members

    def _open(self, key: str):
        """-> (open member positioned at the data, shape, numpy dtype,
        bf16)."""
        if key not in self._members:
            raise KeyError(f"checkpoint step {self.step} has no leaf {key!r}")
        zf, name, bf16 = self._members[key]
        f = zf.open(name)
        version = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        if fortran and len(shape) > 1:
            f.close()
            raise ValueError(f"leaf {key!r} is stored in Fortran order")
        return f, tuple(shape), dtype, bf16

    def info(self, key: str):
        """-> (shape, torch dtype) of a stored leaf."""
        f, shape, dtype, bf16 = self._open(key)
        f.close()
        return shape, _torch_dtype(dtype, bf16)

    def read_into(self, key: str, dst: torch.Tensor, start: int = 0) -> None:
        """Copy elements [start, start + dst.numel()) of the stored leaf
        (flattened) into `dst`, a contiguous tensor of its dtype: straight
        into its memory when it lies on the host, else through a CHUNK
        host buffer to the card. With start 0 and the whole leaf, its
        shape must be dst's."""
        f, shape, dtype, bf16 = self._open(key)
        with f:
            want = _torch_dtype(dtype, bf16)
            if want != dst.dtype:
                raise ValueError(f"leaf {key!r} is {want} in the checkpoint, {dst.dtype} here")
            n = int(np.prod(shape, dtype=np.int64))
            if start == 0 and dst.numel() == n:
                if tuple(dst.shape) != shape:
                    raise ValueError(f"leaf {key!r} has shape {shape} in the checkpoint, "
                                     f"{tuple(dst.shape)} here")
            elif start + dst.numel() > n:
                raise ValueError(f"leaf {key!r} holds {n} elements; elements "
                                 f"[{start}, {start + dst.numel()}) were asked for")
            if not dst.is_contiguous():
                raise ValueError(f"the destination of {key!r} is not contiguous")
            item = dst.element_size()
            if start:
                f.seek(f.tell() + start * item)
            flat = dst.view(-1)
            if dst.device.type == "cpu":
                out = memoryview(flat.view(torch.uint8).numpy()) if flat.numel() else None
                _fill(f, out, key)
                return
            per = max(CHUNK // item, 1)
            stage = torch.empty(min(per, flat.numel()) * item, dtype=torch.uint8,
                                pin_memory=True)
            for lo in range(0, flat.numel(), per):
                part = flat[lo:lo + per].view(torch.uint8)
                buf = stage[:part.numel()]
                _fill(f, memoryview(buf.numpy()), key)
                part.copy_(buf)          # synchronous: the buffer is reused

    def read(self, key: str) -> torch.Tensor:
        """A stored leaf as a new host tensor."""
        shape, dtype = self.info(key)
        out = torch.empty(shape, dtype=dtype)
        self.read_into(key, out)
        return out

    def close(self) -> None:
        for zf in self._zips:
            zf.close()
        self._zips = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_local(reader: CheckpointReader, key: str, dst: torch.Tensor, global_shape,
               spec, mesh) -> None:
    """Read into `dst` this rank's block (with `spec` on the tensor-parallel
    `mesh`, or the whole leaf without one) of the leaf of `global_shape`
    stored under `key`: straight from the stored leaf when it has dst's
    shape (a replicated leaf, or this rank's own block of a checkpoint
    written on as many `model` ranks); else the global leaf, joined from
    the blocks the checkpoint holds in its `model` ranks' shards where it
    was written in blocks, and cut to this rank's block."""
    shape, dtype = reader.info(key)
    if tuple(shape) == tuple(dst.shape):
        reader.read_into(key, dst)
        return
    whole = torch.empty(tuple(global_shape), dtype=dtype)
    if tuple(shape) == tuple(global_shape):
        reader.read_into(key, whole)
    else:
        diff = [i for i, (a, b) in enumerate(zip(shape, global_shape)) if a != b]
        if len(diff) != 1 or global_shape[diff[0]] % shape[diff[0]]:
            raise ValueError(f"leaf {key!r} is stored {tuple(shape)}: not a block of "
                             f"{tuple(global_shape)}")
        d, n = diff[0], shape[diff[0]]
        for m in range(global_shape[d] // n):
            with CheckpointReader(reader.root, reader.step, process=m) as r:
                block = torch.empty(tuple(shape), dtype=dtype)
                r.read_into(key, block)
                whole.narrow(d, m * n, n).copy_(block)
    dst.copy_(shd.local_shard(whole, spec, mesh))


def _fill(f, out: Optional[memoryview], key: str) -> None:
    """Read len(out) bytes of the open member into `out`."""
    if out is None:
        return
    pos = 0
    while pos < len(out):
        got = f.read(min(CHUNK, len(out) - pos))
        if not got:
            raise ValueError(f"leaf {key!r} ends early in the checkpoint")
        out[pos:pos + len(got)] = got
        pos += len(got)


_ERRORS = (OSError, ValueError, KeyError, zipfile.BadZipFile, json.JSONDecodeError)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True, injector=None, group=None, obs=None):
        # keep=N retains the last N committed checkpoints; keep<=0 keeps all
        if not isinstance(keep, int) or isinstance(keep, bool):
            raise TypeError(f"keep must be an int, got {type(keep).__name__}")
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._inj = injector
        # every rank of the run (None: one process); rank 0 commits
        self.group = group
        self.rank = 0
        if group is not None:
            import torch.distributed as dist
            self.rank = dist.get_rank(group)
        # where the span, the commit instant and the ckpt.* metrics go (its
        # registry: the trainer's; the span ring is shared)
        self.obs = obs if obs is not None else get_obs()
        # the last save's numbers: step, bytes, block_s (the save call),
        # write_s (the writer, shard to commit)
        self.last: Dict[str, float] = {}
        os.makedirs(directory, exist_ok=True)

    # ---- save ---------------------------------------------------------------
    def save(self, step: int, state: Optional[Dict[str, Any]], *, process: int = 0,
             num_processes: int = 1, extra: Optional[dict] = None):
        """state: a tree of tensors (or arrays) this rank writes as
        ``shard_<process>``, or None when it writes none (it still takes
        part in the commit). Leaves on the card are copied to the host
        here; host leaves are written where they lie: the caller keeps
        them unchanged until `wait()` returns."""
        t0 = time.monotonic()
        self.wait()
        inject.maybe(self._inj, "ckpt.save")
        flat = {} if state is None else {k: _host_leaf(v) for k, v in _flatten(state).items()}
        nbytes = sum(_leaf_nbytes(v) for v in flat.values())

        def _write():
            obs = self.obs
            w0 = time.monotonic()
            with obs.span("ckpt.save", step=step, bytes=nbytes,
                          async_save=self.async_save):
                step_dir = os.path.join(self.dir, f"step_{step:08d}")
                tmp = step_dir + ".tmp"
                if flat:
                    os.makedirs(tmp, exist_ok=True)
                    write_npz(os.path.join(tmp, f"shard_{process}.npz"),
                              dict(_encode(k, v) for k, v in flat.items()))
                self._barrier()                 # every shard on disk
                if self.rank == 0:
                    os.makedirs(tmp, exist_ok=True)
                    if os.path.isdir(step_dir):
                        shutil.rmtree(step_dir)
                    os.rename(tmp, step_dir)
                # the torn-checkpoint window: shards on disk, no manifest
                inject.maybe(self._inj, "ckpt.commit")
                self._barrier()                 # every rank past its window
                if self.rank == 0:
                    manifest = {"step": step,
                                "time": time.time(),  # wall clock: when it was taken
                                "num_processes": num_processes,
                                "keys": sorted(flat),
                                "extra": extra or {}}
                    mtmp = os.path.join(self.dir, f".manifest_{step}.tmp")
                    with open(mtmp, "w") as f:
                        json.dump(manifest, f)
                    os.rename(mtmp, os.path.join(step_dir, "manifest.json"))  # commit
                    obs.instant("ckpt.commit", step=step)
                    self._gc()
                self._barrier()                 # every rank sees the commit
            write_s = time.monotonic() - w0
            self.last.update(write_s=write_s)
            obs.registry.histogram("ckpt.write_s").observe(write_s)

        self.last = {"step": step, "bytes": nbytes}
        if self.async_save:
            def _guarded():
                try:
                    _write()
                except BaseException as e:  # surfaces at the next wait()
                    self._error = e

            self._thread = threading.Thread(target=_guarded, daemon=True)
            self._thread.start()
        else:
            _write()
        block_s = time.monotonic() - t0
        self.last["block_s"] = block_s
        self.obs.registry.histogram("ckpt.save_block_s").observe(block_s)
        self.obs.registry.counter("ckpt.bytes").inc(nbytes)

    def _barrier(self) -> None:
        if self.group is not None:
            import torch.distributed as dist
            dist.barrier(group=self.group)

    def wait(self):
        """Join the writer; re-raise its error, if it died."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        if self.keep <= 0:  # keep-all: steps[:-0] would delete everything
            return
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # ---- restore ------------------------------------------------------------
    def all_steps(self):
        """COMMITTED steps only: a step directory counts iff its manifest
        exists AND parses."""
        out = []
        for name in sorted(os.listdir(self.dir)):
            if not name.startswith("step_") or not name[5:].isdigit():
                continue
            try:
                with open(os.path.join(self.dir, name, "manifest.json")) as f:
                    json.load(f)
            except (OSError, json.JSONDecodeError, ValueError):
                continue
            out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _at(self, step: Optional[int], load):
        """load(step) of `step`, or of the newest committed step it does
        not fail on (latest mode falls back past an unreadable step; an
        explicit step raises)."""
        if step is not None:
            return load(step)
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        last_err: Optional[Exception] = None
        for s in reversed(steps):
            try:
                return load(s)
            except _ERRORS as e:
                last_err = e
        raise FileNotFoundError(f"no readable checkpoint in {self.dir} "
                                f"(newest failure: {last_err})")

    def open(self, step: Optional[int] = None, *, process: int = 0) -> CheckpointReader:
        """A reader of `step`, or of the newest committed step whose shards
        open."""
        return self._at(step, lambda s: CheckpointReader(self.dir, s, process))

    def restore(self, step: Optional[int] = None, *, process: int = 0):
        """-> (step, state, extra): the whole tree as host tensors (0-d
        for scalars, bf16 from its bits), as the JAX package's `restore`
        gives numpy arrays; latest mode falls back past a step any of whose
        leaves cannot be read."""
        def load(s):
            with CheckpointReader(self.dir, s, process) as r:
                return s, _unflatten({k: r.read(k) for k in r.keys()}), r.extra
        return self._at(step, load)

