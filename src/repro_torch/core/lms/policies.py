"""LMS activation tagging and the policy that decides, per tagged name,
whether a tensor is saved on the device, offloaded to pinned host memory,
or rematerialized in the backward pass.

In the JAX package activations are named with `checkpoint_name` and a
`jax.remat` policy built from the planner's assignment decides per name.
The port has its own recompute boundary per decoder layer (`LayerFrame`),
driven by `torch.autograd.graph.saved_tensors_hooks`:

* the layer's forward runs once with autograd on. `tag(x, name)` names a
  value; `tagged(name, fn, *args)` names the value fn computes, and marks
  the ops inside fn as a region of the layer. A tagged value whose name the
  policy saves is kept on the device; one it offloads is copied to pinned
  host memory on a side stream (and its device memory freed once the
  layer's forward is done); one it rematerializes is kept nowhere.
* every tensor autograd saves for the backward passes through the pack
  hook: a tagged value kept by the policy (or a view of one) and the
  layer's params become handles to the kept copy; everything else is
  dropped, as under `save_only_these_names`.
* in the backward, the first dropped tensor asked for replays the layer
  forward from its kept input, with autograd on, and takes the dropped
  tensors from the replay by their position in the forward. A region whose
  value is kept, and whose saved tensors were all kept values, params or
  its own arguments, is skipped in the replay (its value comes from the
  kept copy, its arguments from the replay): a norm whose output is saved
  is not computed again, and neither is the projection behind a saved
  q/k/v. The replay stops as soon as it has every dropped tensor.

Why not `torch.utils.checkpoint`'s selective checkpointing: its policy
sees dispatcher ops one at a time, before they run, so it cannot learn
that an op's output is tagged afterwards, and the port's kernels (RMSNorm)
are calls it cannot skip; the count of RMSNorm launches a step would not
follow the plan.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, FrozenSet, Optional

import torch

from repro_torch.core.lms import offload as off
from repro_torch.obs import get_obs

# Every activation class a decoder layer produces, in rough size order.
# The planner reasons about these names; blocks tag tensors with them.
ACTIVATION_NAMES = (
    "resid",        # residual stream entering each layer   [B,S,d]
    "attn_norm",    # post-norm attn input                  [B,S,d]
    "mlp_norm",     # post-norm mlp input                   [B,S,d]
    "qkv",          # projected q (k,v smaller w/ GQA)      [B,S,H,D]
    "attn_out",     # attention output pre-proj             [B,S,H,D]
    "mlp_hidden",   # MLP hidden                            [B,S,f]
    "moe_hidden",   # gathered expert hidden                [E,C,f]
    "router_probs", # router softmax                        [B,S,E]
    "ssd_state",    # per-chunk SSD states                  [B,nc,H,P,N]
    "ssd_xz",       # ssm in-proj output                    [B,S,2*di]
    "lru_h",        # RG-LRU hidden sequence                [B,S,w]
    "logits",       # never offloaded; listed for the planner's size model
)

DECISIONS = ("save", "offload", "remat")


@dataclass(frozen=True)
class Policy:
    """Which tagged names are kept on the device (`saved`) or offloaded to
    host (`offloaded`); every other tagged name, and every untagged
    intermediate, is recomputed. `everything`: nothing is recomputed (the
    JAX package's `everything_saveable`)."""
    saved: FrozenSet[str] = frozenset()
    offloaded: FrozenSet[str] = frozenset()
    everything: bool = False

    def decide(self, name: str) -> str:
        if self.everything or name in self.saved:
            return "save"
        if name in self.offloaded:
            return "offload"
        return "remat"


def build_policy(assignment: Dict[str, str]) -> Policy:
    """assignment: name -> "save" | "offload" | "remat". Unlike the JAX
    package, which compiles offloaded names as saved where the platform has
    one memory space, the port offloads on every device: on the CPU the
    host copy is an ordinary copy, so the CPU runs the same code."""
    for n, v in assignment.items():
        if v not in DECISIONS:
            raise ValueError(f"activation {n!r}: decision {v!r} not in {DECISIONS}")
    return Policy(saved=frozenset(n for n, v in assignment.items() if v == "save"),
                  offloaded=frozenset(n for n, v in assignment.items() if v == "offload"))


def policy_from_preset(preset: str) -> Optional[Policy]:
    if preset == "none":
        return None  # no recompute boundary at all
    if preset == "full":
        return Policy()
    if preset == "save_all":
        return Policy(everything=True)
    if preset == "offload":
        return build_policy({n: "offload" for n in ("resid", "mlp_hidden", "qkv")})
    raise ValueError(preset)


# ---------------------------------------------------------------------------
# tagging
# ---------------------------------------------------------------------------

_local = threading.local()


def _current() -> Optional["LayerFrame"]:
    return getattr(_local, "frame", None)


def tag(x, name: str):
    """Name the tensor x as activation class `name`; -> x. Outside a
    layer frame (no policy) it is the identity."""
    frame = _current()
    return x if frame is None else frame.tag_value(x, name)


def tagged(name: str, fn, *args, **kwargs):
    """fn(*args, **kwargs), its tensor result tagged `name`; the ops inside
    fn form a region the replay may skip (module docstring)."""
    frame = _current()
    if frame is None:
        return fn(*args, **kwargs)
    return frame.tag_region(name, fn, args, kwargs)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _view(t: torch.Tensor, base: torch.Tensor):
    """t's layout relative to base's storage: (size, stride, offset)."""
    return tuple(t.shape), tuple(t.stride()), t.storage_offset() - base.storage_offset()


def _as_view(base: torch.Tensor, view) -> torch.Tensor:
    size, stride, offset = view
    return base.as_strided(size, stride, base.storage_offset() + offset)


class _StopReplay(Exception):
    pass


class _Tag:
    """One tagged value of a layer: its decision and where it is kept."""
    __slots__ = ("name", "decision", "device", "host", "fetched")

    def __init__(self, name, decision):
        self.name, self.decision = name, decision
        self.device = None      # the device tensor (saved; offloaded until the forward ends)
        self.host = None        # offload.Pending of the host copy
        self.fetched = None     # offload.Pending of the copy back


class LayerFrame:
    """The recompute boundary of one layer for one forward and backward
    (module docstring).

    replay(x, leaves): the layer forward from its input and its param
    leaves. device_params(): the param leaves for the backward (the
    re-streamed copy of a host-resident layer). Tensors saved from a param
    are handles when `params_streamed` (so the forward's device copy is
    freed after the layer), else kept as they are (the params stay resident
    anyway).

    Each value the policy keeps is counted on the obs registry, under
    `lms.save_bytes.<name>` or `lms.offload_bytes.<name>`."""

    def __init__(self, policy: Policy, device, replay, device_params, *,
                 params_streamed: bool):
        self.policy = policy
        self.device = torch.device(device)
        self.replay_fn = replay
        self.device_params = device_params
        self.params_streamed = params_streamed
        self.tags = []                        # _Tag, in tagging order
        self.input_tag = None                 # the layer input's tag
        self.regions = []                     # one dict per tagged region
        self.inputs: Dict[tuple, tuple] = {}  # drop key -> (arg index, view)
        self.needed: set = set()              # drop keys, each filled by the replay
        self.captured: Dict[tuple, torch.Tensor] = {}
        self.replayed = False
        # the walk through the layer, forward and replay alike
        self.mode = None                      # "forward" | "replay" | None
        self.seq = 0                          # region or gap between regions
        self.count = 0                        # packs so far in this one
        self.region_ix = 0
        # forward only
        self.tag_of: Dict[int, int] = {}      # storage -> tag index
        self.param_of: Dict[int, int] = {}    # storage -> param leaf index
        self.param_leaves = []
        self.resident: set = set()            # storages kept as they are
        self.region = None                    # the region being run, its args
        self.region_args = []

    def _walk(self, mode):
        self.mode = mode
        self.seq, self.count, self.region_ix = 0, 0, 0
        _local.frame = self

    def _next_seq(self):
        self.seq += 1
        self.count = 0

    # ---- forward --------------------------------------------------------
    def forward(self, fn, x, leaves, resident_storages=()):
        """fn(x) as the layer's forward, with `leaves` its param leaves; ->
        fn's result. x, the layer input, is the "resid" value, kept
        whatever the policy says: the replay starts from it."""
        self.param_leaves = list(leaves)
        if self.params_streamed:
            self.param_of = {_storage(t): i for i, t in enumerate(self.param_leaves)}
        self.resident = set(resident_storages)
        self._walk("forward")
        try:
            x = self.tag_value(x, "resid", force=True)
            self.input_tag = self.tag_of[_storage(x)]
            with torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack):
                out = fn(x)
        finally:
            _local.frame = None
            self.mode = None
        # offloaded values leave the device (each copy recorded its stream)
        for t in self.tags:
            if t.decision == "offload":
                t.device = None
        self.param_leaves, self.tag_of, self.param_of = [], {}, {}
        return out

    def tag_value(self, x, name: str, force: bool = False):
        if self.mode != "forward":
            return x
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"tag {name!r}: expected a tensor, got {type(x).__name__}")
        decision = self.policy.decide(name)
        if force and decision == "remat":
            decision = "save"
        if decision == "remat" or _storage(x) in self.tag_of:
            return x
        if not x.is_contiguous() or \
                x.untyped_storage().nbytes() != x.numel() * x.element_size():
            x = x.clone(memory_format=torch.contiguous_format)
        entry = _Tag(name, decision)
        entry.device = x.detach()
        nbytes = x.numel() * x.element_size()
        get_obs().registry.counter(f"lms.{decision}_bytes.{name}").inc(nbytes)
        if decision == "offload":
            entry.host = off.offload(entry.device, cls="activations")
        self.tag_of[_storage(x)] = len(self.tags)
        self.tags.append(entry)
        return x

    def tag_region(self, name, fn, args, kwargs):
        if self.mode is None:
            return fn(*args, **kwargs)
        ix = self.region_ix
        self.region_ix += 1
        self._next_seq()
        if self.mode == "replay":
            region = self.regions[ix]
            if not region["skip"]:
                out = fn(*args, **kwargs)
            else:
                arg_tensors = _tensors((args, kwargs))
                for key, (ai, view) in self.inputs.items():
                    if key[0] == self.seq:
                        self._capture(key, _as_view(arg_tensors[ai], view))
                out = self._tag_device(region["tag"]).detach()
                out.requires_grad_(region["grad"])
            self._next_seq()
            return out
        region = {"name": name, "drops": False, "skip": False, "tag": None,
                  "grad": False}
        self.regions.append(region)
        self.region, self.region_args = region, _tensors((args, kwargs))
        try:
            out = fn(*args, **kwargs)
        finally:
            self.region, self.region_args = None, []
        if not isinstance(out, torch.Tensor):
            raise TypeError(f"tagged region {name!r} must return one tensor")
        self._next_seq()
        before = len(self.tags)
        out = self.tag_value(out, name)
        if len(self.tags) > before:
            region.update(tag=before, grad=out.requires_grad, skip=not region["drops"])
        return out

    def _pack(self, t: torch.Tensor):
        key = (self.seq, self.count)
        self.count += 1
        ptr = _storage(t)
        ix = self.tag_of.get(ptr)
        if ix is not None:
            return ("tag", ix, _view(t, self.tags[ix].device))
        ix = self.param_of.get(ptr)
        if ix is not None:
            return ("param", ix, _view(t, self.param_leaves[ix]))
        if ptr in self.resident:
            return t
        if self.region is not None:
            args = {_storage(a): i for i, a in enumerate(self.region_args)}
            ai = args.get(ptr)
            if ai is None:
                self.region["drops"] = True
            else:
                self.inputs[key] = (ai, _view(t, self.region_args[ai]))
        self.needed.add(key)
        return ("drop", key)

    # ---- backward -------------------------------------------------------
    def prefetch(self) -> None:
        """Issue the copies back of this layer's offloaded values (the
        executor calls it ahead of the layer's backward)."""
        for entry in self.tags:
            if entry.decision == "offload" and entry.fetched is None:
                entry.fetched = off.fetch(entry.host, self.device, cls="activations")

    def _tag_device(self, ix: int) -> torch.Tensor:
        entry = self.tags[ix]
        if entry.decision == "save":
            return entry.device
        if entry.fetched is None:
            self.prefetch()
        return entry.fetched.wait()

    def _unpack(self, handle):
        if isinstance(handle, torch.Tensor):
            return handle
        kind = handle[0]
        if kind == "tag":
            return _as_view(self._tag_device(handle[1]), handle[2])
        if kind == "param":
            return _as_view(self.device_params()[handle[1]], handle[2])
        if not self.replayed:
            self._replay()
        return self.captured[handle[1]]

    def _capture(self, key, t):
        if key in self.needed and key not in self.captured:
            self.captured[key] = t
            if len(self.captured) == len(self.needed):
                raise _StopReplay

    def _replay(self) -> None:
        x = self._tag_device(self.input_tag).detach().requires_grad_(True)
        leaves = [t.detach().requires_grad_(t.is_floating_point())
                  for t in self.device_params()]

        def pack(t):
            key = (self.seq, self.count)
            self.count += 1
            self._capture(key, t)

        self._walk("replay")
        try:
            with torch.enable_grad(), \
                    torch.autograd.graph.saved_tensors_hooks(pack, lambda h: h):
                self.replay_fn(x, leaves)
        except _StopReplay:
            pass
        finally:
            _local.frame = None
            self.mode = None
        self.replayed = True
        missing = self.needed - set(self.captured)
        if missing:
            raise RuntimeError(f"the layer replay did not reproduce {len(missing)} "
                               "saved tensors: the layer forward must run the same "
                               "ops each time")

    def release(self) -> None:
        """Drop everything kept for the backward (after the layer's)."""
        self.tags, self.regions, self.captured = [], [], {}
        self.inputs, self.needed = {}, set()
        self.replay_fn = self.device_params = None
