"""Host residency: the swap side of LMS on the card.

`stream_layer_to_device` is the swap-in primitive of the layer-streaming
executor (`models/transformer.py`) and the streamed optimizer sweep
(`train/steps.py`); `stream_layer_to_host` its swap-out. (The grads' host
sink writes from the DDL reduction queue's own stream,
`core/ddl/overlap.py`, and counts there.) On the card each
copy runs on a side stream of its own direction (host to device, device to
host), `non_blocking`, and completes at a CUDA event the compute stream
waits on before it reads the copy, so a copy overlaps the compute that
does not need it. On the CPU the same calls make ordinary copies (the
host is the device), so the CPU runs the same code.

`PinnedArena` holds the host-resident train state: one allocation pinned
with `cudaHostRegister`, carved into tensors. Torch's own pinned allocator
rounds each block up to a power of two, which at the state's size (tens of
GB) would waste a third of the host's memory. `reserve_pinned` keeps one
arena pinned for states placed one after another.

Swap accounting (DESIGN.md §12) goes to the obs registry under the JAX
package's counter names, `lms.swap_in_bytes.<cls>`,
`lms.swap_in_events.<cls>` and the same for `lms.swap_out`. The JAX
package counts once per trace (its helpers run inside jitted scan
bodies); the port runs eagerly, so these count every execution: the bytes
and events a run actually moved, one event per layer (or optimizer slice,
or tagged activation) per direction.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.obs import get_obs
from repro_torch.tree import tree_leaves, tree_map

HOST = "pinned_host"
DEVICE = "device"


def effective_kind(kind: str, device) -> Optional[str]:
    """The memory kind `kind` as the compute device has it: pinned host
    memory only when the compute device is CUDA (a CPU-only torch cannot
    pin, and the CPU is its own host), else None; "device" as is."""
    if kind == HOST:
        return HOST if torch.device(device).type == "cuda" else None
    return kind


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def record_swap(site: str, nbytes: int, cls: str, events: int = 1) -> None:
    """Count one swap of `nbytes` of residency class `cls` ("params",
    "optimizer", "grads", "activations") at site "lms.swap_in" or
    "lms.swap_out"."""
    reg = get_obs().registry
    reg.counter(f"{site}_bytes.{cls}").inc(nbytes)
    reg.counter(f"{site}_events.{cls}").inc(events)


def swap_counters() -> Dict[str, float]:
    """{counter name: value} of every `lms.swap_*` counter."""
    reg = get_obs().registry
    return {n: reg.counter(n).value for n in reg.names()
            if n.startswith("lms.swap_")}


_STREAMS: Dict[torch.device, tuple] = {}


def side_streams(device):
    """-> (host-to-device stream, device-to-host stream) of a CUDA device,
    made once per device."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _STREAMS:
        _STREAMS[device] = (torch.cuda.Stream(device), torch.cuda.Stream(device))
    return _STREAMS[device]


class Pending:
    """A copy in flight: its destination tree and the event it completes
    at (None on the CPU, where copies are done when issued)."""

    def __init__(self, tree, event=None):
        self.tree = tree
        self.event = event

    def wait(self):
        """-> the tree, once the current stream has waited for the copy."""
        if self.event is not None:
            torch.cuda.current_stream().wait_event(self.event)
            self.event = None
        return self.tree


def _require_pinned(tree, what: str) -> None:
    for t in tree_leaves(tree):
        if t.device.type != "cpu" or not t.is_pinned():
            raise ValueError(f"{what} must be in pinned host memory, got a "
                             f"{'pageable' if t.device.type == 'cpu' else t.device.type} tensor")


def stream_layer_to_device(layer, device, *, cls: str = "params") -> Pending:
    """Swap one layer's tensor tree in: a device copy of each leaf. On the
    card the leaves must be pinned; the destination is allocated on the
    compute stream, and the copy stream waits for what the compute stream
    has queued so far (the memory may be a block that work still reads),
    then copies. -> Pending; `.wait()` before reading the tree."""
    device = torch.device(device)
    record_swap("lms.swap_in", tree_bytes(layer), cls)
    if device.type != "cuda":
        return Pending(tree_map(lambda t: t.to(device, copy=True), layer))
    _require_pinned(layer, f"a streamed {cls} layer")
    h2d, _ = side_streams(device)
    out = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), layer)
    h2d.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(h2d):
        tree_map(lambda o, t: o.copy_(t, non_blocking=True), out, layer)
        event = torch.cuda.Event()
        event.record(h2d)
    for o in tree_leaves(out):
        o.record_stream(h2d)
    return Pending(out, event)


def stream_layer_to_host(layer, out, *, cls: str = "params"):
    """Swap one layer's device tree out into `out`, a host tree of the same
    structure (pinned on the card). The copy stream waits for the compute
    stream (which produced the tree), then copies. -> the event the copy
    completes at (None on the CPU)."""
    record_swap("lms.swap_out", tree_bytes(layer), cls)
    leaves = tree_leaves(layer)
    if not leaves or leaves[0].device.type != "cuda":
        tree_map(lambda o, t: o.copy_(t), out, layer)
        return None
    _require_pinned(out, f"the host copy of a {cls} layer")
    _, d2h = side_streams(leaves[0].device)
    d2h.wait_stream(torch.cuda.current_stream(leaves[0].device))
    with torch.cuda.stream(d2h):
        tree_map(lambda o, t: o.copy_(t, non_blocking=True), out, layer)
        event = torch.cuda.Event()
        event.record(d2h)
    for t in leaves:
        t.record_stream(d2h)
    return event


def offload(t: torch.Tensor, *, cls: str = "activations") -> Pending:
    """Copy a device tensor to a new host tensor (pinned on the card, from
    torch's pinned allocator). -> Pending of the host tensor: its event is
    the copy's, for the copy back to wait on."""
    pin = effective_kind(HOST, t.device) is not None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
    return Pending(host, stream_layer_to_host(t, host, cls=cls))


def fetch(pending: Pending, device, *, cls: str = "activations") -> Pending:
    """Copy back what `offload` sent to the host: the copy stream first
    waits for the offload's own copy."""
    if pending.event is not None:
        side_streams(device)[0].wait_event(pending.event)
    return stream_layer_to_device(pending.tree, device, cls=cls)


def fence(device) -> None:
    """Order everything after this call behind every copy issued so far: the
    compute stream and the host-to-device stream wait for the device-to-host
    stream (the next read of a written-back host tensor must see the
    write), and the compute stream for the host-to-device stream."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    h2d, d2h = side_streams(device)
    cur = torch.cuda.current_stream(device)
    h2d.wait_stream(d2h)
    cur.wait_stream(d2h)
    cur.wait_stream(h2d)


_ARENAS: list = []   # live arenas, reserved ones included


def pinned_bytes() -> int:
    """Bytes of host state the arenas in use hold (what their tensors take;
    a reserved arena may hold more in all)."""
    return sum(a.offset for a in _ARENAS if a.in_use)


def reserve_pinned(nbytes: int, device) -> "PinnedArena":
    """Pin `nbytes` once, for states placed one after another: a placement
    that fits takes the reserved arena from its start (`pinned_arena`),
    and `release_arenas` hands it back instead of unpinning it. On a host
    that does not get pinned memory back once it is freed (a virtual
    machine whose hypervisor keeps what the card's driver pinned), this
    keeps a process's pinned memory at its largest state, not the sum of
    its states."""
    arena = PinnedArena(nbytes, device, reserved=True)
    arena.in_use = False
    return arena


def pinned_arena(nbytes: int, device) -> "PinnedArena":
    """An arena for one state of `nbytes`: a free reserved arena that holds
    it, else a new one."""
    device = torch.device(device)
    for a in _ARENAS:
        if a.reserved and not a.in_use and a.device == device and a.capacity >= nbytes:
            a.reuse()
            return a
    return PinnedArena(nbytes, device)


def release_arenas() -> None:
    """Hand back every arena: a reserved one stays pinned for the next
    state, any other is unpinned and dropped (its memory is freed once the
    tensors carved from it are gone too). No tensor of a released state
    may be used after."""
    for a in list(_ARENAS):
        if a.reserved:
            if a.device.type == "cuda":
                torch.cuda.synchronize(a.device)
            a.dirty = a.dirty or a.offset > 0
            a.in_use = False
        else:
            a.release()


class PinnedArena:
    """Host tensors carved from one allocation of `nbytes`, pinned with
    `cudaHostRegister` when `device` is CUDA (an ordinary CPU allocation
    otherwise). Each tensor starts on a 4 KiB boundary and comes zeroed.
    The memory is zeroed before it is pinned, which touches every page
    once. An arena lives until `release()` (or `release_arenas()`) unpins
    it: its tensors keep their memory after that, as ordinary pageable
    memory. A reserved arena (`reserve_pinned`) is reused instead."""

    ALIGN = 4096

    def __init__(self, nbytes: int, device, reserved: bool = False):
        self.device = torch.device(device)
        self.capacity = int(nbytes)
        self.reserved = reserved
        self.in_use = True
        self.dirty = False          # holds an earlier state's values
        self.buffer = torch.zeros(max(self.capacity, 1), dtype=torch.uint8)
        self.offset = 0
        self.registered = False
        if effective_kind(HOST, self.device) is not None and self.capacity:
            err = torch.cuda.cudart().cudaHostRegister(
                self.buffer.data_ptr(), self.buffer.numel(), 0)
            if int(err) != 0:
                raise RuntimeError(f"cudaHostRegister of {self.capacity} bytes failed: "
                                   f"error {int(err)}")
            self.registered = True
        _ARENAS.append(self)

    @classmethod
    def padded(cls, nbytes: int) -> int:
        return -(-int(nbytes) // cls.ALIGN) * cls.ALIGN

    def reuse(self) -> None:
        self.offset, self.in_use = 0, True

    def take(self, shape, dtype) -> torch.Tensor:
        """A new tensor of `shape` and `dtype` in the arena (zeros)."""
        n = 1
        for s in shape:
            n *= s
        nbytes = n * torch.empty((), dtype=dtype).element_size()
        end = self.offset + self.padded(nbytes)
        if end > self.buffer.numel():
            raise ValueError(f"pinned arena of {self.capacity} bytes is full")
        t = self.buffer[self.offset:self.offset + nbytes].view(dtype).view(shape)
        if self.dirty:
            t.zero_()
        self.offset = end
        return t

    def release(self) -> None:
        if self.registered:
            torch.cuda.synchronize(self.device)
            err = torch.cuda.cudart().cudaHostUnregister(self.buffer.data_ptr())
            if int(err) != 0:
                raise RuntimeError(f"cudaHostUnregister failed: error {int(err)}")
            self.registered = False
        if self in _ARENAS:
            _ARENAS.remove(self)
        self.buffer = torch.empty(0, dtype=torch.uint8)
