"""Paged, host-spilling KV-cache pool — the serving side of the paper's
Large Model Support: only what a decode tick needs stays on the device.

The pool owns two arenas per paged leaf (attn k/v, and their int8 scales)
and two per state leaf (Mamba-2's SSM state and convolution inputs: per
slot, whatever the sequence length):

* the **device arena**, a shared page pool ``[L, device_pages + 1,
  page_size, ...]`` addressed through an ``int32[slots, max_pages]`` page
  table that lives inside the cache dict (top-level ``"page_table"``), so
  the decode step reads it next to the arenas. Slot ``b``'s position ``p``
  lives at arena row ``page_table[b, p // page_size]``, offset
  ``p % page_size``; attach and release are page-table edits. Row
  ``device_pages`` is the null page free slots point at.
* the **host arena**, ``[host_pages, L, page_size, ...]`` in pinned host
  memory on the card (page-major, so each page is one contiguous block),
  holding the pages of requests that are prefilled but still waiting for
  a decode slot.
* a state leaf keeps the decode step's slot-batched layout on the device,
  ``[L, slots, ...]``, and a ``[host_slots, L, ...]`` pinned host buffer
  for the waiting requests; it moves whole, a slot at a time, wherever the
  pages of a paged leaf move. A stack of state leaves only has no page
  table (and needs no device pages).

Lifecycle: ``spill`` copies a prefilled request's content pages (and
state) out to the host arena; ``prefetch`` claims the request's device
pages and copies its content pages into the arena ahead of its slot
attach; ``attach`` is then only a page-table edit (or copies the pages
itself when no prefetch ran), and copies the state into the slot;
``release`` nulls the slot's table row and returns its pages. A request
of state alone is never staged ahead: a serve plan prices the slots'
state on the device and the prefill's caches beside it, so its
attach copies the state from its host slot straight into the slot (the
JAX pool stages it in a device buffer of its own). A request reserves
``pages_needed(prompt + max_new)`` device pages up front; a spill moves
only the ``ceil(prompt / page_size)`` pages that hold keys.

``preempt`` is spill-and-requeue: an active request's content pages and
state go back to the host arena and its reservation frees, so a later
attach resumes it bitwise. A `FaultInjector` can make the budget
checks report full ("exhaust" at ``pool.reserve`` / ``pool.spill``).

On the card the host<->device page and state copies run on a side stream
of the pool's own, ``non_blocking``: each batch of copies first waits for
what the compute stream has queued (the ticks that wrote what it reads),
and the next decode tick waits for the copies at an event
(`wait_copies`), as does any write to the arena or a slot on the compute
stream. The page table is copied in from a pinned staging row. The free
lists are LIFO, so churn scrambles page placement; the page table makes
that free.

On a tensor-parallel mesh (`mesh=`) each rank's pool holds its own block
of every leaf, the `kv_heads` over `model` (`transformer.cache_defs`),
in both arenas; the page table, the page dims and every page decision
are the same on every rank, since they read only lengths and the
engine's one schedule.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import kvquant
from repro_torch.models import transformer as tr
from repro_torch.models.layers import DTYPES, is_def
from repro_torch.models.paging import PAGED_LEAF_KEYS
from repro_torch.obs import Obs, get_obs
from repro_torch.runtime.inject import FaultInjector

__all__ = ["PagedKVPool", "PAGED_LEAF_KEYS"]


def _flatten(tree, prefix: Tuple[str, ...] = ()):
    """[(key path, leaf)] of a nested dict, in key order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(_flatten(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def _set(tree, keys, value):
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def _get(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


@dataclass
class _Entry:
    reserve_pages: int          # device pages reserved at admission
    content_pages: int          # pages actually holding prefilled keys
    length: int                 # valid prompt tokens
    where: str                  # "host" | "staged" | "dev"
    host_ids: Optional[np.ndarray] = None
    host_slot: Optional[int] = None
    slot: Optional[int] = None
    dev_ids: Optional[np.ndarray] = None   # arena rows owned (staged/dev)


class PagedKVPool:
    def __init__(self, model, *, slots: int, max_len: int, page_size: int,
                 device_pages: int, host_pages: int, device,
                 host_slots: Optional[int] = None, cache_defs=None,
                 kv_dtype: str = "model", injector: Optional[FaultInjector] = None,
                 obs: Optional[Obs] = None, mesh=None):
        cfg = model.cfg
        self._obs = obs if obs is not None else get_obs()
        if max_len % page_size:
            raise ValueError(
                f"page_size={page_size} must divide max_len={max_len}: a "
                "ragged tail page would make spill's page reshape and the "
                "page table's fixed width disagree about the content extent")
        self.device = torch.device(device)
        self.slots, self.max_len, self.page_size = slots, max_len, page_size
        self.device_pages = device_pages
        self.max_pages = max_len // page_size
        self.null_page = device_pages
        self.kv_dtype = kvquant.validate_kv_dtype(kv_dtype)
        base = tr.cache_defs(cfg, slots, max_len, mesh)
        if kvquant.is_int8(self.kv_dtype):
            # int8 KV pages: both arenas store codes + per-row scales
            base = kvquant.quantize_cache_defs(base, max_len)
        # spilled requests the host arena holds at once
        host_slots = host_slots if host_slots is not None else max(
            host_pages // max(self.max_pages, 1), 1)
        pin = self.device.type == "cuda"

        # leaf path -> has a leading ("layers",) axis, for the paged and
        # the state leaves
        self._stacked: Dict[Tuple[str, ...], bool] = {}
        self._state: Dict[Tuple[str, ...], bool] = {}
        self._host: Dict[Tuple[str, ...], torch.Tensor] = {}
        self.cache: Dict = {}
        # bytes one page / one slot's state moves across all leaves: the
        # spans' byte accounting (JAX `_page_bytes`, `_state_bytes`)
        self._page_bytes = 0
        self._state_bytes = 0
        for keys, d in _flatten(base):
            assert is_def(d)
            stacked = keys[0].startswith("stack")
            ba = 1 if stacked else 0
            dt = DTYPES[d.dtype]
            lead = d.shape[:ba]
            if not (keys[-1] in PAGED_LEAF_KEYS and len(d.shape) > ba + 1
                    and d.shape[ba + 1] == max_len):
                # a state leaf: the slot-batched layout, moved a slot at a time
                self._state[keys] = stacked
                self._host[keys] = torch.empty((host_slots,) + lead + d.shape[ba + 1:],
                                               dtype=dt, pin_memory=pin)
                self._state_bytes += self._host[keys][0].nbytes
                _set(self.cache, keys, torch.zeros(d.shape, dtype=dt, device=self.device))
                continue
            self._stacked[keys] = stacked
            tail = d.shape[ba + 2:]
            # every host page is written (spill) before it is read (prefetch)
            self._host[keys] = torch.empty(
                (host_pages,) + lead + (page_size,) + tail, dtype=dt,
                pin_memory=pin)
            self._page_bytes += self._host[keys][0].nbytes
            _set(self.cache, keys, torch.zeros(
                lead + (device_pages + 1, page_size) + tail, dtype=dt,
                device=self.device))
        self.has_paged = bool(self._stacked)
        self._ptab = np.full((slots, self.max_pages), self.null_page, np.int32)
        if self.has_paged:
            self.cache["page_table"] = torch.from_numpy(self._ptab.copy()).to(self.device)
        # the table's pinned staging row, and the event its last copy
        # completes at (the row is rewritten only after it)
        self._ptab_staging = torch.from_numpy(self._ptab.copy())
        if pin:
            self._ptab_staging = self._ptab_staging.pin_memory()
        self._table_copied = None
        # page copies: a side stream on the card, and the event the last
        # batch of copies completes at
        self._copy_stream = torch.cuda.Stream(self.device) if pin else None
        self._copied = None
        if cache_defs is not None:
            self._check_layout(cache_defs)

        self._free_dev: List[int] = list(range(device_pages))
        self._free_host_pages: List[int] = list(range(host_pages))
        self._free_host_slots: List[int] = list(range(host_slots))
        self._table: Dict[int, _Entry] = {}
        self._resident = 0          # reserved device pages (active slots)
        self._inj = injector
        # the JAX pool's stat keys, so the engine's metrics() key set
        # matches; repack_pages is 0 by construction
        self.stats = {"spilled_pages": 0, "fetched_pages": 0,
                      "prefetched_pages": 0, "direct_pages": 0,
                      "peak_resident_pages": 0, "spilled_requests": 0,
                      "preempted_requests": 0, "preempted_pages": 0,
                      "injected_exhaustions": 0, "repack_pages": 0}

    def _check_layout(self, defs) -> None:
        """The arenas must be laid out as the decode step expects."""
        want = {keys: (tuple(d.shape), DTYPES[d.dtype]) for keys, d in _flatten(defs)}
        have = {keys: (tuple(t.shape), t.dtype) for keys, t in _flatten(self.cache)}
        if want != have:
            raise ValueError(f"pool cache layout {have} != decode step's {want}")

    # ---- admission arithmetic --------------------------------------------
    def pages_needed(self, total_len: int) -> int:
        if not self.has_paged:
            return 0
        return -(-min(total_len, self.max_len) // self.page_size)

    def _has_dev(self, n_pages: int) -> bool:
        return n_pages <= len(self._free_dev)

    def _has_host(self, content_pages: int) -> bool:
        return (len(self._free_host_pages) >= content_pages
                and len(self._free_host_slots) >= 1)

    def can_reserve(self, n_pages: int) -> bool:
        """Admission check. An injected "exhaust" at pool.reserve reports
        the device budget full here only, never in the internal checks, so
        an armed event cannot abort an operation already admitted."""
        if self._inj is not None and self._inj.wants("pool.reserve", "exhaust"):
            self.stats["injected_exhaustions"] += 1
            return False
        return self._has_dev(n_pages)

    def can_spill(self, content_pages: int) -> bool:
        if self._inj is not None and self._inj.wants("pool.spill", "exhaust"):
            self.stats["injected_exhaustions"] += 1
            return False
        return self._has_host(content_pages)

    def status(self, rid: int) -> Optional[str]:
        """"host" | "staged" | "dev" | None (not pooled)."""
        e = self._table.get(rid)
        return e.where if e is not None else None

    # ---- page movement ----------------------------------------------------
    def _pages(self, leaf, stacked: bool, n: int):
        """The first n pages of a B=1 request cache leaf, page-major:
        [*lead, 1, max_len, ...] -> [n, *lead, ps, ...] (contiguous)."""
        ps = self.page_size
        if stacked:
            block = leaf[:, 0, :n * ps]
            return block.reshape((block.shape[0], n, ps) + tuple(block.shape[2:])
                                 ).transpose(0, 1).contiguous()
        block = leaf[0, :n * ps]
        return block.reshape((n, ps) + tuple(block.shape[1:])).contiguous()

    def _arena_page(self, keys, page: int):
        """One device arena page of a leaf: a view [*lead, ps, ...]."""
        arena = _get(self.cache, keys)
        return arena[:, page] if self._stacked[keys] else arena[page]

    def _slot_state(self, keys, slot: int, width: int = 0):
        """A state leaf's rows of one decode slot: a view [*lead, ...], or
        with width 1 [*lead, 1, ...] (a B = 1 cache's layout)."""
        leaf = _get(self.cache, keys)
        rows = slice(slot, slot + 1) if width else slot
        return leaf[:, rows] if self._state[keys] else leaf[rows]

    @staticmethod
    def _request_state(leaf, stacked: bool):
        """A B = 1 request cache's state leaf without its batch axis."""
        return leaf[:, 0] if stacked else leaf[0]

    # ---- copies -----------------------------------------------------------
    def _copies(self):
        """Context of a batch of page copies: on the card the side stream,
        after what the compute stream has queued; the event they complete
        at is kept for `wait_copies`."""
        return _Copies(self)

    def wait_copies(self) -> None:
        """Order the compute stream after every page copy issued so far:
        the decode tick, and any arena write on the compute stream, call
        it first."""
        if self._copied is not None:
            torch.cuda.current_stream(self.device).wait_event(self._copied)
            self._copied = None

    def _host_to_arena(self, e: _Entry, slot: Optional[int] = None) -> None:
        """Copy a request's content pages from the host arena into its
        claimed device pages, and its state into `slot`'s rows (at its
        attach: a request with state is never staged)."""
        assert slot is not None or not self._state, "state is copied at attach only"
        with self._copies():
            for keys in self._stacked:
                host = self._host[keys]
                for hid, pid in zip(e.host_ids[:e.content_pages],
                                    e.dev_ids[:e.content_pages]):
                    self._arena_page(keys, int(pid)).copy_(host[int(hid)],
                                                           non_blocking=True)
            for keys in self._state:
                self._slot_state(keys, slot).copy_(self._host[keys][e.host_slot],
                                                   non_blocking=True)

    def _sync_table(self):
        """Copy the numpy master page table into the cache's table tensor,
        in place (the JAX pool swaps in a new array that the decode step
        then donates), from the pinned staging row once its previous copy
        is done. No table without paged leaves."""
        if not self.has_paged:
            return
        if self._table_copied is not None:
            self._table_copied.synchronize()
        self._ptab_staging.numpy()[:] = self._ptab
        self.cache["page_table"].copy_(self._ptab_staging, non_blocking=True)
        if self.device.type == "cuda":
            self._table_copied = torch.cuda.Event()
            self._table_copied.record(torch.cuda.current_stream(self.device))

    def _map_slot(self, slot: int, dev_ids: Optional[np.ndarray]):
        """Point a slot's table row at its arena pages (unmapped logical
        pages stay on the null page)."""
        row = np.full((self.max_pages,), self.null_page, np.int32)
        if dev_ids is not None and len(dev_ids):
            row[:len(dev_ids)] = dev_ids
        self._ptab[slot] = row
        self._sync_table()

    def _ingest(self, req_cache):
        """Prefill output enters the pool at model width; int8 pools
        quantize it here, so prefill math itself stays untouched."""
        if kvquant.is_int8(self.kv_dtype):
            return kvquant.quantize_cache_tree(req_cache, self.max_len)
        return req_cache

    def _claim_dev(self, n: int) -> np.ndarray:
        assert n <= len(self._free_dev), "device arena page budget exceeded"
        return np.asarray([self._free_dev.pop() for _ in range(n)], np.int32)

    def _swap_bytes(self, pages: int, state: bool = True) -> int:
        """Bytes one lifecycle move touches: `pages` content pages across
        every paged leaf, and the slot's state block (JAX `_swap_bytes`)."""
        return pages * self._page_bytes + (self._state_bytes if state else 0)

    def _state_out(self, keys, leaf, hslot: int, c) -> None:
        """A B = 1 request cache's state leaf into host slot `hslot`, a
        copy on the side stream."""
        src = self._request_state(leaf, self._state[keys])
        c.keep(src)
        self._host[keys][hslot].copy_(src, non_blocking=True)

    # ---- lifecycle --------------------------------------------------------
    def spill(self, rid: int, req_cache, length: int,
              reserve_pages: int) -> None:
        """Copy a prefilled request's content pages out to the host arena
        (the cold path a request takes when no slot admits it yet)."""
        with self._obs.span("pool.spill", rid=rid, cls="kvcache") as ev:
            req_cache = self._ingest(req_cache)
            n = self.pages_needed(length)
            ev.attrs.update(pages=n, bytes=self._swap_bytes(n))
            assert len(self._free_host_pages) >= n and self._free_host_slots, \
                f"host arena full (need {n} pages and a slot)"
            assert rid not in self._table, f"request {rid} already pooled"
            ids = np.asarray([self._free_host_pages.pop() for _ in range(n)],
                             np.int32)
            hslot = self._free_host_slots.pop()
            with self._copies() as c:
                for keys, leaf in _flatten(req_cache):
                    if keys in self._state:
                        self._state_out(keys, leaf, hslot, c)
                        continue
                    if not n:
                        continue
                    pages = self._pages(leaf, self._stacked[keys], n)
                    c.keep(pages)
                    host = self._host[keys]
                    for j, hid in enumerate(ids):
                        host[int(hid)].copy_(pages[j], non_blocking=True)
            self._table[rid] = _Entry(reserve_pages, n, length, "host",
                                      host_ids=ids, host_slot=hslot)
        self.stats["spilled_pages"] += int(n)
        self.stats["spilled_requests"] += 1

    def prefetch(self, rid: int) -> bool:
        """Claim a spilled request's device pages and copy its content
        pages into the arena ahead of its slot attach, so the attach is a
        pure page-table edit. The full reservation is claimed here so the
        attach can never find the budget taken. No-op unless the request is
        host-resident and the budget admits it, and for a pool with state
        leaves (their room on the device is the slots')."""
        e = self._table.get(rid)
        if e is None or e.where != "host" or self._state:
            return False
        if not self._has_dev(e.reserve_pages):
            return False
        with self._obs.span("pool.prefetch", rid=rid, cls="kvcache",
                            pages=int(e.content_pages),
                            bytes=self._swap_bytes(e.content_pages)):
            e.dev_ids = self._claim_dev(e.reserve_pages)
            self._host_to_arena(e)
        e.where = "staged"
        self.stats["prefetched_pages"] += int(e.content_pages)
        return True

    def attach(self, rid: int, slot: int) -> None:
        """Map a spilled (or staged) request into a free slot. A staged
        request's pages already sit in the arena, so this is only a
        page-table edit; a host-resident one pays the copy here."""
        e = self._table[rid]
        assert e.where in ("host", "staged"), e.where
        # staged: the pages are in already (the JAX pool's count)
        moved = self._swap_bytes(e.content_pages if e.where == "host" else 0)
        with self._obs.span("pool.attach", rid=rid, slot=slot, cls="kvcache",
                            staged=(e.where == "staged"), bytes=moved):
            if e.where == "host":
                e.dev_ids = self._claim_dev(e.reserve_pages)
                self._host_to_arena(e, slot)
                self.stats["fetched_pages"] += int(e.content_pages)
        self._map_slot(slot, e.dev_ids)
        self._free_host_pages.extend(int(i) for i in e.host_ids)
        self._free_host_slots.append(e.host_slot)
        e.host_ids, e.host_slot = None, None
        e.where, e.slot = "dev", slot
        self._resident += e.reserve_pages
        self.stats["peak_resident_pages"] = max(
            self.stats["peak_resident_pages"], self._resident)

    def attach_fresh(self, rid: int, slot: int, req_cache, length: int,
                     reserve_pages: int) -> None:
        """Hot path: a slot was free at admission, so the prefilled pages go
        straight from the prefill output into freshly claimed arena rows —
        no host hop — and the slot's table row is pointed at them."""
        assert rid not in self._table, f"request {rid} already pooled"
        req_cache = self._ingest(req_cache)
        n = self.pages_needed(length)
        assert self._has_dev(reserve_pages), "admission check missing"
        dev_ids = self._claim_dev(reserve_pages)
        with self._obs.span("pool.attach_fresh", rid=rid, slot=slot,
                            cls="kvcache", pages=n,
                            bytes=self._swap_bytes(n)):
            # freed pages and slot rows may still be read by a preempt's
            # copy out
            self.wait_copies()
            rows = (torch.from_numpy(dev_ids[:n].astype(np.int64)).to(self.device)
                    if n else None)
            for keys, leaf in _flatten(req_cache):
                if keys in self._state:
                    self._slot_state(keys, slot).copy_(
                        self._request_state(leaf, self._state[keys]))
                    continue
                if n:
                    arena = _get(self.cache, keys)
                    pages = self._pages(leaf, self._stacked[keys], n)
                    if self._stacked[keys]:
                        arena[:, rows] = pages.transpose(0, 1)
                    else:
                        arena[rows] = pages
        self._table[rid] = _Entry(reserve_pages, n, length, "dev", slot=slot,
                                  dev_ids=dev_ids)
        self._map_slot(slot, dev_ids)
        self._resident += reserve_pages
        self.stats["direct_pages"] += int(n)
        self.stats["peak_resident_pages"] = max(
            self.stats["peak_resident_pages"], self._resident)

    def release(self, rid: int) -> None:
        """Return a finished request's pages: null the slot's table row and
        push its arena rows back on the free list — pointer writes only."""
        e = self._table.pop(rid)
        assert e.where == "dev", f"release of non-resident request: {e.where}"
        self._obs.instant("pool.release", rid=rid, pages=int(e.reserve_pages))
        self._resident -= e.reserve_pages
        self._free_dev.extend(int(i) for i in e.dev_ids)
        self._ptab[e.slot] = self.null_page
        self._sync_table()

    def preempt(self, rid: int, length: int) -> bool:
        """Spill-and-requeue preemption: reclaim an active request's device
        pages. Its `pages_needed(length)` content pages (the tokens so far)
        go from the arena back into the host arena, its slot's state whole
        into a host slot, its table row nulls and its whole reservation
        returns to the free list. The entry goes
        back to "host" as if spilled after prefill at the new length, so a
        later attach resumes decoding bitwise. The pages count as spilled
        too, so spilled == fetched + prefetched still holds. -> False (and
        nothing changes) when the host arena cannot hold them."""
        e = self._table[rid]
        assert e.where == "dev", f"preempt of non-resident request: {e.where}"
        n = self.pages_needed(length)
        if not self._has_host(n):
            return False
        ids = np.asarray([self._free_host_pages.pop() for _ in range(n)], np.int32)
        hslot = self._free_host_slots.pop()
        with self._obs.span("pool.preempt", rid=rid, cls="kvcache", pages=int(n),
                            bytes=self._swap_bytes(n)):
            with self._copies():
                for keys in self._stacked:
                    host = self._host[keys]
                    for hid, pid in zip(ids, e.dev_ids[:n]):
                        host[int(hid)].copy_(self._arena_page(keys, int(pid)),
                                             non_blocking=True)
                for keys in self._state:
                    self._host[keys][hslot].copy_(self._slot_state(keys, e.slot),
                                                  non_blocking=True)
        self._resident -= e.reserve_pages
        self._free_dev.extend(int(i) for i in e.dev_ids)
        self._ptab[e.slot] = self.null_page
        self._sync_table()
        e.where, e.slot, e.dev_ids = "host", None, None
        e.host_ids, e.host_slot = ids, hslot
        e.content_pages, e.length = n, length
        self.stats["preempted_requests"] += 1
        self.stats["preempted_pages"] += int(n)
        self.stats["spilled_pages"] += int(n)
        return True

    def drop(self, rid: int) -> None:
        """Free everything a request holds, wherever it is — the terminal
        path for cancelled / timed-out / failed requests (release() is the
        happy path and insists on device residency)."""
        e = self._table.pop(rid, None)
        if e is None:
            return
        if e.where == "dev":
            self._resident -= e.reserve_pages
        if e.dev_ids is not None:
            self._free_dev.extend(int(i) for i in e.dev_ids)
        if e.host_ids is not None:
            self._free_host_pages.extend(int(i) for i in e.host_ids)
        if e.host_slot is not None:
            self._free_host_slots.append(e.host_slot)
        if e.where == "dev":
            self._ptab[e.slot] = self.null_page
            self._sync_table()


class _Copies:
    """`PagedKVPool._copies`: a batch of page copies. On the card they run
    on the pool's side stream after what the compute stream has queued;
    tensors made on the compute stream for them are kept alive for the
    side stream (`keep`), and the event they complete at becomes the
    pool's `_copied`. On the CPU it does nothing."""

    def __init__(self, pool):
        self.pool = pool
        self.stream = pool._copy_stream

    def keep(self, t) -> None:
        if self.stream is not None:
            t.record_stream(self.stream)

    def __enter__(self):
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.pool.device))
            self._ctx = torch.cuda.stream(self.stream)
            self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        if self.stream is not None:
            ev = torch.cuda.Event()
            ev.record(self.stream)
            self._ctx.__exit__(*exc)
            self.pool._copied = ev
        return False
