"""Paged-KV arena layout.

The serve path stores every pageable cache leaf (full-history attention
k/v and their int8 scale siblings) in one shared page arena instead of
per-slot rows: a slot-layout leaf `[B, Smax, K, D]` becomes
`[device_pages + 1, page_size, K, D]` (stacked leaves keep their leading
layer axis), and an `int32[slots, max_pages]` page table maps each slot's
logical page `j` to an arena row. Token position `p` of slot `b` lives at
`arena[table[b, p // page_size], p % page_size]`.

The arena carries one extra page (`null_page`, id = device_pages): every
free slot's table row points at it, so the decode step's per-token write
always has a valid target — inactive rows write their current value back
into the null page (active slots own disjoint pages, so no two active
writes collide).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

# the dense oracle's (and tests') path from the arena back to slot rows
from repro_torch.kernels.flash_attention.ref import gather_pages  # noqa: F401
from repro_torch.models.layers import ParamDef

# leaves that page along the seq axis (mirrors serve/kvpool.py)
PAGED_LEAF_KEYS = ("k", "v", "k_scale", "v_scale")


@dataclass(frozen=True)
class PageArena:
    """Static sizing of the shared device page arena + per-slot page table."""
    page_size: int       # token-positions per page
    device_pages: int    # usable pages (arena rows 0..device_pages-1)
    slots: int           # page-table rows (= decode slots)
    max_pages: int       # page-table width (= max_len // page_size)

    @property
    def arena_pages(self) -> int:
        """Physical arena rows: the budgeted pages plus the null page."""
        return self.device_pages + 1

    @property
    def null_page(self) -> int:
        """The trash page free slots' table rows point at."""
        return self.device_pages


def paged_write(arena, new_t, table, positions, active, page_size: int):
    """Write each slot's new token row through the page table, IN PLACE.

    arena [P, ps, ...]; new_t [B, 1, ...]; table [B, max_pages] int32;
    positions/active [B]. Active slot b's row lands at
    (table[b, pos // ps], pos % ps); inactive rows write their current
    value back into the null page their table row points at — all
    colliding inactive writes carry the same value, so the scatter is
    deterministic. The JAX package returns a new (donated) arena; here the
    arena tensor itself is updated and returned."""
    b = positions.shape[0]
    pids = table[torch.arange(b, device=table.device),
                 (positions // page_size).long()].long()
    rows = (positions % page_size).long()
    cur = arena[pids, rows]
    val = torch.where(active.reshape((b,) + (1,) * (cur.dim() - 1)),
                      new_t[:, 0].to(arena.dtype), cur)
    arena[pids, rows] = val
    return arena


def page_cache_defs(defs, max_len: int, arena: PageArena):
    """Re-lay a slot-layout cache (tree of ParamDefs) into the arena layout
    `PagedKVPool` builds: every paged leaf's (batch, seq) plane
    `[B, max_len]` becomes `(arena_pages, page_size)` (stacked leaves keep
    their leading layer axis), and — iff anything paged — an int32
    `page_table` leaf joins the tree top-level."""
    found = [False]

    def walk(tree, stacked):
        out = {}
        for key, sub in tree.items():
            st = stacked or key.startswith("stack")
            if isinstance(sub, dict):
                out[key] = walk(sub, st)
                continue
            ba = 1 if st else 0
            shp = tuple(sub.shape)
            if (key in PAGED_LEAF_KEYS and len(shp) > ba + 1
                    and shp[ba + 1] == max_len):
                found[0] = True
                out[key] = ParamDef(
                    shp[:ba] + (arena.arena_pages, arena.page_size) + shp[ba + 2:],
                    sub.axes[:ba] + (None, None) + sub.axes[ba + 2:],
                    init="zeros", dtype=sub.dtype)
            else:
                out[key] = sub
        return out

    out = walk(defs, False)
    if found[0]:
        out["page_table"] = ParamDef((arena.slots, arena.max_pages),
                                     (None, None), init="zeros", dtype="int32")
    return out
