"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch,
as the JAX package's `models/moe.py`.

Dispatch is sort based (no [T, E, C] one-hot): assignments are ranked
within their expert by a stable argsort, overflow beyond the capacity is
dropped (capacity-factor semantics: a token's output depends on every
token routed in the same call, in token order), tokens go into an
[E, C, d] buffer, and the expert products are batched matmuls. FLOPs
scale with T * k * capacity_factor, not with E.

Where the JAX package scatter-adds (the dispatch's `xf[flat_t]` backward,
the combine's `segment_sum` over `flat_t`), the port uses that `flat_t`
is `repeat(arange(T), k)`: the dispatch is an expand of each token to its
k rows and the combine a sum over them, so no sum depends on an atomic's
order and a call gives the same bits every time (resident and streamed
runs, DDL ranks). The combine sums a token's k rows in f32 and rounds
once, where JAX adds them in bf16.

Expert parallelism (a tensor-parallel mesh: the `experts` axis on
`model`, `models/sharding.py`). Each rank holds E / |model| experts' w_gate,
w_up and w_down; the router is replicated. The tokens are replicated over
`model` after the attention block, so no all-to-all is needed: every rank
routes every token (the router in f32, the top-k, the stable-argsort ranks,
the capacity and the drop mask: the same bits on every rank, so the same
`dropped()`), fills its [E / |model|, C, d] buffer with only the rows
routed to its own experts, and sums its own combine rows in f32; the sum
over `model` runs in f32 and is rounded to the layer's dtype once
(`sharding.reduce_from_model`: backward the identity). So the output is
the one-device f32 sum of a token's k rows, added in another order. The
token rows and the combine weights enter the experts' region through
`sharding.copy_to_model` (backward: their grads summed over `model`), so
the replicated router and the layer input get whole grads on every rank;
the aux loss is computed on every rank alike.

`dropped()` counts the assignments the capacity dropped over every call
since `reset_dropped()` (forward passes, recomputes and serve sweeps
alike), without a sync: the count stays on the device until read.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.lms.policies import tag
from repro_torch.models import sharding as shd
from repro_torch.models.layers import ParamDef, gelu

_DROPPED = {}   # device -> int64 count of dropped assignments


def dropped() -> int:
    """Assignments dropped by the capacity since `reset_dropped()`."""
    return int(sum(int(t.item()) for t in _DROPPED.values()))


def reset_dropped() -> None:
    _DROPPED.clear()


def _count_dropped(keep: torch.Tensor) -> None:
    with torch.no_grad():
        n = (~keep).sum()
        acc = _DROPPED.get(keep.device)
        if acc is None:
            _DROPPED[keep.device] = n
        else:
            acc.add_(n)


def moe_defs(cfg):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamDef((d, e), ("d_model", None), dtype="float32"),
        "w_gate": ParamDef((e, d, f), ("experts", "d_model", "ff")),
        "w_up": ParamDef((e, d, f), ("experts", "d_model", "ff")),
        "w_down": ParamDef((e, f, d), ("experts", "ff", "d_model")),
    }


def _capacity(cfg, tokens: int) -> int:
    cap = int(tokens * cfg.experts_per_token * cfg.moe_capacity_factor
              / cfg.num_experts)
    return max(cap, cfg.experts_per_token)


def _act(cfg):
    return F.silu if cfg.mlp_act == "swiglu" else gelu


def _route(cfg, p, xf):
    """-> (probs [T, E] f32, top_w [T, k] renormalised, top_i [T, k])."""
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    top_w, top_i = torch.topk(probs, cfg.experts_per_token, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_i


def apply_moe(cfg, p, x, mesh=None):
    """x [B,S,d] -> ([B,S,d], aux_loss f32 scalar). On a tensor-parallel
    `mesh` the experts are this rank's block (expert parallelism, the
    module docstring)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xf = x.reshape(t, d)
    cap = _capacity(cfg, t)

    probs, top_w, top_i = _route(cfg, p, xf)
    probs = tag(probs, "router_probs")

    # load-balance aux loss (Switch-style)
    me = probs.mean(dim=0)
    ce = F.one_hot(top_i[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(me * ce)

    # rank the assignments within their expert (stable sort; no T*E one-hot)
    flat_e = top_i.reshape(-1)
    flat_w = top_w.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=e)
    offsets = torch.cumsum(counts, 0) - counts
    ranks_sorted = torch.arange(t * k, device=x.device) - offsets[flat_e[order]]
    ranks = torch.empty_like(ranks_sorted).scatter_(0, order, ranks_sorted)
    keep = ranks < cap
    _count_dropped(keep)

    # this rank's experts [lo, lo + el): all of them without expert
    # parallelism; another rank's rows weigh nothing here
    mesh = shd.tp(mesh)
    el = p["w_gate"].shape[0]
    lo = 0 if mesh is None else mesh.index(shd.MODEL) * el
    take = keep if mesh is None else keep & (flat_e >= lo) & (flat_e < lo + el)
    local_e = flat_e if mesh is None else torch.clamp(flat_e - lo, 0, el - 1)
    xd = shd.copy_to_model(xf, mesh)

    # each token's k rows into the [E, C, d] buffer; a dropped row (or
    # another rank's) goes to slot C - 1 with a zero contribution, as
    # JAX's mode="drop" add
    safe_rank = torch.where(keep, ranks, cap - 1)
    contrib = xd[:, None, :].expand(t, k, d).reshape(t * k, d) * take[:, None].to(x.dtype)
    buf = torch.zeros((el, cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((local_e, safe_rank), contrib, accumulate=True)

    # expert FFN (gated)
    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    h = tag(_act(cfg)(g) * u, "moe_hidden")
    out_e = torch.bmm(h, p["w_down"])                     # [E, C, d]

    # combine back: each token's k rows weighted, summed in f32 (this
    # rank's rows, then over `model` in f32), rounded once
    w = (shd.copy_to_model(flat_w, mesh) * take)[:, None].to(x.dtype)
    picked = out_e[local_e, safe_rank] * w
    y = shd.reduce_from_model(picked.float().view(t, k, d).sum(dim=1), mesh).to(x.dtype)
    return y.reshape(b, s, d), aux


def apply_moe_dense_fallback(cfg, p, x):
    """Every expert on every token (the oracle for tests; E/k x the FLOPs)."""
    b, s, d = x.shape
    e = cfg.num_experts
    xf = x.reshape(-1, d)
    _, top_w, top_i = _route(cfg, p, xf)
    g = torch.einsum("td,edf->tef", xf, p["w_gate"])
    u = torch.einsum("td,edf->tef", xf, p["w_up"])
    h = _act(cfg)(g) * u
    out_e = torch.einsum("tef,efd->ted", h, p["w_down"])
    w_full = torch.zeros((xf.shape[0], e), dtype=torch.float32, device=x.device)
    w_full = w_full.scatter(1, top_i, top_w)
    y = torch.einsum("te,ted->td", w_full.to(x.dtype), out_e)
    return y.reshape(b, s, d)
