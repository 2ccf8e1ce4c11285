"""The unstacked rest of the params (the embedding table, the final norm
and the LM head) where a plan that streams params puts it: in pinned host
memory, beside the stack (`train/steps.py` `_host_classes`). The model reads
it from there:

* the embedding lookup gathers the batch's rows on the host and copies
  only those rows to the card;
* the final norm and the head come in whole, on the LMS side stream
  (`core/lms/offload.py`), when the logits need them; with no sink
  taking its grad (serving, or autograd off) a head larger than the
  window the plan prices for streamed params (two sweeps' layers in
  flight: `window`) comes in a vocab slice at a time, each slice whole
  blocks of `layers.head_block` entries, the products a resident head
  takes without grads (`layers.lm_logits`);
* a tied embedding reads one leaf for both uses;
* on a tensor-parallel mesh each of the table and the head is this
  rank's vocab shard: the lookup gathers this rank's rows (`layers.
  local_ids`) and sums them over `model`, the head gives this rank's
  logit columns, and the sinks take the grads of the local rows and
  columns.

With grads, each of these device copies carries autograd through a
function whose backward hands the leaf's grad to `sink(path, grad)`, so
the host leaf itself is never differentiated (its grad would be a host
tensor of its size) and a copy lives only until its backward has run. The
embedding's grad goes to the sink in its rows' form (`RowsGrad`: the
tokens and their rows' grads), whose dense form is the one autograd makes
for `table[tokens]` (a zero table with the rows' grads accumulated by
`index_put_`), and any range of which forms only its own rows, bitwise
the same elements; an untied head's in its factors' form (`HeadGrad`: the
rows and the logits' grads), whose blocks of rows are the GEMM autograd
makes with another M. zero1 reduces the table and the head a slice at a
time from these, so neither dense grad stands whole.
"""
from __future__ import annotations

import torch

from repro_torch.core.lms import offload as off
from repro_torch.models import sharding as shd
from repro_torch.models.layers import (apply_norm, head_block, lm_logits, local_ids,
                                       vocab_parallel_rows)

EMBED = ("embed", "embedding")
HEAD = ("embed", "lm_head")


def on_host(stream) -> bool:
    """The rest lies in pinned host memory: the plan streams params."""
    return stream is not None and stream.streams_params


def window(cfg, stream):
    """Bytes of streamed params the plan prices on the device: the layers
    of two sweeps' worth of prefetch (a serve plan: 2 layers of one sweep;
    a train plan: 4, forward and backward); None for a schedule that does
    not price its params."""
    priced = stream.bytes_for("params")
    return 2 * priced // max(cfg.num_layers, 1) if priced else None


class _Sunk(torch.autograd.Function):
    """The device copy `box[0]` of the host leaf `host`, with autograd
    attached: the backward hands `wrap(grad)` to `sink(key, ...)`."""

    @staticmethod
    def forward(ctx, host, box, sink, key, wrap):
        ctx.sink, ctx.key, ctx.wrap = sink, key, wrap
        return box[0].detach()

    @staticmethod
    def backward(ctx, g):
        ctx.sink(ctx.key, ctx.wrap(g))
        return None, None, None, None, None


def _same(g):
    return g


class RowsGrad:
    """The grad of a [V, d] table read at `tokens`, in its rows' form: the
    grads `rows` [..., d] of the rows read. `dense()` is autograd's grad of
    `table[tokens]`; `flat_range(a, b)` is elements a:b of its flattened
    form, made from the rows that fall there alone. Both accumulate each
    row's grads in the tokens' order (`index_put_`'s), so they agree
    bitwise."""

    def __init__(self, shape, tokens, rows):
        self.shape, self.tokens, self.rows = tuple(shape), tokens, rows
        self.device = rows.device

    def _table(self, lo: int, hi: int) -> torch.Tensor:
        """Rows lo:hi of the dense grad."""
        out = torch.zeros((hi - lo,) + self.shape[1:], dtype=self.rows.dtype,
                          device=self.device)
        if lo == 0 and hi == self.shape[0]:
            return out.index_put_((self.tokens,), self.rows, accumulate=True)
        keep = (self.tokens >= lo) & (self.tokens < hi)
        return out.index_put_(((self.tokens[keep] - lo),), self.rows[keep], accumulate=True)

    def dense(self) -> torch.Tensor:
        return self._table(0, self.shape[0])

    def flat_range(self, a: int, b: int) -> torch.Tensor:
        d = self.shape[1]
        lo, hi = a // d, -(-b // d)
        return self._table(lo, hi).reshape(-1)[a - lo * d:b - lo * d]


# rows of the head's grad one GEMM of `HeadGrad` forms: a multiple of the
# tensor cores' tile, so every block starts 16-byte aligned
HEAD_ROWS = 128


class HeadGrad:
    """The grad of a [d, V] head read as `x @ head` (x [..., d]), in its
    factors' form: the rows `x` and the logits' grads `g` [..., V]. Rows
    lo:hi of the dense grad are x[:, lo:hi]^T . g, the GEMM autograd's mm
    backward makes for the whole head (`x.t().mm(g)` on the folded rows)
    with another M: `rows` forms them in blocks of HEAD_ROWS rows aligned
    to HEAD_ROWS, `flat_range(a, b)` elements a:b of the flattened grad
    from the blocks that hold them, `dense()` the whole, so zero1 reduces
    the head a piece at a time and its [d, V] grad never stands whole."""

    def __init__(self, shape, x, g):
        self.shape = tuple(shape)
        self.x = x.reshape(-1, self.shape[0])
        self.g = g.reshape(-1, self.shape[1])
        self.device = g.device

    def rows(self, lo: int, hi: int) -> torch.Tensor:
        """Rows lo:hi of the dense grad (lo a multiple of HEAD_ROWS)."""
        return self.x[:, lo:hi].t().mm(self.g)

    def dense(self) -> torch.Tensor:
        return self.rows(0, self.shape[0])

    def flat_range(self, a: int, b: int) -> torch.Tensor:
        v, R = self.shape[1], HEAD_ROWS
        lo = a // v // R * R
        hi = min(-(-b // (v * R)) * R, self.shape[0])
        return torch.cat([self.rows(r, min(r + HEAD_ROWS, hi)).reshape(-1)
                          for r in range(lo, hi, HEAD_ROWS)])[a - lo * v:b - lo * v]


def head_input_grad(g, head) -> torch.Tensor:
    """The grad of x in `x @ head` from the logits' grads g [..., V]: the
    GEMM autograd's mm backward makes (`g.mm(head.t())` on the folded
    rows)."""
    return g.reshape(-1, head.shape[1]).mm(head.t()).reshape(g.shape[:-1] + (head.shape[0],))


def dense(g):
    """A rest leaf's grad as a tensor."""
    return g.dense() if isinstance(g, (RowsGrad, HeadGrad)) else g


def _to_device(t, device) -> torch.Tensor:
    return off.stream_layer_to_device(t, device, cls="params").wait()


def _host_rows(table, tokens, host_tokens) -> torch.Tensor:
    """The table's rows at `tokens`, gathered on the host (pinned where the
    card is) at `host_tokens`, the same ids on the host where the caller
    holds them (no round trip through the card), else a copy of `tokens`."""
    rows = table[tokens.cpu() if host_tokens is None else host_tokens]
    return rows.pin_memory() if tokens.device.type == "cuda" else rows


def _hands_back(sink) -> bool:
    """The copies' grads go to `sink`: there is one and autograd is on."""
    return sink is not None and torch.is_grad_enabled()


def embed(cfg, p, tokens, sink=None, host_tokens=None, mesh=None):
    """`layers.embed_tokens` with the table in host memory: its rows at
    `tokens` copied in, cast to bf16 on the device (on a tensor-parallel
    `mesh`, this rank's rows, zeros where another rank holds the token,
    summed over `model`)."""
    table = p["embedding"]
    ok = None
    if shd.tp(mesh) is not None:
        tokens, ok = local_ids(cfg, tokens, mesh)
        host_tokens = None if host_tokens is None else local_ids(cfg, host_tokens, mesh)[0]
    rows = _to_device(_host_rows(table, tokens, host_tokens), tokens.device)
    if _hands_back(sink):
        shape = tuple(table.shape)
        rows = _Sunk.apply(table, (rows,), sink, EMBED,
                           lambda g: RowsGrad(shape, tokens, g))
    if ok is not None:
        return vocab_parallel_rows(rows, ok, mesh)
    return rows.to(torch.bfloat16)


class _SunkHead(torch.autograd.Function):
    """`x @ box[0]`, the device copy of the host head `host`: the backward
    returns x's grad and hands the head's in its factors' form
    (`HeadGrad`) to `sink(key, ...)`."""

    @staticmethod
    def forward(ctx, x, host, box, sink, key):
        ctx.sink, ctx.key, ctx.shape = sink, key, tuple(host.shape)
        w = box[0]
        ctx.save_for_backward(x, w)
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        ctx.sink(ctx.key, HeadGrad(ctx.shape, x, g))
        return head_input_grad(g, w), None, None, None, None


def _leaf(t, device, sink, key):
    dev = _to_device(t, device)
    if _hands_back(sink):
        return _Sunk.apply(t, (dev,), sink, key, _same)
    return dev


def final_norm(cfg, p, x, sink=None):
    """`apply_norm` of the final norm, its leaves copied in."""
    dev = {k: _leaf(v, x.device, sink, ("final_norm", k)) for k, v in p.items()}
    return apply_norm(cfg, dev, x)


def _slices(n: int, nbytes: int, room, block: int):
    """[(a, b)] covering range(n) in pieces of as many whole blocks of
    `block` entries as fit in room bytes, at least one (one piece when it
    all fits, or room is None)."""
    if room is None or nbytes <= room:
        return [(0, n)]
    step = max(room // (nbytes * block // n), 1) * block
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def logits(cfg, p, x, room, sink=None, mesh=None):
    """`layers.lm_logits` with the head (or the tied table) in host
    memory: copied in whole, or, when no grad goes back to `sink` and it
    is larger than `room` bytes, a vocab slice at a time, each slice's
    logits written into the [..., V] output. On a tensor-parallel `mesh`
    the head is this rank's vocab shard and x enters its column-parallel
    region (`sharding.copy_to_model`)."""
    x = shd.copy_to_model(x, mesh)
    key = EMBED if cfg.tie_embeddings else HEAD
    w = p["embedding"] if cfg.tie_embeddings else p["lm_head"]
    vocab = w.shape[0] if cfg.tie_embeddings else w.shape[1]
    parts = _slices(vocab, w.numel() * w.element_size(), room, head_block(cfg))
    if _hands_back(sink) and not cfg.tie_embeddings:
        return _SunkHead.apply(x, w, (_to_device(w, x.device),), sink, key)
    if len(parts) == 1 or _hands_back(sink):
        dev = _leaf(w, x.device, sink, key)
        return _head(cfg, dev, x)
    out = None
    for a, b in parts:
        piece = w[a:b] if cfg.tie_embeddings else _columns(w, a, b, x.device)
        y = _head(cfg, _to_device(piece, x.device), x)
        if out is None:
            out = torch.empty(y.shape[:-1] + (vocab,), dtype=y.dtype, device=y.device)
        out[..., a:b] = y
        del y
    return out


def _columns(w, a: int, b: int, device) -> torch.Tensor:
    """Columns a:b of a host [d, V] head, contiguous (pinned where the card
    is), for the copy in."""
    cols = w[:, a:b].contiguous()
    return cols.pin_memory() if torch.device(device).type == "cuda" else cols


def _head(cfg, w, x):
    """`lm_logits` of a device head (or tied table) `w`."""
    return lm_logits(cfg, {"embedding" if cfg.tie_embeddings else "lm_head": w}, x)
