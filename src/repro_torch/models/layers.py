"""Common layers: param declaration, the norms (RMSNorm, LayerNorm with and
without params, Mamba-2's gated RMSNorm), the MLPs (SwiGLU, GeGLU, GELU,
each with or without biases), RoPE, embedding, head and the cross-entropy
loss.

Params are nested dicts of tensors keyed as in the JAX package. One
declarative source, `ParamDef`, gives each leaf's shape, dtype and init.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.lms.policies import tagged
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models import sharding as shd
from repro_torch.tree import tree_map

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int8": torch.int8, "int32": torch.int32}


# ---------------------------------------------------------------------------
# Param declaration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names, len == len(shape)
    init: str = "normal"              # normal | zeros | ones | ssm_a
    scale: float = 0.02
    dtype: str = "bfloat16"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def init_pieces(d: ParamDef, generator: torch.Generator, device):
    """The leaf's initial values in pieces on `device`, in its dtype:
    yields (index into the leaf, piece). A stacked "normal" leaf is drawn
    one layer slice at a time, so the f32 temporary is one layer's worth,
    not the whole stack's, and a caller may place each slice elsewhere
    (`train/steps.py` puts host-resident layers in pinned memory); any
    other leaf comes whole. The draws are the same whichever way the
    pieces are placed."""
    dt = DTYPES[d.dtype]
    if d.init == "zeros":
        yield ..., torch.zeros(d.shape, dtype=dt, device=device)
    elif d.init == "ones":
        yield ..., torch.ones(d.shape, dtype=dt, device=device)
    elif d.init == "ssm_a":   # A_log: log of uniform [1, 16]
        u = torch.rand(d.shape, generator=generator, dtype=torch.float32,
                       device=device) * 15.0 + 1.0
        yield ..., torch.log(u).to(dt)
    elif d.init != "normal":
        raise ValueError(d.init)
    elif d.axes[:1] == ("layers",):
        for i in range(d.shape[0]):
            yield i, (torch.randn(d.shape[1:], generator=generator, dtype=torch.float32,
                                  device=device) * d.scale).to(dt)
    else:
        yield ..., (torch.randn(d.shape, generator=generator, dtype=torch.float32,
                                device=device) * d.scale).to(dt)


def local_pieces(d: ParamDef, generator: torch.Generator, device, spec=(), mesh=None):
    """`init_pieces` of a global leaf with spec `spec`, each piece cut to
    this rank's block on a tensor-parallel `mesh` (`sharding.local_shard`):
    every rank draws what one device draws, and keeps its block, so runs
    on any mesh start from one global state."""
    for i, piece in init_pieces(d, generator, device):
        yield i, shd.local_shard(piece, spec if i is ... else tuple(spec[1:]), mesh)


def init_array(d: ParamDef, generator: torch.Generator, device, spec=(),
               mesh=None) -> torch.Tensor:
    """The leaf's initial values (this rank's block of them on a
    tensor-parallel `mesh`)."""
    out = None
    for i, piece in local_pieces(d, generator, device, spec, mesh):
        if i is ...:
            return piece.contiguous()
        if out is None:
            out = torch.empty(shd.local_shape(d.shape, spec, mesh), dtype=piece.dtype,
                              device=device)
        out[i] = piece
    return out


def tree_init(defs, generator: torch.Generator, device, mesh=None):
    """defs: nested dict of ParamDef -> same-structure dict of tensors
    (this rank's blocks on a tensor-parallel `mesh`)."""
    if shd.tp(mesh) is None:
        return tree_map(lambda d: init_array(d, generator, device), defs)
    specs = shd.spec_tree(defs, mesh)

    def go(dd, ss):
        if isinstance(dd, dict):
            return {k: go(v, ss[k]) for k, v in dd.items()}
        return init_array(dd, generator, device, ss, mesh)
    return go(defs, specs)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_defs(cfg, dim: int, logical: str = "d_model"):
    if cfg.norm_type == "rmsnorm":
        return {"scale": ParamDef((dim,), (logical,), init="ones", dtype="float32")}
    if cfg.norm_type == "layernorm":
        return {"scale": ParamDef((dim,), (logical,), init="ones", dtype="float32"),
                "bias": ParamDef((dim,), (logical,), init="zeros", dtype="float32")}
    if cfg.norm_type == "layernorm_nonparam":
        return {}
    raise ValueError(cfg.norm_type)


def apply_norm(cfg, p, x, eps=None):
    """The norm in f32, cast back to x's dtype. RMSNorm: the RMSNorm kernel
    on a CUDA tensor, its plain version on a CPU one. LayerNorm (with or
    without scale and bias) is plain torch on either device, as the JAX
    package's is plain jnp: the population variance of the centred row,
    (x - mu) * rsqrt(var + eps), then * scale + bias."""
    eps = eps or cfg.norm_eps
    if cfg.norm_type == "rmsnorm":
        return rms_ops.rmsnorm(x, p["scale"], eps=eps)
    xf = x.float()
    xc = xf - torch.mean(xf, dim=-1, keepdim=True)
    out = xc * torch.rsqrt(torch.mean(xc * xc, dim=-1, keepdim=True) + eps)
    if cfg.norm_type == "layernorm":
        out = out * p["scale"] + p["bias"]
    return out.to(x.dtype)


def gated_rmsnorm(p, x, gate, eps=1e-5):
    """Mamba-2 output norm: RMSNorm(x * silu(gate)), the gate's silu taken
    in f32 and cast to x's dtype before the product, as the JAX package
    rounds it."""
    xf = (x * F.silu(gate.float()).to(x.dtype)).float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_defs(cfg):
    d, f = cfg.d_model, cfg.d_ff
    scale_out = 0.02 / math.sqrt(2 * cfg.num_layers)
    if cfg.mlp_act in ("swiglu", "geglu"):
        defs = {"w_gate": ParamDef((d, f), ("d_model", "ff")),
                "w_up": ParamDef((d, f), ("d_model", "ff")),
                "w_down": ParamDef((f, d), ("ff", "d_model"), scale=scale_out)}
        if cfg.use_bias:
            defs["b_gate"] = ParamDef((f,), ("ff",), init="zeros")
            defs["b_up"] = ParamDef((f,), ("ff",), init="zeros")
            defs["b_down"] = ParamDef((d,), ("d_model",), init="zeros")
    elif cfg.mlp_act == "gelu":
        defs = {"w_up": ParamDef((d, f), ("d_model", "ff")),
                "w_down": ParamDef((f, d), ("ff", "d_model"), scale=scale_out)}
        if cfg.use_bias:
            defs["b_up"] = ParamDef((f,), ("ff",), init="zeros")
            defs["b_down"] = ParamDef((d,), ("d_model",), init="zeros")
    else:
        raise ValueError(cfg.mlp_act)
    return defs


def gelu(x):
    """`jax.nn.gelu`'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _swiglu(g, u):
    return F.silu(g) * u


def _geglu(g, u):
    return gelu(g) * u


def apply_mlp(cfg, p, x, mesh=None):
    """The tags sit where the JAX package's do: each projection's matmul
    output (before its bias), and the hidden after the activation. The
    LMS planner prices 3 tagged values for a gated MLP and 2 for GELU, and
    the layer replay matches regions by position.

    On a tensor-parallel `mesh` the gate and up projections (and their
    biases) are column-parallel on `ff`, the down projection row-parallel:
    its partial products are summed over `model` before `b_down` is added
    (`models/sharding.py`)."""
    x = shd.copy_to_model(x, mesh)
    # tag the projection outputs: remat otherwise re-runs both matmuls
    if cfg.mlp_act in ("swiglu", "geglu"):
        g = tagged("mlp_hidden", torch.matmul, x, p["w_gate"])
        u = tagged("mlp_hidden", torch.matmul, x, p["w_up"])
        if cfg.use_bias:
            g = g + p["b_gate"]
            u = u + p["b_up"]
        h = tagged("mlp_hidden", _swiglu if cfg.mlp_act == "swiglu" else _geglu, g, u)
    else:
        u = tagged("mlp_hidden", torch.matmul, x, p["w_up"])
        if cfg.use_bias:
            u = u + p["b_up"]
        h = tagged("mlp_hidden", gelu, u)
    out = shd.reduce_from_model(h @ p["w_down"], mesh)
    if cfg.use_bias:
        out = out + p["b_down"]
    return out


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """numpy float32, exactly as the JAX package computes it."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [..., S] int (broadcastable).
    Rotate-half layout: the first and second halves of D pair up."""
    d = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(d, theta)).to(x.device)     # [D/2]
    ang = positions[..., None].float() * freqs                      # [..., S, D/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_defs(cfg):
    defs = {"embedding": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "d_model"),
                                  scale=0.02, dtype="float32")}
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size), ("d_model", "vocab"))
    return defs


def local_ids(cfg, tokens, mesh):
    """-> (ids into this rank's vocab rows, clamped to 0 where it holds
    none, and where it holds them) on a tensor-parallel `mesh`."""
    lo, n = shd.vocab_range(cfg.vocab_size, mesh)
    local = tokens - lo
    ok = (local >= 0) & (local < n)
    return torch.where(ok, local, torch.zeros_like(local)), ok


def vocab_parallel_rows(rows, ok, mesh):
    """The embedding rows of a vocab-parallel lookup: this rank's rows
    where it holds the token, zeros elsewhere, cast to bf16 and summed
    over `model` (one term is not zero: the sum is exact)."""
    rows = torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))
    return shd.reduce_from_model(rows.to(torch.bfloat16), mesh)


def embed_tokens(cfg, p, tokens, mesh=None):
    # the JAX package casts the whole f32 table to bf16 and then takes rows;
    # taking the rows first and casting them is the same elementwise cast
    # without writing a bf16 copy of the table every step
    if shd.tp(mesh) is None:
        return p["embedding"][tokens].to(torch.bfloat16)
    ids, ok = local_ids(cfg, tokens, mesh)
    return vocab_parallel_rows(p["embedding"][ids], ok, mesh)


def head_block(cfg) -> int:
    """Vocab entries of the head one product takes where no grad flows: as
    many as one layer's share of the params' bf16 bytes holds, a multiple
    of 128 (a plan that streams params holds two such shares on the
    device, so a streamed head comes in whole blocks: `models/rest.py`)."""
    share = 2 * cfg.param_count() // max(cfg.num_layers, 1)
    return max(share // (2 * cfg.d_model) // 128 * 128, 128)


def lm_logits(cfg, p, x, mesh=None):
    """x [..., d] -> logits [..., V]. Without autograd a head of more than
    `head_block(cfg)` entries is taken a block at a time, each block's
    product written into the output, so a resident head and one streamed
    in vocab slices run the same products and give the same logits. On a
    tensor-parallel `mesh` the head (or the tied table) is this rank's
    vocab shard, a column-parallel region: the logits are this rank's
    [..., V / |model|] columns."""
    x = shd.copy_to_model(x, mesh)
    if cfg.tie_embeddings:
        # the table cast to bf16, as the JAX package casts it; rows of another
        # type promote the product as jnp promotes it (f32 rows: an f32 product)
        dt = torch.promote_types(x.dtype, torch.bfloat16)
        x, w = x.to(dt), p["embedding"].to(torch.bfloat16).to(dt).T
    else:
        w = p["lm_head"]
    vocab, block = w.shape[1], head_block(cfg)
    if torch.is_grad_enabled() or vocab <= block:
        return x @ w
    out = torch.empty(x.shape[:-1] + (vocab,), dtype=torch.promote_types(x.dtype, w.dtype),
                      device=x.device)
    for a in range(0, vocab, block):
        out[..., a:a + block] = x @ w[:, a:a + block]
    return out


# token rows of the loss's f32 terms at once (`cross_entropy`)
LOSS_BLOCK = 1024


class _BlockedNLL(torch.autograd.Function):
    """Per-row negative log-likelihood lse(row) - row[label] in f32 of
    logits [T, V], a block of `block` rows at a time: the forward saves the
    logits (the head's output, live anyway) and the [T] f32 log-sum-exp;
    the backward writes softmax minus one-hot, times each row's grad, into
    a grad of the logits' dtype, a block at a time. So at most one block's
    f32 [block, V] terms stand at once (two in the forward's log-sum-exp),
    where autograd of the plain form keeps f32 copies of the whole [T, V].
    Each row's value and grad are the plain form's ops on that row: the
    log-sum-exp over the whole row, and the grad's f32 terms summed in the
    order autograd sums them (the log-sum-exp's, then the gather's)."""

    @staticmethod
    def forward(ctx, logits, labels, block):
        t = logits.shape[0]
        lse = torch.empty(t, dtype=torch.float32, device=logits.device)
        for a in range(0, t, block):
            lse[a:a + block] = torch.logsumexp(logits[a:a + block].float(), dim=-1)
        idx = labels.clamp(min=0).long()
        ll = torch.gather(logits, -1, idx[:, None])[:, 0].float()
        ctx.save_for_backward(logits, idx, lse)
        ctx.block = block
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        logits, idx, lse = ctx.saved_tensors
        grad = torch.empty_like(logits)
        for a in range(0, logits.shape[0], ctx.block):
            b = min(a + ctx.block, logits.shape[0])
            z = logits[a:b].to(torch.float32, copy=True)
            z.sub_(lse[a:b, None]).exp_().mul_(g[a:b, None])
            rows = torch.arange(b - a, device=z.device)
            z[rows, idx[a:b]] += -g[a:b]
            grad[a:b] = z
            del z
        return grad, None, None


class _VocabParallelNLL(torch.autograd.Function):
    """`_BlockedNLL` of logits [T, V / |model|], this rank's vocab columns
    on a tensor-parallel `mesh`: each rank takes its columns' log-sum-exp
    and the label's logit where it owns the label (0 elsewhere), a block of
    rows at a time; one all-gather over `model` brings every rank's [2, T]
    pair, and each rank forms the row's log-sum-exp over the ranks' and
    the label's logit (the sum) from them in rank order, so every rank
    holds the same [T] losses. The backward is local: softmax over the
    global log-sum-exp minus the one-hot of the labels this rank owns,
    times each row's grad, a block at a time into the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, labels, block, mesh):
        t, v = logits.shape
        lse = torch.empty(t, dtype=torch.float32, device=logits.device)
        for a in range(0, t, block):
            lse[a:a + block] = torch.logsumexp(logits[a:a + block].float(), dim=-1)
        lo = mesh.index(shd.MODEL) * v
        local = labels.clamp(min=0).long() - lo
        ok = (local >= 0) & (local < v)
        idx = torch.where(ok, local, torch.zeros_like(local))
        ll = torch.gather(logits, -1, idx[:, None])[:, 0].float()
        ll = torch.where(ok, ll, torch.zeros_like(ll))
        got = mesh.all_gather(torch.stack([lse, ll])[None], shd.MODEL)   # [M, 2, T]
        lse = torch.logsumexp(got[:, 0], dim=0)
        ctx.save_for_backward(logits, idx, ok, lse)
        ctx.block = block
        return lse - got[:, 1].sum(dim=0)

    @staticmethod
    def backward(ctx, g):
        logits, idx, ok, lse = ctx.saved_tensors
        grad = torch.empty_like(logits)
        for a in range(0, logits.shape[0], ctx.block):
            b = min(a + ctx.block, logits.shape[0])
            z = logits[a:b].to(torch.float32, copy=True)
            z.sub_(lse[a:b, None]).exp_().mul_(g[a:b, None])
            own = ok[a:b]
            rows = torch.arange(b - a, device=z.device)[own]
            z[rows, idx[a:b][own]] += -g[a:b][own]
            grad[a:b] = z
            del z
        return grad, None, None, None


def cross_entropy(logits, labels, ignore_id: int = -1, mesh=None):
    """Mean token CE in f32; labels == ignore_id are masked (and clipped to
    0 for the gather, as the JAX package takes them). Each row's
    log-sum-exp is taken whole over the vocabulary, LOSS_BLOCK rows at a
    time, and the backward forms the logits' grad a block at a time
    (`_BlockedNLL`): the loss's working set is the logits, their grad and
    one block's f32 terms (`core/lms/planner.loss_work_bytes`). On a
    tensor-parallel `mesh` the logits are this rank's vocab columns and
    the loss is the full vocabulary's (`_VocabParallelNLL`), the same on
    every rank."""
    v = logits.shape[-1]
    if shd.tp(mesh) is None:
        nll = _BlockedNLL.apply(logits.reshape(-1, v), labels.reshape(-1), LOSS_BLOCK)
    else:
        nll = _VocabParallelNLL.apply(logits.reshape(-1, v), labels.reshape(-1),
                                      LOSS_BLOCK, mesh)
    mask = (labels.reshape(-1) != ignore_id).float()
    loss = nll * mask
    return loss.sum() / torch.clamp(mask.sum(), min=1.0)
