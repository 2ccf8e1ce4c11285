"""Common layers: param declaration, RMSNorm and Mamba-2's gated RMSNorm,
the SwiGLU MLP, RoPE, embedding, head and the cross-entropy loss.

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


def init_array(d: ParamDef, generator: torch.Generator, device) -> torch.Tensor:
    out = None
    for i, piece in init_pieces(d, generator, device):
        if i is ...:
            return piece
        if out is None:
            out = torch.empty(d.shape, dtype=piece.dtype, device=device)
        out[i] = piece
    return out


def tree_init(defs, generator: torch.Generator, device):
    """defs: nested dict of ParamDef -> same-structure dict of tensors."""
    return tree_map(lambda d: init_array(d, generator, device), defs)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_defs(cfg, dim: int, logical: str = "d_model"):
    if cfg.norm_type == "rmsnorm":
        return {"scale": ParamDef((dim,), (logical,), init="ones", dtype="float32")}
    raise NotImplementedError(f"norm_type {cfg.norm_type!r} is not ported yet")


def apply_norm(cfg, p, x, eps=None):
    """RMSNorm in f32, cast back to x's dtype: the RMSNorm kernel on a CUDA
    tensor, its plain version on a CPU one."""
    return rms_ops.rmsnorm(x, p["scale"], eps=eps or cfg.norm_eps)


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
    if cfg.mlp_act != "swiglu" or cfg.use_bias:
        raise NotImplementedError(
            f"mlp_act={cfg.mlp_act!r} use_bias={cfg.use_bias} is not ported yet")
    return {"w_gate": ParamDef((d, f), ("d_model", "ff")),
            "w_up": ParamDef((d, f), ("d_model", "ff")),
            "w_down": ParamDef((f, d), ("ff", "d_model"), scale=scale_out)}


def _swiglu(g, u):
    return F.silu(g) * u


def apply_mlp(cfg, p, x):
    # tag the projection outputs: remat otherwise re-runs both matmuls
    g = tagged("mlp_hidden", torch.matmul, x, p["w_gate"])
    u = tagged("mlp_hidden", torch.matmul, x, p["w_up"])
    h = tagged("mlp_hidden", _swiglu, g, u)
    return h @ p["w_down"]


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


def embed_tokens(cfg, p, tokens):
    # the JAX package casts the whole f32 table to bf16 and then takes rows;
    # taking the rows first and casting them is the same elementwise cast
    # without writing a bf16 copy of the table every step
    return p["embedding"][tokens].to(torch.bfloat16)


def lm_logits(cfg, p, x):
    if cfg.tie_embeddings:
        w = p["embedding"].to(torch.bfloat16).T
    else:
        w = p["lm_head"]
    return x @ w


def cross_entropy(logits, labels, ignore_id: int = -1):
    """Mean token CE in f32; labels == ignore_id are masked (and clipped to
    0 for the gather, as the JAX package takes them)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    mask = (labels != ignore_id).float()
    loss = (lse - ll) * mask
    return loss.sum() / torch.clamp(mask.sum(), min=1.0)
