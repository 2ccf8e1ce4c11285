"""GQA attention: parameter defs, the naive and blockwise implementations,
causal and local-window masking, and the decode paths. Layouts are the JAX
package's: q [B,S,H,D], k/v [B,S,K,D], weights wq [d,H,D], wo [H,D,d].
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.lms.policies import tagged
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                     flash_decode_ref)
from repro_torch.models import sharding as shd
from repro_torch.models.layers import ParamDef

NEG_INF = -1e30


def attention_defs(cfg):
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale_out = 0.02 / math.sqrt(2 * cfg.num_layers)
    bias = cfg.qkv_bias or cfg.use_bias
    defs = {
        "wq": ParamDef((d, h, hd), ("d_model", "heads", "head_dim")),
        "wk": ParamDef((d, k, hd), ("d_model", "kv_heads", "head_dim")),
        "wv": ParamDef((d, k, hd), ("d_model", "kv_heads", "head_dim")),
        "wo": ParamDef((h, hd, d), ("heads", "head_dim", "d_model"), scale=scale_out),
    }
    if bias:
        defs["bq"] = ParamDef((h, hd), ("heads", "head_dim"), init="zeros")
        defs["bk"] = ParamDef((k, hd), ("kv_heads", "head_dim"), init="zeros")
        defs["bv"] = ParamDef((k, hd), ("kv_heads", "head_dim"), init="zeros")
    if cfg.use_bias:
        defs["bo"] = ParamDef((d,), ("d_model",), init="zeros")
    return defs


def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(x.shape[:-1] + (h, k))


def _proj_bias(x, w, b=None):
    y = _proj(x, w)
    return y if b is None else y + b


def project_qkv(cfg, p, x, mesh=None):
    """-> q [B,S,H,D], k/v [B,S,K,D], each tagged "qkv": saving them spares
    the backward the projection matmuls under remat. On a tensor-parallel
    `mesh` the projections are column-parallel: H and K are this rank's
    heads (H / |model|, K / |model|; G = H / K is unchanged)."""
    x = shd.copy_to_model(x, mesh)
    q = tagged("qkv", _proj_bias, x, p["wq"], p.get("bq"))
    k = tagged("qkv", _proj_bias, x, p["wk"], p.get("bk"))
    v = tagged("qkv", _proj_bias, x, p["wv"], p.get("bv"))
    return q, k, v


def out_proj(cfg, p, o, mesh=None):
    """o [..., H, D] -> [..., d]; row-parallel on a tensor-parallel `mesh`:
    the partial products of this rank's heads are summed over `model`
    before `bo` is added."""
    h, hd, d = p["wo"].shape
    out = o.reshape(o.shape[:-2] + (h * hd,)) @ p["wo"].reshape(h * hd, d)
    out = shd.reduce_from_model(out, mesh)
    if "bo" in p:
        out = out + p["bo"]
    return out


# ---------------------------------------------------------------------------
# Naive oracle (tests, chunked prefill)
# ---------------------------------------------------------------------------

def _mask(sq: int, skv: int, device, *, causal: bool, window: int,
          q_offset, kv_len=None):
    mask = attention_mask(sq, skv, device, causal=causal, window=window,
                          q_offset=q_offset)
    if kv_len is not None:
        mask &= torch.arange(skv, device=device)[None, :] < kv_len
    return mask


def naive_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset=0, kv_len: Optional[int] = None):
    """q [B,Sq,H,D], k/v [B,Skv,K,D]. Scores in the inputs' dtype, then an
    f32 softmax whose probabilities are cast back to v's dtype — the JAX
    package's rounding points."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, d).permute(0, 2, 3, 1, 4)        # [B,K,G,Sq,D]
    kt = k.permute(0, 2, 3, 1)[:, :, None]                         # [B,K,1,D,Skv]
    scores = (qg @ kt).float() / math.sqrt(d)                      # [B,K,G,Sq,Skv]
    mask = _mask(sq, k.shape[1], q.device, causal=causal, window=window,
                 q_offset=q_offset, kv_len=kv_len)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    o = probs @ v.permute(0, 2, 1, 3)[:, :, None]                  # [B,K,G,Sq,D]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)


# ---------------------------------------------------------------------------
# Blockwise (online softmax over KV chunks)
# ---------------------------------------------------------------------------

def blockwise_attention(q, k, v, *, causal: bool, window: int = 0,
                        chunk: int = 512, q_offset: int = 0):
    """Online softmax over KV chunks; O(Sq·chunk) live memory. Matches
    naive_attention to f32-accumulation tolerance."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    skv = k.shape[1]
    chunk = min(chunk, skv)
    qg = (q.reshape(b, sq, kh, g, d).permute(0, 2, 3, 1, 4).float()
          / math.sqrt(d))                                          # [B,K,G,Sq,D]
    m = torch.full((b, kh, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, kh, g, sq), device=q.device)
    acc = torch.zeros((b, kh, g, sq, d), device=q.device)
    for lo in range(0, skv, chunk):
        kb = k[:, lo:lo + chunk].float().permute(0, 2, 3, 1)[:, :, None]
        vb = v[:, lo:lo + chunk].float().permute(0, 2, 1, 3)[:, :, None]
        s = qg @ kb                                                # [B,K,G,Sq,c]
        mask = _mask(sq, kb.shape[-1], q.device, causal=causal,
                     window=window, q_offset=q_offset - lo)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vb
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode (one new token against a cache)
# ---------------------------------------------------------------------------

def dense_decode_attention(q, k_cache, v_cache, kv_len, *, k_scale=None,
                           v_scale=None):
    """Dense decode oracle: q [B,1,H,D]; caches [B,Smax,K,D]; kv_len scalar
    or [B]. k_scale/v_scale [B,Smax,K] iff the caches hold int8 codes."""
    o = flash_decode_ref(q[:, 0], k_cache, v_cache, kv_len,
                         k_scale=k_scale, v_scale=v_scale)
    return o[:, None]


def decode_attention(q, k_cache, v_cache, kv_len, *, window: int = 0,
                     k_scale=None, v_scale=None, page_table=None):
    """Decode-attention entry (the serve hot path): q [B,1,H,D]; kv_len
    scalar or [B] valid positions per slot (ring caches of a window too:
    validity is positional recency). Without a table the caches are
    slot-contiguous [B,Smax,K,D]. page_table [B,max_pages] int32: the
    caches (and scales) are a shared page arena [P,page_size,K,D] and slot
    b's position p lives at (page_table[b, p // page_size], p % page_size).

    The flash-decode kernels on the card (paged with a table, contiguous
    without), their plain versions on the CPU."""
    if page_table is not None:
        if window:
            raise ValueError("the page arena carries no window rings")
        return fa_ops.flash_decode_paged(q, k_cache, v_cache, kv_len,
                                         page_table, k_scale=k_scale,
                                         v_scale=v_scale)
    return fa_ops.flash_decode(q, k_cache, v_cache, kv_len,
                               k_scale=k_scale, v_scale=v_scale)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def attention(q, k, v, *, causal: bool = True, window: int = 0,
              impl: str = "blockwise", chunk: int = 512, q_offset: int = 0):
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    if impl == "blockwise":
        if window:
            raise NotImplementedError("local-window attention is not ported yet")
        return blockwise_attention(q, k, v, causal=causal, chunk=chunk,
                                   q_offset=q_offset)
    if impl == "pallas":
        # the flash-attention kernel on the card, its plain version on the CPU
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset)
    raise ValueError(impl)
