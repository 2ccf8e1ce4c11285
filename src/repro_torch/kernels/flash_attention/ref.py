"""Plain PyTorch versions of the attention kernels: the CPU path and the
versions the CUDA kernels are held against. GQA by head grouping: query
head h reads kv head h // G, G = H // K.
"""
import math

import torch

NEG_INF = -1e30


def attention_mask(sq: int, skv: int, device, *, causal: bool, window: int,
                   q_offset: int):
    """[Sq, Skv] bool: key t is visible to query row i at absolute position
    i + q_offset (causal: t <= pos; window: t > pos - window)."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset=None):
    """Prefill attention in the kernel layout: q [B,H,Sq,D], k/v [B,K,Skv,D]
    -> [B,H,Sq,D] in q's dtype. q_offset: absolute kv position of query row
    0; None aligns the queries to the end of kv when causal (Skv - Sq), 0
    otherwise. Scores, probabilities and the accumulation are f32 and the
    output is cast once, as in the JAX oracle.

    A query row with no visible key returns the mean of v over all Skv keys
    of its kv head, as the JAX package's oracle `flash_attention_ref` does:
    the masked scores are a finite -1e30, so the softmax of such a row is
    uniform. Its Pallas kernel agrees where Skv is a multiple of its
    block_k; otherwise it masks the padded keys of the last block with
    -1e30 too and returns Skv / (nk * block_k) times that mean. The model's
    prefill (causal, q_offset 0, Sq == Skv) never makes such a row."""
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    g = h // kh
    if q_offset is None:
        q_offset = skv - sq if causal else 0
    qg = q.reshape(b, kh, g, sq, d).float() / math.sqrt(d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float())
    mask = attention_mask(sq, skv, q.device, causal=causal, window=window,
                          q_offset=q_offset)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)


def flash_decode_ref(q, k_cache, v_cache, kv_len, *, k_scale=None,
                     v_scale=None):
    """Dense decode attention. q [B,H,D]; caches [B,Smax,K,D] (model
    layout: seq before heads); kv_len [B] (or a scalar). k_scale/v_scale
    [B,Smax,K] iff the caches hold int8 codes. Rows with kv_len == 0 return
    exact zeros, as the kernel does (its softmax sum stays 0)."""
    b, h, d = q.shape
    smax, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    kf = k_cache.float()
    vf = v_cache.float()
    if k_scale is not None:
        kf = kf * k_scale[..., None].float()
        vf = vf * v_scale[..., None].float()
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32,
                             device=q.device).reshape(-1).expand(b)
    qg = q.reshape(b, kh, g, d).float() / math.sqrt(d)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kf)
    mask = torch.arange(smax, device=q.device)[None, :] < kv_len[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, vf)
    o = torch.where((kv_len > 0)[:, None, None, None], o, torch.zeros_like(o))
    return o.reshape(b, h, d).to(q.dtype)


def gather_pages(arena, table):
    """arena [P,ps,...] + table [B,max_pages] -> [B, max_pages*ps, ...]."""
    g = arena[table.long()]
    b, mp, ps = g.shape[:3]
    return g.reshape((b, mp * ps) + tuple(g.shape[3:]))


def flash_decode_paged_ref(q, k_pages, v_pages, kv_len, page_table, *,
                           k_scale=None, v_scale=None):
    """Paged decode attention: gathers each slot's pages through the table
    back into the slot-contiguous layout and runs `flash_decode_ref`.
    q [B,H,D]; arenas [P,page_size,K,D]; page_table [B,max_pages];
    k_scale/v_scale [P,page_size,K] iff the arenas hold int8 codes."""
    kf = gather_pages(k_pages, page_table)
    vf = gather_pages(v_pages, page_table)
    ks = vs = None
    if k_scale is not None:
        ks = gather_pages(k_scale, page_table)
        vs = gather_pages(v_scale, page_table)
    return flash_decode_ref(q, kf, vf, kv_len, k_scale=ks, v_scale=vs)


def flash_decode_split_ref(q, k_cache, v_cache, kv_len, splits: int, *,
                           chunk=None, k_scale=None, v_scale=None,
                           page_table=None):
    """A plain model of the tensor-core decode's split and combine, for the
    tests (never on a path): split s takes positions [s * chunk, (s + 1) *
    chunk) of each slot (chunk defaults to ceil(capacity / splits); the
    splits must cover the capacity) and yields its partial (m, l, acc): the
    max score, the sum of exp(score - m) and its weighted sum of v, with m
    = -1e30, l = 0, acc = 0 for a split that holds no position < kv_len.
    The partials combine with log-sum-exp weights exp(m_s - M), M = max_s
    m_s, into acc / max(l, 1e-30): exact zeros where kv_len == 0. Same
    arguments as `flash_decode_ref` (caches [B,Smax,K,D]), or with
    `page_table` those of `flash_decode_paged_ref` (page arenas)."""
    if page_table is not None:
        k_cache, v_cache = gather_pages(k_cache, page_table), gather_pages(v_cache, page_table)
        if k_scale is not None:
            k_scale = gather_pages(k_scale, page_table)
            v_scale = gather_pages(v_scale, page_table)
    b, h, d = q.shape
    smax, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    chunk = chunk or max(1, -(-smax // splits))
    if splits * chunk < smax:
        raise ValueError(f"{splits} splits of {chunk} do not cover {smax} positions")
    kf, vf = k_cache.float(), v_cache.float()
    if k_scale is not None:
        kf = kf * k_scale[..., None].float()
        vf = vf * v_scale[..., None].float()
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32,
                             device=q.device).reshape(-1).expand(b)
    qg = q.reshape(b, kh, g, d).float() / math.sqrt(d)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kf)
    # pad the positions to splits x chunk, masked
    pad = splits * chunk - smax
    s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
    vf = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, pad))
    pos = torch.arange(splits * chunk, device=q.device)
    valid = (pos[None, :] < kv_len[:, None])[:, None, None, :]       # [B,1,1,T]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    s = s.reshape(b, kh, g, splits, chunk)
    valid = valid.reshape(b, 1, 1, splits, chunk)
    m = s.amax(dim=-1)                                                # [B,K,G,S]
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgsc,bsckd->bkgsd", p, vf.reshape(b, splits, chunk, kh, d))
    big = m.amax(dim=-1, keepdim=True)                                # M
    w = torch.exp(m - big)
    o = (acc * w[..., None]).sum(dim=-2) / torch.clamp((l * w).sum(dim=-1), min=1e-30)[..., None]
    return o.reshape(b, h, d).to(q.dtype)
