"""Attention kernel dispatch: CPU tensors take the plain versions, CUDA
tensors the hand-written kernels, which replace the JAX package's Pallas
kernels:

- `flash_attention` — `flash_attention_fwd`, the whole-prompt prefill, by
  two routes: bf16 at head_dim 64, 128 or 256 on the tensor cores
  (csrc/flash_attention_wgmma.cu), everything else on the CUDA cores
  (csrc/flash_attention_fwd.cu);
- `flash_decode` (csrc/flash_decode.cu, slot-contiguous caches) —
  `flash_decode_fwd`, the static loop's decode and slot decode without a
  page arena;
- `flash_decode_paged` (csrc/flash_decode.cu, page arena) —
  `flash_decode_paged_fwd`, the serve engine's decode.

Both decode entries have two routes: bf16 q at head_dim 64, 128 or 256
with at most 16 query heads per kv head on the tensor cores, split over
the card (`decode_splits`), everything else on the CUDA cores.

Every `*_cuda` launcher counts its launches in `.launches`;
`flash_attention_cuda` also counts each route's, in `.wgmma_launches` and
`.cuda_core_launches`, and the decode launchers in `.tensor_core_launches`
and `.cuda_core_launches`.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import on_cpu, require
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     flash_decode_paged_ref,
                                                     flash_decode_ref)

MAX_GROUP = 8     # query heads per kv head of the CUDA-core decode (csrc kMaxG)
MAX_HEAD_DIM = 256   # largest head_dim the prefill kernel takes (csrc kMaxD)
WGMMA_HEAD_DIMS = (64, 128, 256)   # head_dims of the tensor-core routes (bf16)
MMA_MAX_GROUP = 16   # query heads per kv head of the tensor-core decode: one m16 tile
DECODE_TILE = 64     # kv positions a tensor-core decode block takes at a time (csrc kTile)
DECODE_BLOCKS_PER_SM = 4    # blocks of (slot, kv head, split) the splits aim for
DECODE_MIN_SPLIT_TILES = 4  # tiles a split takes at least, so its ring fills


def _kv_len_vector(kv_len, b: int, device) -> torch.Tensor:
    """A scalar or [B] kv_len as a contiguous [B] int32 tensor on `device`,
    as `decode_kernel.py` broadcasts it."""
    if isinstance(kv_len, torch.Tensor):
        return kv_len.to(device=device, dtype=torch.int32).reshape(-1).expand(b).contiguous()
    return torch.full((b,), int(kv_len), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset=None):
    """Prefill attention in the model layout: q [B,S,H,D], k/v [B,Skv,K,D]
    -> [B,S,H,D]. q_offset: absolute kv position of query row 0 (None: the
    end of kv when causal, else 0). A query row with no visible key returns
    the mean of v over all Skv keys of its kv head, as the JAX package's
    oracle `flash_attention_ref` does. (Its Pallas kernel masks the padded
    kv positions of a ragged Skv too, so there it returns Skv / (nk *
    block_k) times that mean.)"""
    if on_cpu(q, k, v):
        o = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window, q_offset=q_offset)
        return o.transpose(1, 2)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         q_offset=None):
    """Launch a CUDA kernel on the model layout (no transposes): q
    [B,S,H,D] bf16/f32, k/v [B,Skv,K,D] of q's dtype, all contiguous on one
    card; H a multiple of K; D a multiple of 32, at most 256.

    The route goes by dtype and D: bf16 with D in WGMMA_HEAD_DIMS (the
    head widths of the repo's configs) takes the tensor-core kernel
    (csrc/flash_attention_wgmma.cu: wgmma fed by TMA, P rounded to bf16
    for the P.V product); f32, or bf16 at another D, the CUDA-core kernel
    (csrc/flash_attention_fwd.cu, all f32), since bf16 operands cannot hold
    an f32 result to 1e-5. Neither falls back to the other: a failed build
    or launch raises. Neither has a backward (nor has the JAX kernel): it
    raises when autograd would need one."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the flash-attention kernel has no backward (nor has the JAX "
                           "package's); take gradients through attn_impl='blockwise'")
    dev = q.device
    require(q, "q", dtypes=(torch.bfloat16, torch.float32), ndim=4, device=dev)
    require(k, "k", dtypes=(q.dtype,), ndim=4, device=dev)
    require(v, "v", dtypes=(q.dtype,), ndim=4, device=dev)
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if kh == 0 or h % kh:
        raise ValueError(f"H={h} must be a multiple of K={kh}")
    if d % 32 or d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim={d} must be a multiple of 32, at most "
                         f"{MAX_HEAD_DIM}")
    if window < 0:
        raise ValueError(f"window={window} must be >= 0")
    if q_offset is None:
        q_offset = skv - sq if causal else 0
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if skv == 0:
        return out.zero_()
    args = (q, k, v, out, bool(causal), int(window), int(q_offset), 1.0 / math.sqrt(d))
    # launches on the current stream, raises if the launch failed
    if q.dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        _build.extension().flash_attention_wgmma(*args)
        flash_attention_cuda.wgmma_launches += 1
    else:
        _build.extension().flash_attention(*args)
        flash_attention_cuda.cuda_core_launches += 1
    flash_attention_cuda.launches += 1
    return out


# ---------------------------------------------------------------------------
# Decode: routes, splits, checks
# ---------------------------------------------------------------------------

def decode_splits(b: int, kh: int, capacity: int, sm_count: int) -> tuple[int, int]:
    """-> (splits, chunk): how the tensor-core decode cuts each slot's
    positions [0, capacity) over the card. Split s takes [s * chunk,
    (s + 1) * chunk): chunk is whole DECODE_TILEs and the splits cover the
    capacity exactly (splits * chunk >= capacity > (splits - 1) * chunk).
    From host-known sizes only (B, K, the cache's capacity, the SM count),
    never from kv_len: the launch reads no device value. Enough splits for
    DECODE_BLOCKS_PER_SM blocks an SM over the b * kh (slot, kv head)
    pairs, each of at least DECODE_MIN_SPLIT_TILES tiles; one split (and
    no combine launch) where the capacity is that short."""
    tiles = max(1, -(-capacity // DECODE_TILE))
    want = -(-DECODE_BLOCKS_PER_SM * max(1, sm_count) // max(1, b * kh))
    splits = max(1, min(want, tiles // DECODE_MIN_SPLIT_TILES))
    chunk_tiles = -(-tiles // splits)
    return -(-tiles // chunk_tiles), chunk_tiles * DECODE_TILE


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_route(q_dtype, d: int, group: int) -> str:
    """The decode route by dtype and shape alone: bf16 q at head_dim 64,
    128 or 256 with at most MMA_MAX_GROUP query heads per kv head takes the
    tensor cores ("tensor_core"), anything else the CUDA cores
    ("cuda_core"), which take f32 or bf16 q, at most MAX_GROUP query heads
    per kv head and a head_dim that is a multiple of 32, at most 1024."""
    if q_dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS and group <= MMA_MAX_GROUP:
        return "tensor_core"
    return "cuda_core"


def _check_decode(q, k, v, kv_len, k_scale, v_scale, scale_shape):
    """The checks both decode launchers share; -> (B, H, K, D, route)."""
    dev = q.device
    require(q, "q", dtypes=(torch.bfloat16, torch.float32), ndim=3, device=dev)
    quantized = k_scale is not None
    kv_types = (torch.int8,) if quantized else (q.dtype,)
    require(k, "k", dtypes=kv_types, ndim=4, device=dev)
    require(v, "v", dtypes=kv_types, ndim=4, device=dev)
    require(kv_len, "kv_len", dtypes=(torch.int32,), ndim=1, device=dev)
    b, h, d = q.shape
    kh = k.shape[2]
    if v.shape != k.shape or k.shape[3] != d:
        raise ValueError(f"cache shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if quantized or v_scale is not None:
        if not quantized or v_scale is None:
            raise ValueError("int8 caches need both k_scale and v_scale")
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            require(s, name, dtypes=(torch.float32,), ndim=3, device=dev)
            if s.shape != scale_shape:
                raise ValueError(f"{name} has shape {tuple(s.shape)}, "
                                 f"expected {scale_shape}")
    if kh == 0 or h % kh:
        raise ValueError(f"H={h} must be a multiple of K={kh}")
    route = decode_route(q.dtype, d, h // kh)
    if route == "tensor_core":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    elif h // kh > MAX_GROUP:
        # bf16 at a tensor-core head_dim got here with G > MMA_MAX_GROUP
        limit = MMA_MAX_GROUP if q.dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS else MAX_GROUP
        raise ValueError(f"H={h} must be a multiple of K={kh} with at most "
                         f"{limit} query heads per kv head")
    elif d % 32 or d > 1024:
        raise ValueError(f"head_dim={d} must be a multiple of 32, at most 1024")
    if kv_len.shape != (b,):
        raise ValueError(f"kv_len {tuple(kv_len.shape)} does not match B={b}")
    return b, h, kh, d, route


def _decode_scratch(q, b: int, kh: int, g: int, d: int, capacity: int):
    """-> (chunk, part_ml, part_acc) for the tensor-core decode: the f32
    partials of each split, [B, K, splits, 2, G] (m, l) and [B, K, splits,
    G, D] (acc), or None and None for one split."""
    splits, chunk = decode_splits(b, kh, capacity, _sm_count(q.device))
    if splits == 1:
        return chunk, None, None
    return (chunk, torch.empty((b, kh, splits, 2, g), dtype=torch.float32, device=q.device),
            torch.empty((b, kh, splits, g, d), dtype=torch.float32, device=q.device))


# ---------------------------------------------------------------------------
# Decode against slot-contiguous caches
# ---------------------------------------------------------------------------

def flash_decode(q, k_cache, v_cache, kv_len, *, k_scale=None, v_scale=None):
    """Decode attention: q [B,1,H,D] or [B,H,D]; caches [B,Smax,K,D] (model
    layout); kv_len a scalar or [B] valid positions per slot (0 gives exact
    zeros). k_scale/v_scale [B,Smax,K] f32 iff the caches hold int8 codes.
    Returns q's shape."""
    squeeze = q.dim() == 4
    q3 = q[:, 0] if squeeze else q
    if on_cpu(q3, k_cache, v_cache, k_scale, v_scale):
        o = flash_decode_ref(q3, k_cache, v_cache, kv_len, k_scale=k_scale,
                             v_scale=v_scale)
    else:
        o = flash_decode_cuda(q3.contiguous(), k_cache, v_cache,
                              _kv_len_vector(kv_len, q3.shape[0], q3.device),
                              k_scale=k_scale, v_scale=v_scale)
    return o[:, None] if squeeze else o


def flash_decode_cuda(q, k_cache, v_cache, kv_len, *, k_scale=None,
                      v_scale=None):
    """Launch a CUDA kernel. q [B,H,D] bf16/f32; caches [B,Smax,K,D] of
    q's dtype, or int8 with f32 scales [B,Smax,K]; kv_len [B] int32; all
    contiguous on one card. The kernels read positions < kv_len only.

    The route goes by dtype and shape (`decode_route`): bf16 q at head_dim
    64/128/256 with G = H / K <= 16 takes the tensor-core kernel
    (csrc/flash_decode.cu `fd_mma_kernel`: split over the card by
    `decode_splits`, cp.async rings, QK^T and P.V by mma.sync, then
    `fd_combine_kernel` where there are several splits); anything else the
    CUDA-core kernel (`fd_kernel`, all f32, G <= 8). Neither falls back to
    the other: a failed build or launch raises. No device value is read on
    the host, so a call never synchronises."""
    b, h, kh, d, route = _check_decode(q, k_cache, v_cache, kv_len, k_scale, v_scale,
                                       tuple(k_cache.shape[:3]))
    if k_cache.shape[0] != b:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not match B={b}")
    out = torch.empty_like(q)
    if b == 0:
        return out
    # launches on the current stream, raises if the launch failed
    if route == "tensor_core":
        chunk, part_ml, part_acc = _decode_scratch(q, b, kh, h // kh, d, k_cache.shape[1])
        _build.extension().flash_decode_mma(q, k_cache, v_cache, k_scale, v_scale, kv_len,
                                            out, part_ml, part_acc, chunk, 1.0 / math.sqrt(d))
        flash_decode_cuda.tensor_core_launches += 1
    else:
        _build.extension().flash_decode(q, k_cache, v_cache, k_scale, v_scale,
                                        kv_len, out, 1.0 / math.sqrt(d))
        flash_decode_cuda.cuda_core_launches += 1
    flash_decode_cuda.launches += 1
    return out


# ---------------------------------------------------------------------------
# Decode through a page table
# ---------------------------------------------------------------------------

def flash_decode_paged(q, k_pages, v_pages, kv_len, page_table, *,
                       k_scale=None, v_scale=None):
    """Paged flash decode: q [B,1,H,D] or [B,H,D]; page arenas
    [P,page_size,K,D]; kv_len [B] int32; page_table [B,max_pages] int32
    arena row ids (free slots point at the null page). k_scale/v_scale
    [P,page_size,K] f32 iff the arenas hold int8 codes. Returns q's shape."""
    squeeze = q.dim() == 4
    q3 = q[:, 0] if squeeze else q
    if on_cpu(q3, k_pages, v_pages, kv_len, page_table, k_scale, v_scale):
        o = flash_decode_paged_ref(q3, k_pages, v_pages, kv_len, page_table,
                                   k_scale=k_scale, v_scale=v_scale)
    else:
        o = flash_decode_paged_cuda(q3, k_pages, v_pages, kv_len, page_table,
                                    k_scale=k_scale, v_scale=v_scale)
    return o[:, None] if squeeze else o


def flash_decode_paged_cuda(q, k_pages, v_pages, kv_len, page_table, *,
                            k_scale=None, v_scale=None):
    """Launch a CUDA kernel. q [B,H,D] bf16/f32; arenas [P,ps,K,D] of
    q's dtype, or int8 with f32 scales [P,ps,K]; kv_len [B] int32;
    page_table [B,max_pages] int32; all contiguous on one card. Every
    table entry a slot reads (its first ceil(kv_len/ps)) must be a valid
    arena row: the kernels read positions < kv_len only. Routes as in
    `flash_decode_cuda`, the capacity being max_pages * ps."""
    b, h, kh, d, route = _check_decode(q, k_pages, v_pages, kv_len, k_scale, v_scale,
                                       tuple(k_pages.shape[:3]))
    require(page_table, "page_table", dtypes=(torch.int32,), ndim=2,
            device=q.device)
    if page_table.shape[0] != b:
        raise ValueError(f"page_table {tuple(page_table.shape)} does not "
                         f"match B={b}")
    out = torch.empty_like(q)
    if b == 0:
        return out
    # launches on the current stream, raises if the launch failed
    if route == "tensor_core":
        capacity = page_table.shape[1] * k_pages.shape[1]
        chunk, part_ml, part_acc = _decode_scratch(q, b, kh, h // kh, d, capacity)
        _build.extension().flash_decode_paged_mma(q, k_pages, v_pages, k_scale, v_scale,
                                                  kv_len, page_table, out, part_ml, part_acc,
                                                  chunk, 1.0 / math.sqrt(d))
        flash_decode_paged_cuda.tensor_core_launches += 1
    else:
        _build.extension().flash_decode_paged(q, k_pages, v_pages, k_scale, v_scale,
                                              kv_len, page_table, out, 1.0 / math.sqrt(d))
        flash_decode_paged_cuda.cuda_core_launches += 1
    flash_decode_paged_cuda.launches += 1
    return out


# launches of the CUDA kernels; a run resets them to 0 and reads them back
flash_attention_cuda.launches = 0
flash_attention_cuda.wgmma_launches = 0
flash_attention_cuda.cuda_core_launches = 0
flash_decode_cuda.launches = 0
flash_decode_cuda.tensor_core_launches = 0
flash_decode_cuda.cuda_core_launches = 0
flash_decode_paged_cuda.launches = 0
flash_decode_paged_cuda.tensor_core_launches = 0
flash_decode_paged_cuda.cuda_core_launches = 0
