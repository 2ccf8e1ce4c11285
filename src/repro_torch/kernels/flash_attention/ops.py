"""`flash_decode_paged` dispatch: CPU tensors take the plain version, CUDA
tensors the hand-written kernel (csrc/flash_decode_paged.cu), which
replaces the JAX package's `flash_decode_paged_fwd` Pallas kernel."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import on_cpu, require
from repro_torch.kernels.flash_attention.ref import flash_decode_paged_ref

MAX_GROUP = 8   # query heads per kv head one block holds (csrc kMaxG)


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
    """Launch the CUDA kernel. q [B,H,D] bf16/f32; arenas [P,ps,K,D] of
    q's dtype, or int8 with f32 scales [P,ps,K]; kv_len [B] int32;
    page_table [B,max_pages] int32; all contiguous on one card. Every
    table entry a slot reads (its first ceil(kv_len/ps)) must be a valid
    arena row: the kernel reads positions < kv_len only."""
    dev = q.device
    require(q, "q", dtypes=(torch.bfloat16, torch.float32), ndim=3, device=dev)
    quantized = k_scale is not None
    kv_types = (torch.int8,) if quantized else (q.dtype,)
    require(k_pages, "k_pages", dtypes=kv_types, ndim=4, device=dev)
    require(v_pages, "v_pages", dtypes=kv_types, ndim=4, device=dev)
    require(kv_len, "kv_len", dtypes=(torch.int32,), ndim=1, device=dev)
    require(page_table, "page_table", dtypes=(torch.int32,), ndim=2, device=dev)
    b, h, d = q.shape
    pages, ps, kh, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d:
        raise ValueError(f"arena shapes {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not match q {tuple(q.shape)}")
    if quantized:
        if v_scale is None:
            raise ValueError("int8 arenas need both k_scale and v_scale")
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            require(s, name, dtypes=(torch.float32,), ndim=3, device=dev)
            if s.shape != (pages, ps, kh):
                raise ValueError(f"{name} has shape {tuple(s.shape)}, "
                                 f"expected {(pages, ps, kh)}")
    if h % kh or h // kh > MAX_GROUP:
        raise ValueError(f"H={h} must be a multiple of K={kh} with at most "
                         f"{MAX_GROUP} query heads per kv head")
    if d % 32 or d > 1024:
        raise ValueError(f"head_dim={d} must be a multiple of 32, at most 1024")
    if kv_len.shape != (b,) or page_table.shape[0] != b:
        raise ValueError(f"kv_len {tuple(kv_len.shape)} / page_table "
                         f"{tuple(page_table.shape)} do not match B={b}")
    out = torch.empty_like(q)
    if b == 0:
        return out
    # launches on the current stream, raises if the launch failed
    _build.extension().flash_decode_paged(q, k_pages, v_pages, k_scale, v_scale,
                                          kv_len, page_table, out, 1.0 / math.sqrt(d))
    flash_decode_paged_cuda.launches += 1
    return out


# launches of the CUDA kernel; a run resets it to 0 and reads it back
flash_decode_paged_cuda.launches = 0
