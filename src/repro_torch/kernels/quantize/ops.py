"""int8 quantize and dequantize dispatch: CPU tensors take the plain
versions, CUDA tensors the hand-written kernels (csrc/quantize.cu), which
replace the JAX package's `quantize_fwd` and `dequantize_fwd` Pallas
kernels. Besides the two row entries, `quantize_kv_write` fuses the
decode step's quantize with its cache write, and `dequantize_sum_rows`
the pod hop's dequantize with its sum over pods: one launch each."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import on_cpu, require
from repro_torch.kernels.quantize.ref import (dequantize_ref, dequantize_sum_rows_ref,
                                              quantize_kv_write_ref, quantize_ref)

# the quantizer's row-in-registers path (csrc/quantize.cu): a row is held by
# a group of lanes, each at most MAX_VECTORS 16-byte vectors
MAX_VECTORS = 8


def _pow2_at_least(n: int) -> int:
    return 1 << (n - 1).bit_length()


def quantize_layout(cols: int, element_size: int, aligned: bool):
    """How the quantizer holds a row of `cols` elements of `element_size`
    bytes: -> (lanes L, vectors V a lane) for the row-in-registers path,
    the fewest lanes (a power of two <= 32) that hold the row's 16-byte
    vectors one a lane, or 32 lanes and the fewest V in 1, 2, 4, 8; or None
    for the element path, where the row is no whole number of vectors, a
    pointer or stride is not 16-byte aligned (`aligned` False) or the row
    is wider than 32 lanes x 8 vectors."""
    if not aligned or (cols * element_size) % 16:
        return None
    nvec = cols * element_size // 16
    lanes = min(32, _pow2_at_least(nvec))
    vectors = _pow2_at_least(-(-nvec // lanes))
    return (lanes, vectors) if vectors <= MAX_VECTORS else None


def dequantize_layout(cols: int, aligned: bool) -> bool:
    """True iff the dequantizers take the vector path (a warp a row, 4
    codes a lane a store): rows of a multiple of 4 codes on 16-byte aligned
    codes and output; else an element a thread."""
    return aligned and cols % 4 == 0


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _count(launcher, vector: bool) -> None:
    launcher.launches += 1
    if vector:
        launcher.vector_launches += 1
    else:
        launcher.element_launches += 1


def _counters(launcher) -> None:
    """Launches of a CUDA kernel (`launches`, and by path: `vector_launches`,
    `element_launches`); a run resets them to 0 and reads them back."""
    launcher.launches = launcher.vector_launches = launcher.element_launches = 0


def quantize(x):
    """x [rows, cols] float -> (q int8 [rows, cols], scale f32 [rows])."""
    if on_cpu(x):
        return quantize_ref(x)
    return quantize_cuda(x)


def quantize_cuda(x):
    """Launch the CUDA kernel on x (bf16 or f32, contiguous, on the card).
    The path is `quantize_layout`'s."""
    require(x, "x", dtypes=(torch.float32, torch.bfloat16), ndim=2,
            device=x.device)
    rows, cols = x.shape
    q = torch.empty((rows, cols), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if cols == 0:
        raise ValueError("quantize needs at least one column")
    if rows == 0:
        return q, scale
    layout = quantize_layout(cols, x.element_size(), _aligned(x, q))
    # launches on the current stream, raises if the launch failed
    _build.extension().quantize_rows(x, q, scale, *(layout or (0, 0)))
    _count(quantize_cuda, layout is not None)
    return q, scale


_counters(quantize_cuda)


def quantize_kv_write(k, v, k_codes, v_codes, k_scale, v_scale, page_table, positions,
                      active):
    """The decode step's int8 cache write, IN PLACE: k, v [B, 1, K, D]
    quantized by rows, and each active slot's codes and scales written into
    k_codes/v_codes [P, ps, K, D] int8 and k_scale/v_scale [P, ps, K] f32
    at its position `positions` [B] int32: through `page_table` [B,
    max_pages] int32, or with None (slot-contiguous caches, P = B, ps =
    Smax) at min(pos, Smax - 1) of its slot. `active` [B] bool; an inactive
    slot's cache rows keep their bytes. -> None."""
    args = (k, v, k_codes, v_codes, k_scale, v_scale, page_table, positions, active)
    if on_cpu(*args):
        return quantize_kv_write_ref(*args)
    return quantize_kv_write_cuda(*args)


def quantize_kv_write_cuda(k, v, k_codes, v_codes, k_scale, v_scale, page_table, positions,
                           active):
    """Launch the fused kernel: k and v (bf16 or f32, one dtype) read
    through their strides (the last dimension contiguous), the caches
    contiguous, all on one card. Reads no value of positions, active or the
    table on the host (no sync). The path is `quantize_layout`'s at width
    D, with strides and every pointer aligned."""
    dev = k.device
    require(k, "k", dtypes=(torch.float32, torch.bfloat16), ndim=4, device=dev, strided=True)
    b, one, kh, d = k.shape
    if one != 1:
        raise ValueError(f"k holds one token a slot, got shape {tuple(k.shape)}")
    require(v, "v", dtypes=(k.dtype,), shape=k.shape, device=dev, strided=True)
    require(k_codes, "k_codes", dtypes=(torch.int8,), ndim=4, device=dev)
    pages, ps = k_codes.shape[:2]
    if tuple(k_codes.shape[2:]) != (kh, d):
        raise ValueError(f"k_codes has shape {tuple(k_codes.shape)}, expected [P, ps, {kh}, {d}]")
    require(v_codes, "v_codes", dtypes=(torch.int8,), shape=k_codes.shape, device=dev)
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        require(s, name, dtypes=(torch.float32,), shape=k_codes.shape[:3], device=dev)
    if page_table is None:
        if pages != b:
            raise ValueError(f"slot-contiguous caches hold one page a slot: {pages} for {b}")
    else:
        require(page_table, "page_table", dtypes=(torch.int32,), ndim=2, device=dev)
        if page_table.shape[0] != b:
            raise ValueError(f"page_table has {page_table.shape[0]} rows for {b} slots")
    require(positions, "positions", dtypes=(torch.int32,), shape=(b,), device=dev)
    require(active, "active", dtypes=(torch.bool,), shape=(b,), device=dev)
    if d == 0:
        raise ValueError("quantize_kv_write needs at least one column")
    if b == 0 or kh == 0:
        return None
    vec = 16 // k.element_size()
    aligned = (_aligned(k, v, k_codes, v_codes)
               and all(t.stride(i) % vec == 0 for t in (k, v) for i in (0, 2)))
    layout = quantize_layout(d, k.element_size(), aligned)
    _build.extension().quantize_kv_write(k, v, k_codes, v_codes, k_scale, v_scale, page_table,
                                         positions, active, *(layout or (0, 0)))
    _count(quantize_kv_write_cuda, layout is not None)
    return None


_counters(quantize_kv_write_cuda)


def dequantize(q, scale, out_dtype=torch.float32):
    """q int8 [rows, cols], scale f32 [rows] -> q * scale[row] in out_dtype
    (f32 or bf16)."""
    if on_cpu(q, scale):
        return dequantize_ref(q, scale, out_dtype)
    return dequantize_cuda(q, scale, out_dtype)


def dequantize_cuda(q, scale, out_dtype=torch.float32):
    """Launch the CUDA kernel on q (int8) and scale (f32), contiguous, on
    the card. The path is `dequantize_layout`'s."""
    require(q, "q", dtypes=(torch.int8,), ndim=2, device=q.device)
    rows, cols = q.shape
    require(scale, "scale", dtypes=(torch.float32,), shape=(rows,), device=q.device)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dequantize writes f32 or bf16, not {out_dtype}")
    out = torch.empty((rows, cols), dtype=out_dtype, device=q.device)
    if cols == 0:
        raise ValueError("dequantize needs at least one column")
    if rows == 0:
        return out
    vector = dequantize_layout(cols, _aligned(q, out))
    _build.extension().dequantize_rows(q, scale, out, vector)
    _count(dequantize_cuda, vector)
    return out


_counters(dequantize_cuda)


def dequantize_sum_rows(q, scale, n: int):
    """q int8 [pods, rows, cols], scale f32 [pods, rows] -> f32 [n]: the
    sum over pods, in pod order from +0, of each pod's dequantize, flat,
    first n elements (n <= rows * cols)."""
    if on_cpu(q, scale):
        return dequantize_sum_rows_ref(q, scale, n)
    return dequantize_sum_rows_cuda(q, scale, n)


def dequantize_sum_rows_cuda(q, scale, n: int):
    """Launch the CUDA kernel on q (int8) and scale (f32), contiguous, on
    the card: one pass over every pod's codes. The path is
    `dequantize_layout`'s."""
    require(q, "q", dtypes=(torch.int8,), ndim=3, device=q.device)
    pods, rows, cols = q.shape
    require(scale, "scale", dtypes=(torch.float32,), shape=(pods, rows), device=q.device)
    if cols == 0 or pods == 0:
        raise ValueError("dequantize_sum_rows needs at least one pod and one column")
    if not 0 <= n <= rows * cols:
        raise ValueError(f"n = {n} is not within the {rows * cols} elements of a pod")
    out = torch.empty((n,), dtype=torch.float32, device=q.device)
    if n == 0:
        return out
    vector = dequantize_layout(cols, _aligned(q, out))
    _build.extension().dequantize_sum_rows(q, scale, out, vector)
    _count(dequantize_sum_rows_cuda, vector)
    return out


_counters(dequantize_sum_rows_cuda)
