"""Plain PyTorch symmetric per-row int8 quantizer and dequantizer: the CPU
path and the versions the CUDA kernels are held against."""
import numpy as np
import torch

# 1/127 rounded to f32. The scale is amax times this constant, not amax / 127:
# XLA rewrites a division by a constant into a multiplication by its f32
# reciprocal, so this is what the JAX package computes (to the bit) when
# its quantizer runs under jit; the CUDA kernel uses the same constant.
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_ref(x):
    """x [rows, cols] float -> (q int8 [rows, cols], scale f32 [rows]).
    Non-finite rows as `jax.jit(quantize_ref)` of the JAX package gives: the
    amax keeps a NaN, so a row holding one gets scale 1; a NaN quotient (a
    NaN element, or an infinity over an infinite scale) gets code 0. The
    cast of a NaN to int8 is undefined in C++, so that 0 is explicit."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax * INV_127, torch.ones_like(amax))
    r = torch.clamp(torch.round(xf / scale[:, None]), -127, 127)
    q = torch.where(torch.isnan(r), torch.zeros_like(r), r).to(torch.int8)
    return q, scale


def dequantize_ref(q, scale, out_dtype=torch.float32):
    """q int8 [rows, cols], scale f32 [rows] -> q * scale[row] in out_dtype:
    one f32 multiply an element, then the cast (round to nearest even)."""
    return (q.float() * scale[:, None]).to(out_dtype)


def quantize_kv_write_ref(k, v, k_codes, v_codes, k_scale, v_scale, page_table, positions,
                          active):
    """The decode step's int8 cache write, IN PLACE, as the slot decode step
    composes it from plain ops: k and v [B, 1, K, D] quantized row by row
    (`quantize_ref` of their [B * K, D] rows), then codes and scales written
    into the caches (codes [P, ps, K, D] int8, scales [P, ps, K] f32) at
    slot b's position pos = positions[b]: through `page_table` [B,
    max_pages] at (table[b, pos // ps], pos % ps), as `models.paging.
    paged_write`; with no table (slot-contiguous caches, P = B, ps = Smax)
    at (b, min(pos, ps - 1)), as `models.transformer._slot_write`. Each
    write gathers the current rows, takes the new ones where `active` [B]
    and scatters them back, so an inactive slot's rows keep their bytes."""
    b = positions.shape[0]
    ps = k_codes.shape[1]
    slots = torch.arange(b, device=positions.device)
    if page_table is None:
        pages, rows = slots, torch.clamp(positions, max=ps - 1).long()
    else:
        pages = page_table[slots, (positions // ps).long()].long()
        rows = (positions % ps).long()
    for x, codes, scale in ((k, k_codes, k_scale), (v, v_codes, v_scale)):
        q, s = quantize_ref(x.reshape(-1, x.shape[-1]))
        for cache, new in ((scale, s.reshape(b, -1)),
                           (codes, q.reshape((b,) + tuple(codes.shape[2:])))):
            cur = cache[pages, rows]
            keep = active.reshape((b,) + (1,) * (cur.dim() - 1))
            cache[pages, rows] = torch.where(keep, new, cur)


def dequantize_sum_rows_ref(q, scale, n: int):
    """q int8 [pods, rows, cols], scale f32 [pods, rows] -> f32 [n]: each
    pod's dequantize, flat and cut to its first n elements, summed in pod
    order from an f32 zero (the pod hop's loop: each product rounded to f32,
    then each add)."""
    total = torch.zeros(n, dtype=torch.float32, device=q.device)
    for i in range(q.shape[0]):
        total = total + dequantize_ref(q[i], scale[i]).reshape(-1)[:n]
    return total
