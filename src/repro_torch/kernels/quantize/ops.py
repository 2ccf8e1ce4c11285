"""`quantize` and `dequantize` dispatch: CPU tensors take the plain
versions, CUDA tensors the hand-written kernels (csrc/quantize.cu), which
replace the JAX package's `quantize_fwd` and `dequantize_fwd` Pallas
kernels."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import on_cpu, require
from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_ref


def quantize(x):
    """x [rows, cols] float -> (q int8 [rows, cols], scale f32 [rows])."""
    if on_cpu(x):
        return quantize_ref(x)
    return quantize_cuda(x)


def quantize_cuda(x):
    """Launch the CUDA kernel on x (bf16 or f32, contiguous, on the card)."""
    require(x, "x", dtypes=(torch.float32, torch.bfloat16), ndim=2,
            device=x.device)
    rows, cols = x.shape
    q = torch.empty((rows, cols), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if cols == 0:
        raise ValueError("quantize needs at least one column")
    if rows == 0:
        return q, scale
    # launches on the current stream, raises if the launch failed
    _build.extension().quantize_rows(x, q, scale)
    quantize_cuda.launches += 1
    return q, scale


# launches of the CUDA kernel; a run resets it to 0 and reads it back
quantize_cuda.launches = 0


def dequantize(q, scale, out_dtype=torch.float32):
    """q int8 [rows, cols], scale f32 [rows] -> q * scale[row] in out_dtype
    (f32 or bf16)."""
    if on_cpu(q, scale):
        return dequantize_ref(q, scale, out_dtype)
    return dequantize_cuda(q, scale, out_dtype)


def dequantize_cuda(q, scale, out_dtype=torch.float32):
    """Launch the CUDA kernel on q (int8) and scale (f32), contiguous, on
    the card."""
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
    _build.extension().dequantize_rows(q, scale, out)
    dequantize_cuda.launches += 1
    return out


dequantize_cuda.launches = 0
