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
