"""`quantize` dispatch: CPU tensors take the plain version, CUDA tensors
the hand-written kernel (csrc/quantize.cu), which replaces the JAX
package's `quantize_fwd` Pallas kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import on_cpu, require
from repro_torch.kernels.quantize.ref import quantize_ref


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
