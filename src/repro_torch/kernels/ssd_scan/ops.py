"""`ssd_scan` dispatch: CPU tensors take the plain version, CUDA tensors
the hand-written kernel (csrc/ssd_scan.cu), which replaces the JAX
package's `ssd_scan_fwd` Pallas kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import on_cpu, require
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

MAX_HEAD_DIM = 64     # csrc kMaxP
MAX_STATE = 128       # csrc kMaxN
MAX_CHUNK = 4096      # dt and cum of a chunk sit in the block's shared memory


def ssd_scan(x, dt, A, B, C, *, chunk: int = 256):
    """x [b,l,h,p]; dt [b,l,h] f32; A [h] f32; B, C [b,l,g,n] -> y
    [b,l,h,p] in x's dtype (no final state, as `ssd_scan_fwd`)."""
    if on_cpu(x, dt, A, B, C):
        return ssd_scan_ref(x, dt, A, B, C, chunk=chunk)[0]
    return ssd_scan_cuda(x, dt, A, B, C, chunk=chunk)


def ssd_scan_cuda(x, dt, A, B, C, *, chunk: int = 256):
    """Launch the CUDA kernel. x bf16/f32 with p <= 64; dt and A f32; B and
    C of x's dtype with n <= 128 and h a multiple of g. x, dt, B and C may
    be strided views (the kernel reads them through their strides) as long
    as their last dimension is contiguous; A is made contiguous."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C)):
        raise RuntimeError("the SSD scan kernel has no backward (nor has the JAX "
                           "package's); take gradients through ssd_impl='ref'")
    dev = x.device
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)} and B {tuple(B.shape)} must be 4-d")
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    for t, name, dtypes, shape in (
            (x, "x", (torch.bfloat16, torch.float32), (b, l, h, p)),
            (dt, "dt", (torch.float32,), (b, l, h)),
            (A, "A", (torch.float32,), (h,)),
            (B, "B", (x.dtype,), (b, l, g, n)),
            (C, "C", (x.dtype,), (b, l, g, n))):
        require(t, name, dtypes=dtypes, device=dev, shape=shape, strided=True)
    if g == 0 or h % g:
        raise ValueError(f"heads={h} must be a multiple of groups={g}")
    if not (0 < p <= MAX_HEAD_DIM and 0 < n <= MAX_STATE):
        raise ValueError(f"head_dim={p} must be in 1..{MAX_HEAD_DIM} and state={n} "
                         f"in 1..{MAX_STATE}")
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk={chunk} must be in 1..{MAX_CHUNK}")
    y = torch.empty((b, l, h, p), dtype=x.dtype, device=dev)
    if b == 0 or l == 0 or h == 0:
        return y
    # launches on the current stream, raises if the launch failed
    _build.extension().ssd_scan(x, dt, A.contiguous(), B, C, y, chunk)
    ssd_scan_cuda.launches += 1
    return y


# launches of the CUDA kernel; a run resets it to 0 and reads it back
ssd_scan_cuda.launches = 0
