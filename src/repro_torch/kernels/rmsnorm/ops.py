"""`rmsnorm` dispatch: CPU tensors take the plain version under ordinary
autograd; CUDA tensors go through an autograd Function whose forward
launches the hand-written kernel (csrc/rmsnorm.cu), which replaces the JAX
package's `rmsnorm_fwd` Pallas kernel. Its backward is the plain analytic
gradient: the JAX package has no backward kernel for it either (XLA
differentiates the plain jnp)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import on_cpu, require
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref


# the row-in-registers path (csrc/rmsnorm.cu): a row is held by W warps of a
# block of 8, each lane at most MAX_VECTORS 16-byte vectors
WARPS_PER_ROW = (1, 2, 4, 8)
MAX_VECTORS = 20


def rmsnorm_layout(d: int, element_size: int, aligned: bool):
    """How the kernel reads a row of d elements of `element_size` bytes:
    -> (W, vectors a lane) for the row-in-registers path, the fewest warps
    W whose lanes hold the row in at most MAX_VECTORS 16-byte vectors; or
    None for the element path, where the row is not a whole number of
    vectors, a pointer is not 16-byte aligned (`aligned` False) or the row
    is wider than 8 warps hold."""
    if not aligned or (d * element_size) % 16:
        return None
    nvec = d * element_size // 16
    for w in WARPS_PER_ROW:
        v = -(-nvec // (32 * w))
        if v <= MAX_VECTORS:
            return w, v
    return None


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """x [..., d] bf16/f32, scale [d] f32 -> [..., d] in x's dtype; viewed
    as [-1, d] rows, as the JAX op does."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if on_cpu(x2, scale):
        return rmsnorm_ref(x2, scale, eps=eps).reshape(shape)
    return _RMSNorm.apply(x2.contiguous(), scale, eps).reshape(shape)


class _RMSNorm(torch.autograd.Function):
    """The kernel's forward with the plain gradient. It saves only its
    inputs, so a checkpointed layer's recompute, which runs the forward
    again, leaves nothing stale behind."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_cuda(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd_ref(x, scale, dy, eps=ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                dscale if ctx.needs_input_grad[1] else None, None)


def rmsnorm_cuda(x, scale, *, eps: float = 1e-6):
    """Launch the CUDA kernel: x [rows, d] bf16/f32 and scale [d] f32, both
    contiguous on one card -> [rows, d] in x's dtype. The path is
    `rmsnorm_layout`'s."""
    dev = x.device
    require(x, "x", dtypes=(torch.bfloat16, torch.float32), ndim=2, device=dev)
    rows, d = x.shape
    require(scale, "scale", dtypes=(torch.float32,), shape=(d,), device=dev)
    if d == 0:
        raise ValueError("rmsnorm needs at least one column")
    if dev.type != "cuda":
        raise ValueError(f"rmsnorm_cuda takes tensors on the card, got {dev}")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    layout = rmsnorm_layout(d, x.element_size(),
                            all(t.data_ptr() % 16 == 0 for t in (x, scale, out)))
    # launches on the current stream, raises if the launch failed
    _build.extension().rmsnorm(x, scale, out, float(eps), layout[0] if layout else 0)
    if layout:
        rmsnorm_cuda.register_launches += 1
    else:
        rmsnorm_cuda.element_launches += 1
    rmsnorm_cuda.launches += 1
    return out


# launches of the CUDA kernel (`launches`, and by path: a row held in
# registers, or element by element); a run resets them to 0 and reads them
rmsnorm_cuda.launches = 0
rmsnorm_cuda.register_launches = 0
rmsnorm_cuda.element_launches = 0
