"""`ssd_scan` dispatch: CPU tensors take the plain version, CUDA tensors
one of the two hand-written routes that replace the JAX package's
`ssd_scan_fwd` Pallas kernel: the chunk-parallel scan on the tensor cores
(csrc/ssd_scan_mma.cu: bf16 x with head_dim and state multiples of 16,
head_dim <= 64, state <= 128, chunks up to 2048 rows, 16-byte aligned
rows) or the CUDA-core kernel (csrc/ssd_scan.cu: f32, and every other
shape). Either returns the final state too where asked (`final_state`),
as the JAX package's plain `ssd_scan_ref` does and its kernel does not."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import on_cpu, require
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

MAX_HEAD_DIM = 64     # csrc kMaxP
MAX_STATE = 128       # csrc kMaxN
MAX_CHUNK = 4096      # dt and cum of a chunk sit in the block's shared memory
MAX_TC_CHUNK = 2048   # the tensor-core route's: beside four tiles of C, B and x


def ssd_route(x, B, C, chunk: int = 256) -> str:
    """The route a CUDA call takes: "tensor_core" for bf16 x with p and n
    multiples of 16 (p <= 64, n <= 128), min(chunk, l) <= MAX_TC_CHUNK,
    and x, B and C starting on 16 bytes with strides in multiples of 8
    elements (rows the kernels copy 16 bytes at a time); else "cuda_core".
    Host-known sizes only."""
    p, n = x.shape[-1], B.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
                  for t in (x, B, C))
    return ("tensor_core" if x.dtype == torch.bfloat16 and p % 16 == 0 and n % 16 == 0
            and p <= MAX_HEAD_DIM and n <= MAX_STATE and min(chunk, x.shape[1]) <= MAX_TC_CHUNK
            and aligned else "cuda_core")


def ssd_workspace(b, l, h, p, n, chunk, device, final_state: bool = False):
    """The tensor-core route's workspace: f32 states [b, nws, h, p, n]
    (each chunk's own contribution to the state, then the state entering
    the next chunk) and decays [b, nws, h] (exp of the chunk's summed
    dt * A), nc = ceil(l / min(chunk, l)) chunks and nws = nc - 1 slots
    (empty for one chunk), or nc with the final state (the last chunk's
    slot, which it computes through)."""
    q = min(chunk, l)
    nws = -(-l // q) - 1 + bool(final_state)
    return (torch.empty((b, nws, h, p, n), dtype=torch.float32, device=device),
            torch.empty((b, nws, h), dtype=torch.float32, device=device))


def ssd_scan(x, dt, A, B, C, *, chunk: int = 256, final_state: bool = False):
    """x [b,l,h,p]; dt [b,l,h] f32; A [h] f32; B, C [b,l,g,n] -> y
    [b,l,h,p] in x's dtype (as `ssd_scan_fwd`), or with final_state (y,
    h_final [b,h,p,n] f32), the state after the last row, as
    `ssd_scan_ref` returns it."""
    if on_cpu(x, dt, A, B, C):
        y, h_final = ssd_scan_ref(x, dt, A, B, C, chunk=chunk)
        return (y, h_final) if final_state else y
    return ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, final_state=final_state)


def ssd_scan_cuda(x, dt, A, B, C, *, chunk: int = 256, final_state: bool = False):
    """Launch the CUDA kernels of the route `ssd_route` names. x bf16/f32
    with p <= 64; dt and A f32; B and C of x's dtype with n <= 128 and h a
    multiple of g. x, dt, B and C may be strided views (the kernels read
    them through their strides) as long as their last dimension is
    contiguous; A is made contiguous. The tensor-core route launches up to
    three kernels on its workspace (`ssd_workspace`). final_state: ->
    (y, h_final [b,h,p,n] f32), written by the same launch (on the
    tensor-core route its state steps then take the last chunk too)."""
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
    # the final state's output; empty: none asked for
    h_final = torch.empty((b, h, p, n) if final_state else (0,), dtype=torch.float32,
                          device=dev)
    if b == 0 or l == 0 or h == 0:
        return (y, h_final.zero_()) if final_state else y
    # launches on the current stream, raises if the launch failed
    route = ssd_route(x, B, C, chunk)
    if route == "tensor_core":
        states, decays = ssd_workspace(b, l, h, p, n, chunk, dev, final_state)
        _build.extension().ssd_scan_mma(x, dt, A.contiguous(), B, C, y, states, decays, chunk,
                                        h_final)
        ssd_scan_cuda.tensor_core_launches += 1
    else:
        _build.extension().ssd_scan(x, dt, A.contiguous(), B, C, y, chunk, h_final)
        ssd_scan_cuda.cuda_core_launches += 1
    ssd_scan_cuda.launches += 1
    if final_state:
        setattr(ssd_scan_cuda, f"final_state_{route}_launches",
                getattr(ssd_scan_cuda, f"final_state_{route}_launches") + 1)
        return y, h_final
    return y


# calls that launched a route (`launches`, and by route; those that also
# returned the final state by route again); a run resets them to 0 and
# reads them back
ssd_scan_cuda.launches = 0
ssd_scan_cuda.tensor_core_launches = 0
ssd_scan_cuda.cuda_core_launches = 0
ssd_scan_cuda.final_state_tensor_core_launches = 0
ssd_scan_cuda.final_state_cuda_core_launches = 0
