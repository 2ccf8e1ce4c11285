"""Plain PyTorch SSD (state-space duality) chunked scan — the Mamba-2
core: the CPU path, and the version the CUDA kernel is held against.
Semantics (per head, diagonal A):

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t ⊗ B_t        (state update)
    y_t = C_t · h_t                                          (readout)

Chunked evaluation as the JAX package's `ssd_scan_ref`: a quadratic
attention-like term inside each chunk and a linear recurrence of the f32
state across chunks. `ssd_scan_chunked_ref` models the tensor-core route's
three steps and the operands its bf16 products take, for the tests.
`ssd_decode_step_ref` is decode's one-token step (no kernel: the JAX
package's is plain jnp too).
"""
from __future__ import annotations

import torch


def _expand_groups(m, h):
    """[b,l,g,n] -> [b,l,h,n]: head i reads group i * g // h."""
    g = m.shape[2]
    assert h % g == 0
    return m.repeat_interleave(h // g, dim=2)


def _chunked(x, dt, A, B, C, chunk):
    """The inputs in f32, padded to whole chunks of q = min(chunk, l) rows
    with zero rows (dt = 0 leaves the state as it is, x = B = C = 0), as
    chunked views [b,nc,h,q,...] with the head axis before time-in-chunk,
    and the chunk's prefix sums cum [b,nc,h,q] of dt * A."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    Bh = _expand_groups(B, h).float()
    Ch = _expand_groups(C, h).float()
    xf = x.float()
    dtf = dt.float()
    Af = A.float()

    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = torch.nn.functional.pad(dtf, (0, 0, 0, pad))
        Bh = torch.nn.functional.pad(Bh, (0, 0, 0, 0, 0, pad))
        Ch = torch.nn.functional.pad(Ch, (0, 0, 0, 0, 0, pad))
    nc = (l + pad) // q

    xc = xf.reshape(b, nc, q, h, p).permute(0, 1, 3, 2, 4)
    dtc = dtf.reshape(b, nc, q, h).permute(0, 1, 3, 2)
    Bc = Bh.reshape(b, nc, q, h, n).permute(0, 1, 3, 2, 4)
    Cc = Ch.reshape(b, nc, q, h, n).permute(0, 1, 3, 2, 4)

    dA = dtc * Af[None, None, :, None]                       # [b,nc,h,q]
    # prefix sums in f64, each rounded once to f32: what torch.cumsum does
    # for f32 on the CPU, made explicit so that the card (whose f32 cumsum
    # sums in f32, in a scan order of its own) gives the same cum; an error
    # of an ulp of |cum| (up to ~2e-4 at a chunk's end) moves every decay
    # exp(cum_i - cum_j) by as much, relative
    cum = torch.cumsum(dA.double(), dim=-1).float()          # [b,nc,h,q]
    return xc, dtc, Bc, Cc, cum


def _decay_matrix(cum):
    """exp(cum_i - cum_j) for j <= i, else 0 [b,nc,h,q,q], masked BEFORE
    the exp: exp of a masked-out (positive) diff overflows."""
    q = cum.shape[-1]
    diff = cum[..., :, None] - cum[..., None, :]
    tril = torch.ones((q, q), dtype=torch.bool, device=cum.device).tril()
    return torch.exp(torch.where(tril, diff, -torch.inf))


def _unchunk(yc, l):
    """[b,nc,h,q,p] -> [b,l,h,p]."""
    b, nc, h, q, p = yc.shape
    return yc.permute(0, 1, 3, 2, 4).reshape(b, nc * q, h, p)[:, :l]


def ssd_scan_ref(x, dt, A, B, C, *, chunk: int = 256, h0=None):
    """x [b,l,h,p]; dt [b,l,h] (post-softplus, >= 0); A [h] (< 0);
    B, C [b,l,g,n]. -> (y [b,l,h,p] in x's dtype, h_final [b,h,p,n] f32)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    xc, dtc, Bc, Cc, cum = _chunked(x, dt, A, B, C, chunk)
    nc = xc.shape[1]
    # intra-chunk "attention": L[i,j] = exp(cum_i - cum_j), i >= j
    lmat = _decay_matrix(cum)
    scores = torch.einsum("bchin,bchjn->bchij", Cc, Bc) * lmat
    xdt = xc * dtc[..., None]                                # [b,nc,h,q,p]
    y_intra = torch.einsum("bchij,bchjp->bchip", scores, xdt)

    # chunk-final states: S_c = sum_i exp(cum_last - cum_i) * xdt_i ⊗ B_i
    decay_to_end = torch.exp(cum[..., -1:] - cum)            # [b,nc,h,q]
    S = torch.einsum("bchi,bchip,bchin->bchpn", decay_to_end, xdt, Bc)
    chunk_decay = torch.exp(cum[..., -1])                    # [b,nc,h]

    hstate = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
              if h0 is None else h0.float())
    h_prevs = []                       # the state entering each chunk
    for c in range(nc):
        h_prevs.append(hstate)
        hstate = hstate * chunk_decay[:, c, :, None, None] + S[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                    # [b,nc,h,p,n]

    # inter-chunk readout: y_i += exp(cum_i) * C_i · h_{chunk_start}
    y_inter = torch.einsum("bchin,bchpn,bchi->bchip", Cc, h_prevs, torch.exp(cum))
    return _unchunk(y_intra + y_inter, l).to(x.dtype), hstate


def ssd_decode_step_ref(h_state, x, dt, A, B, C):
    """One token's state update and readout, as the JAX package's
    `ssd_decode_step_ref` (plain jnp there too: decode has no kernel).
    h_state [b,h,p,n] f32; x [b,h,p]; dt [b,h]; A [h]; B, C [b,g,n].
    -> (y [b,h,p] in x's dtype, h_new [b,h,p,n] f32)."""
    hq = h_state.shape[1]
    Bh = B.repeat_interleave(hq // B.shape[1], dim=1).float()
    Ch = C.repeat_interleave(hq // C.shape[1], dim=1).float()
    dtf = dt.float()
    dec = torch.exp(dtf * A.float()[None])                  # [b,h]
    xdt = x.float() * dtf[..., None]                         # [b,h,p]
    h_new = h_state * dec[..., None, None] + xdt[..., :, None] * Bh[..., None, :]
    y = torch.einsum("bhn,bhpn->bhp", Ch, h_new)
    return y.to(x.dtype), h_new


def _parts(v, operands):
    """An f32 operand as a bf16 product takes it: "hi_lo", the nearest bf16
    hi and the nearest bf16 to what hi leaves, two products into one sum;
    "bf16", hi alone (a single rounding); "f32", the value itself."""
    if operands == "f32":
        return [v]
    hi = v.to(torch.bfloat16).float()
    if operands == "bf16":
        return [hi]
    if operands != "hi_lo":
        raise ValueError(f"operands={operands!r}: expected 'hi_lo', 'bf16' or 'f32'")
    return [hi, (v - hi).to(torch.bfloat16).float()]


def ssd_scan_chunked_ref(x, dt, A, B, C, *, chunk: int = 256, operands: str = "hi_lo",
                         out_f32: bool = False, final_state: bool = False):
    """Plain model of the tensor-core route (csrc/ssd_scan_mma.cu), for
    tests only and on no path: its three steps over chunks of q rows, with
    the operands its bf16 products take. x, B and C enter as they are (bf16
    inputs are exact in a bf16 product); the three f32 operands — w o x with
    w = exp(cum_last - cum_i) dt_i (step 1), the scores (C_I B_J^T) o
    exp(cum_i - cum_j) o dt_j and the state h entering the chunk (step 3) —
    enter as `operands` says (`_parts`). Products and sums in f32, the
    decays exp(cum_i - cum_j) taken whole (the kernel forms most of them as
    a product of two exps, each <= 1: a few f32 ulps apart).
    -> y [b,l,h,p] in x's dtype (f32, before that rounding, with out_f32);
    with final_state (y, h_final [b,h,p,n] f32): step 2 carried through the
    last chunk, as the kernel does where the final state is asked for."""
    l = x.shape[1]
    xc, dtc, Bc, Cc, cum = _chunked(x, dt, A, B, C, chunk)
    b, nc, h, q, p = xc.shape
    n = Bc.shape[-1]

    # step 1: each chunk's own contribution to the state, and its decay
    wx = (torch.exp(cum[..., -1:] - cum) * dtc)[..., None] * xc
    S = sum(torch.einsum("bchip,bchin->bchpn", part, Bc) for part in _parts(wx, operands))
    decay = torch.exp(cum[..., -1])                          # [b,nc,h]

    # step 2: the state entering each chunk, in f32
    hstate = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(hstate)
        hstate = decay[:, c, :, None, None] * hstate + S[:, c]
    h_in = torch.stack(h_in, dim=1)                          # [b,nc,h,p,n]

    # step 3: exp(cum_i) C_i h^T, then the masked scores times x
    y = sum(torch.einsum("bchin,bchpn->bchip", Cc, part) for part in _parts(h_in, operands))
    y = y * torch.exp(cum)[..., None]
    scores = (torch.einsum("bchin,bchjn->bchij", Cc, Bc) * _decay_matrix(cum)
              * dtc[..., None, :])
    y = y + sum(torch.einsum("bchij,bchjp->bchip", part, xc)
                for part in _parts(scores, operands))
    y = _unchunk(y, l)
    y = y if out_f32 else y.to(x.dtype)
    return (y, hstate) if final_state else y
