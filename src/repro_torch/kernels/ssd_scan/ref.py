"""Plain PyTorch SSD (state-space duality) chunked scan — the Mamba-2
core: the CPU path, and the version the CUDA kernel is held against.
Semantics (per head, diagonal A):

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t ⊗ B_t        (state update)
    y_t = C_t · h_t                                          (readout)

Chunked evaluation as the JAX package's `ssd_scan_ref`: a quadratic
attention-like term inside each chunk and a linear recurrence of the f32
state across chunks.
"""
from __future__ import annotations

import torch


def _expand_groups(m, h):
    """[b,l,g,n] -> [b,l,h,n]: head i reads group i * g // h."""
    g = m.shape[2]
    assert h % g == 0
    return m.repeat_interleave(h // g, dim=2)


def ssd_scan_ref(x, dt, A, B, C, *, chunk: int = 256, h0=None):
    """x [b,l,h,p]; dt [b,l,h] (post-softplus, >= 0); A [h] (< 0);
    B, C [b,l,g,n]. -> (y [b,l,h,p] in x's dtype, h_final [b,h,p,n] f32)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    Bh = _expand_groups(B, h).float()
    Ch = _expand_groups(C, h).float()
    xf = x.float()
    dtf = dt.float()
    Af = A.float()

    q = min(chunk, l)
    pad = (-l) % q
    if pad:   # zero rows: dt = 0 leaves the state as it is, x = B = C = 0
        xf = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = torch.nn.functional.pad(dtf, (0, 0, 0, pad))
        Bh = torch.nn.functional.pad(Bh, (0, 0, 0, 0, 0, pad))
        Ch = torch.nn.functional.pad(Ch, (0, 0, 0, 0, 0, pad))
    lp = l + pad
    nc = lp // q

    # chunked views, head axis before time-in-chunk: [b,nc,h,q,...]
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
    # intra-chunk "attention": L[i,j] = exp(cum_i - cum_j), i >= j
    diff = cum[..., :, None] - cum[..., None, :]             # [b,nc,h,q,q]
    tril = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    # mask BEFORE exp: exp of a masked-out (positive) diff overflows
    lmat = torch.exp(torch.where(tril, diff, -torch.inf))
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
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(b, lp, h, p)[:, :l]
    return y.to(x.dtype), hstate
