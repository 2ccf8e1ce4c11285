"""Mamba-2 block (SSD) for the forward pass: input projections, the
depthwise causal convolution, the chunked SSD scan (the CUDA kernel under
ssd_impl="pallas", its plain version otherwise), the gated RMSNorm and the
output projection. The JAX package's sharding constraints and LMS tags
are no-ops here and are left out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models.layers import ParamDef, gated_rmsnorm


def ssm_defs(cfg):
    d, di = cfg.d_model, cfg.d_inner
    g, n, nh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    conv_ch = di + 2 * g * n
    return {
        "in_proj_z": ParamDef((d, di), ("d_model", "d_inner")),
        "in_proj_x": ParamDef((d, di), ("d_model", "d_inner")),
        "in_proj_bc": ParamDef((d, 2 * g * n), ("d_model", None)),
        "in_proj_dt": ParamDef((d, nh), ("d_model", "ssm_heads")),
        "conv_w": ParamDef((cfg.ssm_conv, conv_ch), ("conv", None), scale=0.1),
        "conv_b": ParamDef((conv_ch,), (None,), init="zeros"),
        "A_log": ParamDef((nh,), ("ssm_heads",), init="ssm_a", dtype="float32"),
        "D": ParamDef((nh,), ("ssm_heads",), init="ones", dtype="float32"),
        "dt_bias": ParamDef((nh,), ("ssm_heads",), init="zeros", dtype="float32"),
        "norm": {"scale": ParamDef((di,), ("d_inner",), init="ones", dtype="float32")},
        "out_proj": ParamDef((di, d), ("d_inner", "d_model")),
    }


def _causal_conv(u, w, b):
    """u [B,L,C]; w [K,C] depthwise causal; b [C]. A sum of K products in
    u's dtype, added in order, as the JAX package's Python `sum`."""
    k = w.shape[0]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + pad[:, i:i + u.shape[1], :] * w[i][None, None, :]
    return out + b


def _split_proj(cfg, p, x):
    z = x @ p["in_proj_z"]
    xr = x @ p["in_proj_x"]
    bc = x @ p["in_proj_bc"]
    dt_raw = x @ p["in_proj_dt"]
    return z, xr, bc, dt_raw


def _softplus(x):
    """log(1 + exp(x)) without F.softplus's switch to x above 20, as
    jax.nn.softplus computes it (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros_like(x))


def apply_ssm(cfg, p, x, *, ssd_impl="ref"):
    """x [B,L,d] -> (out [B,L,d], final states [B,H,P,N] f32, or None from
    the kernel, which returns none)."""
    b, l, d = x.shape
    di, g, n, nh, hd = (cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state,
                        cfg.ssm_nheads, cfg.ssm_headdim)
    z, xr, bc, dt_raw = _split_proj(cfg, p, x)
    conv_in = torch.cat([xr, bc], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    # views into conv_out: the kernel reads them through their strides
    xr, bc = conv_out[..., :di], conv_out[..., di:]
    B = bc[..., : g * n].reshape(b, l, g, n)
    C = bc[..., g * n:].reshape(b, l, g, n)
    xh = xr.reshape(b, l, nh, hd)
    dt = _softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if ssd_impl == "pallas":
        y = ssd_ops.ssd_scan(xh, dt, A, B, C, chunk=cfg.ssm_chunk)
        h_final = None
    elif ssd_impl == "ref":
        y, h_final = ssd_scan_ref(xh, dt, A, B, C, chunk=cfg.ssm_chunk)
    else:
        raise ValueError(ssd_impl)
    # y is rounded to x's dtype before the skip term is added, as in JAX
    y = (y.reshape(b, l, di) + (xh * p["D"][None, None, :, None]).reshape(b, l, di)
         ).to(x.dtype)
    y = gated_rmsnorm(p["norm"], y, z, eps=cfg.norm_eps)
    out = (y @ p["out_proj"]).to(x.dtype)
    return out, h_final
