"""Mamba-2 block (SSD). Train and prefill: input projections, the
depthwise causal convolution, the chunked SSD scan (the CUDA kernel under
ssd_impl="pallas", its plain version otherwise), the gated RMSNorm and the
output projection; the prefill also hands on the decode cache (the final
state and the convolution's last K-1 input rows). Decode: one token's
state update (`decode_ssm`, plain torch, as the JAX package's is plain
jnp). The JAX package's sharding constraints are no-ops here and are left
out; its LMS tags (`ssd_xz`, `ssd_state`) are kept.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.lms.policies import tag
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_decode_step_ref, ssd_scan_ref
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


def apply_ssm(cfg, p, x, *, ssd_impl="ref", cache=False):
    """x [B,L,d] -> (out [B,L,d], final states [B,H,P,N] f32, or None from
    the kernel route, which computes them only where asked). cache: ->
    (out, {"h": the final states, "conv": the convolution's last K-1 input
    rows [B,K-1,C], zeros first where L < K-1}), the decode cache the
    prefill hands on (the JAX prefill computes the projections again for
    it; the kernel route takes the final states from the same launch)."""
    b, l, d = x.shape
    di, g, n, nh, hd = (cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state,
                        cfg.ssm_nheads, cfg.ssm_headdim)
    z, xr, bc, dt_raw = _split_proj(cfg, p, x)
    z = tag(z, "ssd_xz")
    conv_in = torch.cat([xr, bc], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    km1 = cfg.ssm_conv - 1
    # the decode cache's convolution inputs, a copy of the tail; the rest of
    # the input goes now (a long prompt's prefill holds no more than it needs)
    conv = ((conv_in[:, l - km1:] if l >= km1 else F.pad(conv_in, (0, 0, km1 - l, 0))).clone()
            if cache else None)
    del conv_in
    # views into conv_out: the kernel reads them through their strides
    xr, bc = conv_out[..., :di], conv_out[..., di:]
    B = bc[..., : g * n].reshape(b, l, g, n)
    C = bc[..., g * n:].reshape(b, l, g, n)
    xh = xr.reshape(b, l, nh, hd)
    dt = _softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if ssd_impl == "pallas" and cache:
        y, h_final = ssd_ops.ssd_scan(xh, dt, A, B, C, chunk=cfg.ssm_chunk, final_state=True)
    elif ssd_impl == "pallas":
        y = ssd_ops.ssd_scan(xh, dt, A, B, C, chunk=cfg.ssm_chunk)
        h_final = None
    elif ssd_impl == "ref":
        y, h_final = ssd_scan_ref(xh, dt, A, B, C, chunk=cfg.ssm_chunk)
    else:
        raise ValueError(ssd_impl)
    # y is rounded to x's dtype before the skip term is added, as in JAX
    y = tag(y.reshape(b, l, di), "ssd_state")
    y = (y + (xh * p["D"][None, None, :, None]).reshape(b, l, di)).to(x.dtype)
    del xr, bc, B, C, xh, conv_out
    y = gated_rmsnorm(p["norm"], y, z, eps=cfg.norm_eps)
    out = (y @ p["out_proj"]).to(x.dtype)
    if not cache:
        return out, h_final
    return out, {"h": h_final, "conv": conv}


def _cache_shapes(cfg, batch: int):
    conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return ((batch, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state),
            (batch, cfg.ssm_conv - 1, conv_ch))


def init_ssm_cache(cfg, batch: int, device, dtype=torch.bfloat16):
    """A zero decode cache: the state h [B,H,P,N] f32 and the convolution's
    last K-1 inputs conv [B,K-1,C] in `dtype`."""
    hs, cs = _cache_shapes(cfg, batch)
    return {"h": torch.zeros(hs, dtype=torch.float32, device=device),
            "conv": torch.zeros(cs, dtype=dtype, device=device)}


def ssm_cache_defs(cfg, batch: int):
    hs, cs = _cache_shapes(cfg, batch)
    return {"h": ParamDef(hs, ("batch", "ssm_heads", None, None), init="zeros",
                          dtype="float32"),
            "conv": ParamDef(cs, ("batch", None, None), init="zeros")}


def decode_ssm(cfg, p, x, cache):
    """x [B,1,d]; cache {"h", "conv"} -> (out [B,1,d], new cache {"h",
    "conv"}): the convolution over the K-1 cached inputs and this one, one
    step of the state, the skip term, the gated norm and the output
    projection. The cache given is not written."""
    b = x.shape[0]
    di, g, n, nh, hd = (cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state,
                        cfg.ssm_nheads, cfg.ssm_headdim)
    z, xr, bc, dt_raw = _split_proj(cfg, p, x[:, 0])
    conv_in = torch.cat([xr, bc], dim=-1)                          # [B, C]
    dtype = torch.promote_types(cache["conv"].dtype, conv_in.dtype)
    hist = torch.cat([cache["conv"].to(dtype), conv_in[:, None].to(dtype)], dim=1)
    # a product over K in f32, rounded once to the input's dtype, as XLA
    # computes the JAX package's bf16 einsum
    w = p["conv_w"]
    conv = torch.einsum("bkc,kc->bc", hist.float(), w.float()).to(
        torch.promote_types(hist.dtype, w.dtype))
    conv_out = F.silu(conv + p["conv_b"])
    xr2, bc2 = conv_out[..., :di], conv_out[..., di:]
    B = bc2[..., : g * n].reshape(b, g, n)
    C = bc2[..., g * n:].reshape(b, g, n)
    xh = xr2.reshape(b, nh, hd)
    dt = _softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h_new = ssd_decode_step_ref(cache["h"], xh, dt, A, B, C)
    y = (y + xh * p["D"][None, :, None]).reshape(b, di).to(x.dtype)
    y = gated_rmsnorm(p["norm"], y, z, eps=cfg.norm_eps)
    out = (y @ p["out_proj"]).to(x.dtype)[:, None]
    return out, {"h": h_new, "conv": hist[:, 1:]}
