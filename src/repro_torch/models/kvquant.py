"""int8 KV-cache tree transforms (serve hot path).

A full-history attention layer's cache {"k","v"} ([B,Smax,K,D] or stacked
[L,B,Smax,K,D]) becomes int8 codes plus per-row f32 scales:
{"k","v" int8, "k_scale","v_scale" f32 [..,Smax,K]} — one symmetric scale
per token position per kv head. Quantization goes through the `quantize`
op on a [rows, D] view, so on the card it runs the CUDA quantize kernel.

The serve engine resolves the knob (`kv_dtype="int8"`), the slot decode
step quantizes each new token's rows, and the pool quantizes prefill output
at its boundary, so prefill math itself stays at model width. The quantize
transform runs before the page-arena transform, so the scale leaves page
into the arena beside their codes.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.models.layers import ParamDef, is_def

KV_DTYPES = ("model", "int8")


def validate_kv_dtype(kv_dtype: str) -> str:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                         f"got {kv_dtype!r}")
    return kv_dtype


def is_int8(kv_dtype: str) -> bool:
    """The one way to branch on the knob: validates first, so a typo'd
    kv_dtype fails loudly instead of selecting the model-width path."""
    return validate_kv_dtype(kv_dtype) == "int8"


def quantize_kv_leaf(x):
    """[..., D] float -> (int8 codes [..., D], f32 scales [...])."""
    d = x.shape[-1]
    q, s = q_ops.quantize(x.reshape(-1, d))
    return q.reshape(x.shape), s.reshape(x.shape[:-1])


def dequantize_kv_leaf(q, scale, dtype=torch.float32):
    return (q.float() * scale[..., None]).to(dtype)


def _transform(tree, seq_len: Optional[int], fn):
    """Walk nested cache dicts; apply fn to every {"k","v"}-only layer cache
    whose seq axis (always -3 of a k/v leaf) spans the full capacity."""
    if not isinstance(tree, dict):
        return tree
    if set(tree.keys()) == {"k", "v"}:
        shape = tree["k"].shape
        if len(shape) >= 3 and (seq_len is None or shape[-3] == seq_len):
            return fn(tree)
        return tree
    return {key: _transform(val, seq_len, fn) for key, val in tree.items()}


def quantize_cache_tree(cache, seq_len: Optional[int] = None):
    """Cache tree -> int8 tree. seq_len: the cache capacity (leaves whose
    seq axis differs stay at model width); None transforms every layer."""
    def q(layer):
        kq, ks = quantize_kv_leaf(layer["k"])
        vq, vs = quantize_kv_leaf(layer["v"])
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return _transform(cache, seq_len, q)


def quantize_cache_defs(defs, seq_len: Optional[int] = None):
    """The same transform on a tree of ParamDefs (the layout the slot
    decode step expects): codes become int8, scale leaves drop head_dim."""
    def q(layer):
        k, v = layer["k"], layer["v"]
        assert is_def(k) and is_def(v)

        def codes(d):
            return ParamDef(d.shape, d.axes, init="zeros", dtype="int8")

        def scale(d):
            return ParamDef(d.shape[:-1], d.axes[:-1], init="zeros",
                            dtype="float32")
        return {"k": codes(k), "v": codes(v),
                "k_scale": scale(k), "v_scale": scale(v)}
    return _transform(defs, seq_len, q)
