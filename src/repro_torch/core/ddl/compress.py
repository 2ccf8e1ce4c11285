"""Pod-hop gradient compression: symmetric int8 with optional error
feedback, applied only on the slow cross-pod fabric (DDL's
mix-and-match-per-fabric principle). A port of the JAX package's
`core/ddl/compress.py`, whose quantize/dequantize loop here goes through
the port's kernels: on the card `compress` launches the CUDA `quantize`
kernel, `decompress` (error feedback's local dequantize) the CUDA
`dequantize` kernel and the pod sum the `dequantize_sum_rows` kernel, one
pass over every pod's codes; on the CPU all take their plain versions.
The numbers are those of the JAX package's jitted path, bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.quantize import ops as q_ops

_ROW = 1024  # quantization bucket (per-row scales)


def _to_rows(x) -> Tuple[torch.Tensor, int]:
    n = x.numel()
    pad = (-n) % _ROW
    xp = F.pad(x.reshape(-1), (0, pad)) if pad else x.reshape(-1)
    return xp.reshape(-1, _ROW), n


def compress(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """flat f32/bf16 -> (int8 rows [ceil(n/1024), 1024], f32 scales)."""
    rows, _ = _to_rows(x)
    return q_ops.quantize(rows)


def decompress(q, scales, n: int, dtype=torch.float32) -> torch.Tensor:
    """The first n elements of q * scales[row], flat, in `dtype`."""
    return q_ops.dequantize(q, scales).reshape(-1)[:n].to(dtype)


def compressed_allreduce_pod(x, axis: str, *, mesh, error_feedback=None):
    """All-reduce a flat tensor over the pod axis `axis` of `mesh`
    transmitting int8: quantize -> all_gather(int8 codes + f32 scales) ->
    dequantize each pod's and sum them in pod order from an f32 zero. The
    bytes that cross the pod fabric are 1/4 of f32 (plus a scale per 1024
    elements). With `error_feedback`, the local quantization error comes
    back as the new feedback, to be added to the next step's input
    (EF-SGD). Without it the local dequantize is skipped: the JAX package's
    jitted path drops that dead value too. -> (sum in x's dtype, new EF or
    None)."""
    xin = x if error_feedback is None else x + error_feedback
    q, s = compress(xin)
    new_ef = None
    if error_feedback is not None:
        local_dq = decompress(q, s, xin.numel(), xin.dtype).reshape(xin.shape)
        new_ef = xin - local_dq
    pods = mesh.size(axis)
    qg = mesh.all_gather(q, axis).view((pods,) + tuple(q.shape))
    sg = mesh.all_gather(s, axis).view(pods, -1)
    # each pod's dequantize summed in pod order from an f32 zero, in one pass
    total = q_ops.dequantize_sum_rows(qg, sg, xin.numel()).reshape(xin.shape)
    return total.to(x.dtype), new_ef
