"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch


def on_cpu(*tensors) -> bool:
    """True iff every tensor lies on the CPU (the plain version's case).
    A CUDA tensor makes it False; any other device raises."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs <= {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"tensors must all be on the CPU or all on CUDA, got {devs}")


def require(t: torch.Tensor, name: str, *, dtypes, device, ndim: int | None = None,
            shape=None, strided: bool = False) -> None:
    """Raise unless t is on `device`, of one of `dtypes`, with `ndim`
    dimensions (or exactly `shape`), and contiguous — everything a kernel
    takes on trust. `strided` admits any view whose last dimension is
    contiguous, for a kernel that reads its rows through their strides."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {ndim} dims")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if strided:
        if t.dim() and t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    elif not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
