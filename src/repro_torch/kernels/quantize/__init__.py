from repro_torch.kernels.quantize.ops import quantize
from repro_torch.kernels.quantize.ref import quantize_ref

__all__ = ["quantize", "quantize_ref"]
