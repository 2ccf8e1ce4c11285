from repro_torch.kernels.quantize.ops import dequantize, quantize
from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_ref

__all__ = ["dequantize", "dequantize_ref", "quantize", "quantize_ref"]
