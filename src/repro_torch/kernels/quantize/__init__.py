from repro_torch.kernels.quantize.ops import (dequantize, dequantize_sum_rows, quantize,
                                              quantize_kv_write)
from repro_torch.kernels.quantize.ref import (dequantize_ref, dequantize_sum_rows_ref,
                                              quantize_kv_write_ref, quantize_ref)

__all__ = ["dequantize", "dequantize_ref", "dequantize_sum_rows", "dequantize_sum_rows_ref",
           "quantize", "quantize_kv_write", "quantize_kv_write_ref", "quantize_ref"]
