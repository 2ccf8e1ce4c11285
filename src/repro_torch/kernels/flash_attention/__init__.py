from repro_torch.kernels.flash_attention.ops import flash_decode_paged
from repro_torch.kernels.flash_attention.ref import (flash_decode_paged_ref,
                                                     flash_decode_ref)

__all__ = ["flash_decode_paged", "flash_decode_paged_ref", "flash_decode_ref"]
