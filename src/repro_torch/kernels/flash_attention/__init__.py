from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_decode,
                                                     flash_decode_paged)
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     flash_decode_paged_ref,
                                                     flash_decode_ref)

__all__ = ["flash_attention", "flash_attention_ref", "flash_decode",
           "flash_decode_paged", "flash_decode_paged_ref", "flash_decode_ref"]
