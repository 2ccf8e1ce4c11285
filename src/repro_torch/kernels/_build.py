"""Build the CUDA kernel sources at first use into one PyTorch extension.

Every source under `csrc/` goes to one `torch.utils.cpp_extension.load`
call, whose ninja build compiles them in parallel into
`<repo>/build/repro_torch_kernels/` and rebuilds only what changed. The
kernel sources (`*.cu`) include no PyTorch header; `binding.cpp` is the one
source that does. Both sides include `csrc/kernels.h`, so the launchers'
signatures are checked by the compiler and the linker, not by hand.
"""
from __future__ import annotations

import functools
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("binding.cpp", "flash_attention_fwd.cu", "flash_attention_wgmma.cu",
           "flash_decode.cu", "quantize.cu", "rmsnorm.cu", "ssd_scan.cu", "ssd_scan_mma.cu")
# no --use_fast_math: the quantizer's codes must equal the plain version's
# bitwise, which needs IEEE division and round-half-to-even
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-lineinfo")


@functools.lru_cache(maxsize=None)
def extension():
    """The built and loaded extension module (builds on the first call;
    raises with the compiler's output if the build fails)."""
    from torch.utils.cpp_extension import load
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return load(name="repro_torch_kernels",
                sources=[str(CSRC / s) for s in SOURCES],
                extra_cflags=["-O3"], extra_cuda_cflags=list(CUDA_FLAGS),
                extra_include_paths=[str(CSRC)],
                build_directory=str(BUILD_DIR), verbose=False)
