#!/usr/bin/env python3
"""Where the tensor-core SSD scan's time goes, on the card: the kernels of
csrc/ssd_scan_mma.cu built as they are and with one part of the output
kernel (`ssd_chunk_out_kernel`) taken out, each timed by torch.profiler at
the Mamba-2 forward's shape (4 x 2048 tokens, 64 heads of 64, state 128,
chunk 256, bf16, dt in a trained model's range).

    python3 scripts/ssd_scan_ablation.py      # from the repo root, on a machine with the card

Variants (the output of every one but `kernel` is wrong by design):
- kernel: the source as it is; its y is held to the plain scan (max |diff|);
- loads_only: the output kernel stops once its loads and prefix sums are in;
- no_sx: without the S' x_J products (their inputs, the masked scores, go too);
- no_lo: without the lo halves of the hi + lo products of the output kernel.

Each variant is its own nvcc build of the source behind an `extern "C"`
shim, loaded with ctypes, so a run takes seconds, not the extension's build.
Prints the card's name and power limit, then one JSON line a variant.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "ssd_scan_ablation")
NVCC = "/usr/local/cuda/bin/nvcc"
SHAPE = dict(b=4, l=2048, h=64, p=64, g=1, n=128, chunk=256)

SHIM = '''
extern "C" int ssd_shim(const void* x, const float* dt, const float* A, const void* B,
                        const void* C, void* y, float* states, float* decays, int batch, int L,
                        int H, int G, int P, int N, int chunk, const int64_t* xs,
                        const int64_t* dts, const int64_t* bs, const int64_t* cs, void* stream) {
  return repro::ssd_scan_mma(x, dt, A, B, C, y, states, decays, nullptr, batch, L, H, G, P, N,
                             chunk, xs, dts, bs, cs, stream);
}
'''


def _in_output_kernel(edit):
    """Apply `edit` to the output kernel's part of the source only."""
    def apply(src):
        start = src.index("// ---- step 3")
        out = edit(src[start:])
        assert out != src[start:], "the edit found nothing to change"
        return src[:start] + out
    return apply


def _loads_only(s):
    anchor = "      if (g0 == 0 && j0 == 0) chunk_cum<2>(dt_s, cum_s, Q, A[h]);\n"
    assert s.count(anchor) == 1
    return s.replace(anchor, anchor + "      cp_async_wait<0>();\n      __syncthreads();\n"
                     "      if (cum_s[0] != 12345.f) return;\n")


def _no_sx(s):
    return re.sub(r"(\n\s*)(wgmma_rs\(o\[t\], p[hl]\[st\])", r"\1if (0) \2", s)


def _no_lo(s):
    s = re.sub(r"(\n\s*)(wgmma_rs\(o\[t\], pl\[st\])", r"\1if (0) \2", s)
    return s.replace("wgmma_ss(o[t], smem_desc(ca + off, 16, 1024),\n",
                     "if (0) wgmma_ss(o[t], smem_desc(ca + off, 16, 1024),\n")


VARIANTS = {
    "kernel": lambda s: s,
    "loads_only": _in_output_kernel(_loads_only),
    "no_sx": _in_output_kernel(_no_sx),
    "no_lo": _in_output_kernel(_no_lo),
}


def build_all():
    """One nvcc per variant, all started together. -> {name: .so path}."""
    os.makedirs(OUT, exist_ok=True)
    src = open(os.path.join(CSRC, "ssd_scan_mma.cu")).read()
    procs = {}
    for name, edit in VARIANTS.items():
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(edit(src) + SHIM)
        procs[name] = subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-shared",
             "-Xcompiler", "-fPIC", "-I", CSRC, "-o", os.path.join(OUT, f"{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate(timeout=600)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = os.path.join(OUT, f"{name}.so")
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this script measures the card")
    import chip_smoke as cs
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    line = cs.device_phase()
    libs = build_all()
    k = SHAPE
    x, dt, A, B, C = cs._ssd_inputs(k["b"], k["l"], k["h"], k["p"], k["g"], k["n"],
                                    torch.bfloat16, 29, "trained")
    want = ssd_scan_ref(x, dt, A, B, C, chunk=k["chunk"])[0].float()
    i64 = ctypes.c_int64 * 3

    def strides(t):
        return i64(*t.stride()[:3])
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.ssd_shim.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5
        y = torch.empty((k["b"], k["l"], k["h"], k["p"]), dtype=torch.bfloat16, device="cuda")
        states, decays = ssd_ops.ssd_workspace(k["b"], k["l"], k["h"], k["p"], k["n"],
                                               k["chunk"], x.device)
        args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                y.data_ptr(), states.data_ptr(), decays.data_ptr(), k["b"], k["l"], k["h"],
                k["g"], k["p"], k["n"], k["chunk"], strides(x), strides(dt), strides(B),
                strides(C))

        def run():
            err = lib.ssd_shim(*args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: launch failed with {err}")
        run()
        torch.cuda.synchronize()
        ms, _, by_kernel = cs.device_ms_per_call(run, iters=10)
        cs.emit({"phase": "ssd_scan_ablation", "variant": name, "shape": k, "device_ms": ms,
                 "device_ms_by_kernel": by_kernel,
                 "max_abs_diff_vs_plain": (y.float() - want).abs().max().item(), "card": line})
    return 0


if __name__ == "__main__":
    sys.exit(main())
