#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py        # from the repo root, on a machine with the card

Phases, each printed as one JSON line (any failure raises and exits
non-zero, printing no result):

1. device — the card's name and power limit as nvidia-smi gives them (also
   printed raw on a line of its own);
2. build — the CUDA kernels built from the repo's sources (seconds), and
   the tensor-core instructions in their SASS (HGMMA in the prefill
   kernel, HMMA in the decode kernel and in the SSD scan's two product
   kernels);
3. kernels — each kernel on the card against its plain PyTorch version at
   every shape the paths below give it and at a long-context shape, with
   its time, the plain version's, the least time the card could take
   (bound) and, where one exists, one PyTorch call computing the same
   function (SDPA, F.rms_norm) as a yardstick, never called by the port;
   the decode rows take every kernel one call launches (split and
   combine) by torch.profiler, beside the CUDA-event wall time, with the
   route and splits, and SDPA's device time likewise; the decode entries
   also run under torch.cuda.set_sync_debug_mode("error") (no host sync
   in a call), and the decode route of f32 tensors (the CUDA cores) on its
   own path;
   the quantize, dequantize, RMSNorm and SSD scan rows also take the
   kernel's device time from torch.profiler (quantize and dequantize also
   at DDL's pod-hop slices, bitwise; the SSD rows every kernel a call
   launches, the RMSNorm rows `F.rms_norm`'s device time likewise); the
   int8 rows assert their path (a row held in registers, or element by
   element), and so do the decode step's fused K/V write
   (`quantize_kv_write`: the engine's arena, 16 slots, slot-contiguous,
   with inactive slots and NaN rows, bitwise on every cache byte, under
   sync-debug "error") and the pod sum (`dequantize_sum_rows`: 2 and 4
   pods, the embedding's tail, bitwise), each timed beside the composition
   of launches it replaces; the
   SSD and RMSNorm rows assert the route or path they took (the scan on
   the tensor cores or the CUDA cores, RMSNorm's row held in registers or
   element by element); SSD rows with dt in a trained model's range
   also show that the plain scan with the decayed state dropped from what
   each chunk hands on fails the row's rule; the RMSNorm autograd
   Function's gradient against autograd through the plain version; the
   scan's CUDA-core route on its own path (the scan entry on f32 views);
4. reference (qwen2.5-14b at full width, 2 layers, random bf16 weights
   from a seed) — the serve engine with model-width and int8 KV pages;
   the engine with the flash-attention prefill (attn_impl="pallas",
   whole-prompt prefill); the static whole-batch loop (`run_static`:
   flash-attention prefill, then lockstep decode through the
   slot-contiguous flash-decode kernel, whose greedy tokens may part from
   the engine's only at a narrow dense margin); the slot decode step
   without a page arena against the paged one, bf16 and int8. Logits are
   held against a dense one-shot pass over each request's prompt and
   tokens. Then `Model.forward` (attn_impl="pallas") against
   `Model.prefill` on the static prefill's batch;
5. Mamba-2 (mamba2-1.3b at full width, random weights from a seed with
   dt_bias drawn as Mamba-2 draws it, 4 x 2048 tokens) — `Model.forward` and `loss` through the SSD scan kernel
   (ssd_impl="pallas") against the same model through the plain scan, at
   2 layers (values and argmax) and at the full 48 (launches exactly 48,
   all on the tensor-core route, argmax where the margin is wide, both
   losses, forward time);
6. training (qwen2.5-14b at full width, bf16, 2 x 2048 tokens of the
   synthetic stream) — at 2 layers, 3 steps of `build_train_step` from one
   init through the kernels and through the plain versions (step 1's
   grads, each step's loss and grad norm, RMSNorm launches exactly 4L+1 a
   step: 2L+1 in the forward, 2L in the checkpointed layers' recompute;
   step 1 again with RMSNorm's plain forward, and with RMSNorm swapped for
   its plain version, each against both runs);
   at 4 layers, the main path: `Trainer.train` for 5 steps (losses, step
   time, tokens/s, model FLOP/s, peak memory, launches) and one more step
   under torch.profiler;
7. engine and static at the full 48 layers — the engine serving 8
   requests with half the device pages full residency needs (the backlog
   spills to pinned host memory), with model-width then int8 KV pages;
   then `run_static` on the same weights, held to the same loop with its
   kernels swapped for their plain versions (teacher-forced), its dense
   deviation and its parity with the engine's tokens reported; then its
   prefill step timed warm with flash attention on the tensor cores and
   on the CUDA cores, in turns;
8. determinism — the 48-layer model-width trace again, token for token;
9. profile — that trace once more with each KV width under torch.profiler:
   the device's busy share, its top kernels, and the runtime launch calls
   per layer-tick;
10. DDL at full width (qwen2.5-14b cut to 1 layer, random weights from a
   seed, 2 ranks spawned on the one card over gloo, a 2x1x1 mesh,
   compress_dcn, the overlapped backward, 2048 tokens a rank) —
   `Trainer.train` for 3 steps: replicas bitwise in sync, the int8 pod hop
   through the kernels bitwise against the plain quantizers and within
   the int8 bound of the exact sum, the launches the leaf sizes give
   (quantize and the pod sum once a slice, no dequantize), the step time,
   the reduction's share and the pod-hop bytes; then error feedback's path
   (one leaf reduced with EF: the dequantizer once a slice, bitwise
   against the plain quantizers);
11. DDL at smoke width (4 ranks, a 2x2x1 mesh) — the overlapped backward
   off and on x compression off and on, each against one rank on the
   global batch;
12. host — MemTotal and MemAvailable, and the achieved pinned copy rate
   host to device, device to host and both at once (1 GiB each way, CUDA
   events); the gate's depth is chosen here (the most layers L <= 48 whose
   pinned state fits 80% of MemAvailable, failing unless that state plus
   the grads exceeds the card's 80 GB) and its pinned state reserved once;
13. lms_ab (qwen2.5-14b at full width cut to 4 layers, 2 x 2048 tokens, 3
   steps of `Trainer.train` from one seed) — under the plan of
   LMSConfig(hbm_budget=16e9) (params and AdamW state streamed from
   pinned host memory, five activation classes offloaded, mlp_hidden
   recomputed) against resident: losses, grad norms and every param
   bitwise equal; the RMSNorm launches the plan implies (2L+1 a step
   against 4L+1); both step times, the swap counters a step by class
   against the plan's, the measured peak against the plan's;
14. lms_gate (qwen2.5-14b at full width, the host phase's L layers, 2 x
   2048 tokens, 3 steps) — the budget from lms_ab's measured-minus-planned
   peak fed to the planner as its audited live-bytes margin (lowered until
   the params stream); finite losses, step 1's loss bitwise equal to a
   layer-by-layer no-grad forward of the phase's own; step time, tokens/s,
   model FLOP/s, peak against the plan's, pinned bytes against the plan's
   host bytes, swap bytes a step against the plan's, the link rate in the
   step against the host phase's, the set-up times.

Every run of a path records the shape of each kernel call and fails on one
the kernel phases did not check, and its launch counts (flash attention's
also by route) are reset just before and read just after: the static
loop's, the engine's whole-prompt prefill's and `Model.forward`'s attention
launches must all take the tensor-core route, and so must every decode
launch of the engine, the static loop and the slot decode, and every scan
launch of the Mamba-2 forward. The line before the last lists every ported
kernel (flash attention, decode and the SSD scan once per route; the int8
quantizer and dequantizer with their fused entries) with its launches on
the main path; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12          # CUDA cores, outside the tensor cores
BF16_TENSOR_FLOPS_PER_S = 989e12  # tensor cores, dense

ARCH = "qwen2.5-14b"
H, K, D, PAGE = 40, 8, 128, 16   # qwen2.5-14b attention
SEED = 0
# the served trace: 8 requests of prompt 128 + 32 greedy tokens on 4 slots,
# with half the 40 device pages full residency needs
REQUESTS, PROMPT, GEN = 8, 128, 32
SLOTS, MAX_LEN, CHUNK, DEVICE_PAGES = 4, 160, 32, 20
# Mamba-2's forward and loss: mamba2-1.3b at 4 sequences of 2048 tokens,
# the Mamba-2 paper's training context
MAMBA = "mamba2-1.3b"
SSD_BATCH, SSD_LEN = 4, 2048
# training: 2 sequences of 2048 tokens a step; the reference check at 2
# layers, the main path (Trainer) at 4, where params, grads and f32 Adam
# state stay resident (~16 B a param: ~42.5 GB; the 48 layers need ~236 GB,
# the case of LMS: the lms phases)
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_CHECK_LAYERS, TRAIN_CHECK_STEPS = 2, 3
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP = 4, 5, 3e-4, 1
# data-parallel training (DDL) over torch.distributed, its ranks sharing the
# one card over gloo: qwen2.5-14b at full width cut to 1 layer (1.83 B
# params, ~32 GB a rank with AdamW) on a 2x1x1 mesh (2 pods of 1 data rank)
# with the int8 pod hop, 2048 tokens a rank a step; then the smoke config on
# a 2x2x1 mesh, held against one rank on the global batch
DDL_LAYERS, DDL_STEPS, DDL_MESH = 1, 3, (2, 1, 1)
DDL_SMOKE_MESH, DDL_SMOKE_BATCH, DDL_SMOKE_SEQ = (2, 2, 1), 8, 128
DDL_AXES = ("pod", "data", "model")
# error feedback's path on the full-width ranks: one leaf of 2**24 + 3000
# elements reduced with EF (two pod-hop slices), after the training steps
DDL_EF_LEAF = (1 << 24) + 3000
DDL_TIMEOUT_S = 420
# the kernels of each route of the SSD scan and RMSNorm (csrc/ssd_scan_mma.cu,
# ssd_scan.cu, rmsnorm.cu); the first two SSD ones run on the tensor cores
SSD_MMA_KERNELS = ("ssd_chunk_state_kernel", "ssd_chunk_out_kernel")
SSD_KERNELS = {"tensor_core": (*SSD_MMA_KERNELS, "ssd_state_pass_kernel"),
               "cuda_core": ("ssd_scan_kernel",)}
RMSNORM_KERNELS = {"register": "rmsnorm_rows_kernel", "element": "rmsnorm_elements_kernel"}
# LMS on one card: the A/B of streamed against resident at 4 layers under a
# 16 GB planning budget (params and optimizer streamed, five activation
# classes offloaded, one recomputed), LMS_STEPS steps; the gate trains the
# most layers whose pinned state fits LMS_HOST_SHARE of MemAvailable. Its
# budget margin is lms_ab's measured peak over its plan's, plus the
# allowance; the host phase copies HOST_COPY_BYTES each way
LMS_AB_LAYERS, LMS_AB_BUDGET, LMS_STEPS = 4, 16 * 10**9, 3
LMS_HOST_SHARE, LMS_MARGIN_ALLOWANCE = 0.8, 2 * 10**9
CARD_BYTES = 80 * 10**9
HOST_COPY_BYTES, HOST_COPY_REPS = 1 << 30, 5
# torch.profiler sessions that time a kernel: at most this many for one
# number, the timed calls this far (s) inside each end of a session
PROFILE_ATTEMPTS, PROFILE_PAD_S = 8, 0.02


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S):
    """-> (bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the card's peak for their type (f32 on the CUDA cores
    by default; bf16 products on the tensor cores where the work is one)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profiled_events(fn, iters: int, accept, what: str, attempts: int = PROFILE_ATTEMPTS):
    """-> the CUDA events (kernels, copies, fills) of a torch.profiler
    session of `iters` calls of fn(), from the first session of up to
    `attempts` whose events `accept` takes. The calls sit PROFILE_PAD_S of
    host time inside each end of the session, so that a device timestamp
    placed a little off the host's clock still falls in it. A session the
    check rejects is reported (`profiler_miss`: what it recorded, and where
    its missing launches fall among the session's runtime launches) and run
    again after a pause: now and then a session on the card records only
    part of its device operations, or none, and the next one or two
    sessions may too."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        evs = list(prof.profiler.kineto_results.events())
        dev = [ev for ev in evs if ev.device_type() == DeviceType.CUDA]
        if accept(dev):
            return dev
        seen.append(len(dev))
        got = ({ev.correlation_id() for ev in dev}
               | {ev.linked_correlation_id() for ev in dev})
        launches = sorted(ev.correlation_id() for ev in evs
                          if ev.device_type() == DeviceType.CPU
                          and ev.name().startswith("cuda") and ev.correlation_id())
        emit({"phase": "profiler_miss", "kernel": what, "calls": iters,
              "recorded": len(dev), "runtime_launches": len(launches),
              "missing_at": [j for j, c in enumerate(launches) if c not in got][:40]})
        time.sleep(0.5 * (attempt + 1))
    raise AssertionError(f"{what}: the profiler recorded {seen} device operations for "
                         f"{iters} calls in {attempts} sessions")


def device_ms(fn, kernel: str, iters: int = 20) -> float:
    """Mean device time of one launch of the kernel whose name contains
    `kernel`, over `iters` calls of fn() under torch.profiler: the kernel's
    own time on the card. (Back-to-back timing by CUDA events reads the
    wrapper's host time instead where that is the longer.) Only a session
    that recorded all `iters` launches counts."""
    dev = _profiled_events(
        fn, iters, lambda dev: sum(kernel in ev.name() for ev in dev) == iters, kernel)
    durs = [ev.duration_ns() for ev in dev if kernel in ev.name()]
    return sum(durs) / len(durs) / 1e6


def device_ms_per_call(fn, iters: int = 20):
    """Mean device time of one call of fn(), summed over every CUDA kernel
    (and copy or fill) the call launches, over `iters` calls under
    torch.profiler: a call that launches a split kernel and its combine,
    or SDPA's own kernels, is timed whole, and the wrapper's host time is
    left out. -> (ms, device operations a call, {kernel: ms a call}). Only
    a session whose count of operations is a positive multiple of `iters`
    counts."""
    import re
    evs = _profiled_events(fn, iters, lambda dev: dev and len(dev) % iters == 0,
                           "per call")
    by = {}
    for ev in evs:   # short names: "fd_mma_kernel", "fd_combine_kernel", ...
        name = re.sub(r"[<(].*", "", ev.name().replace("(anonymous namespace)", ""))
        name = name.split("::")[-1].split()[-1]
        by[name] = by.get(name, 0.0) + ev.duration_ns() / iters / 1e6
    return sum(by.values()), len(evs) // iters, by


def bf16_row_ulp(o):
    """One bf16 ulp (8 significand bits) at each output row's largest |o|.
    Per row, not per element: an output near zero is a sum that cancels,
    and two f32 sums in different orders differ there by far more ulps of
    the tiny result than the result is worth."""
    import torch
    top = o.abs().float().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(top)) - 7)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def device_phase():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: chip_smoke.py runs on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    line = smi.splitlines()[0]
    print(line, flush=True)
    # f32 matmuls in the plain versions run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    emit({"phase": "device", "nvidia_smi": line,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return line


def build_phase():
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    _build.extension()
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "route": "torch.utils.cpp_extension.load",
          "sources": [f"src/repro_torch/kernels/csrc/{s}" for s in _build.SOURCES],
          "cuda_flags": list(_build.CUDA_FLAGS)})
    return sass_phase()


def sass_phase():
    """The tensor-core instructions in the built extension's SASS, from
    `cuobjdump -sass`: HGMMA (wgmma) by instance of the flash-attention
    kernel (`fa_wgmma_kernel<D>`), HMMA (mma.sync) in the decode kernel
    (`fd_mma_kernel`), and HMMA and HGMMA in the SSD scan's two product
    kernels (`ssd_chunk_state_kernel`, `ssd_chunk_out_kernel`). Fails if any
    has none, since each of those routes must run on the tensor cores."""
    import re
    import shutil
    from repro_torch.kernels import _build
    lib = sorted(_build.BUILD_DIR.glob("*.so"))[0]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, hmma, fn = {}, 0, None
    ssd = {name: {"HMMA": 0, "HGMMA": 0} for name in SSD_MMA_KERNELS}
    for text in sass.splitlines():
        if "Function :" in text:
            fn = text.split("Function :", 1)[1].strip()
        elif fn and "fa_wgmma_kernel" in fn and "HGMMA" in text:
            d = re.search(r"fa_wgmma_kernelILi(\d+)E", fn)
            key = f"head_dim_{d.group(1)}" if d else fn
            counts[key] = counts.get(key, 0) + 1
        elif fn and "fd_mma_kernel" in fn and "HMMA" in text:
            hmma += 1
        elif fn and ("HMMA" in text or "HGMMA" in text):
            for name in ssd:
                if name in fn:
                    ssd[name]["HGMMA" if "HGMMA" in text else "HMMA"] += 1
    row = {"phase": "sass", "library": os.path.relpath(lib, ROOT),
           "kernel": "fa_wgmma_kernel", "hgmma": counts, "hgmma_total": sum(counts.values()),
           "decode_kernel": "fd_mma_kernel", "decode_hmma_total": hmma, "ssd_tensor_core": ssd}
    emit(row)
    if not row["hgmma_total"]:
        raise AssertionError("the tensor-core flash-attention kernel has no HGMMA in its SASS")
    if not hmma:
        raise AssertionError("the tensor-core decode kernel has no HMMA in its SASS")
    if not all(sum(n.values()) for n in ssd.values()):
        raise AssertionError(f"a tensor-core SSD kernel has no HMMA or HGMMA in its SASS: {ssd}")
    return row


def _decode_inputs(kv_lens, seed, paged: bool, pages=None, max_pages=None, smax=None,
                   heads=H, kv_heads=K, d=D, dtype="bfloat16"):
    """q + caches of `dtype` on the card. Paged: arenas and a scrambled table,
    each slot owning distinct random pages in random order; empty slots
    and unused entries point at the null page (the last row); spare pages
    and the null page hold garbage. `pages` (arena rows less the null page)
    and `max_pages` (table width) default to what kv_lens need, plus 8
    spare pages. Contiguous: caches [B, smax, kv_heads, d] whose positions
    past each kv_len hold garbage. -> (q, k, v, kv_len, table or None)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    b = len(kv_lens)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    dt = getattr(torch, dtype)
    q = torch.randn((b, heads, d), generator=gen, device=dev).to(dt)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    if not paged:
        assert max(kv_lens) <= smax
        k = torch.randn((b, smax, kv_heads, d), generator=gen, device=dev).to(dt)
        v = torch.randn((b, smax, kv_heads, d), generator=gen, device=dev).to(dt)
        return q, k, v, kvl, None
    need = sum(-(-n // PAGE) for n in kv_lens)
    max_pages = max_pages or -(-max(kv_lens) // PAGE)
    pages = pages or need + 8
    assert need <= pages and max(kv_lens) <= max_pages * PAGE
    tab = np.full((b, max_pages), pages, np.int32)
    perm = rng.permutation(pages)
    nxt = 0
    for i, n in enumerate(kv_lens):
        need = -(-n // PAGE)
        tab[i, :need] = perm[nxt:nxt + need]
        nxt += need
    k = torch.randn((pages + 1, PAGE, kv_heads, d), generator=gen, device=dev).to(dt)
    v = torch.randn((pages + 1, PAGE, kv_heads, d), generator=gen, device=dev).to(dt)
    return q, k, v, kvl, torch.from_numpy(tab).to(dev)


def _quantize_cache(x):
    """A cache [..., D] as int8 codes of its shape and f32 scales [...], by
    the plain quantizer."""
    from repro_torch.kernels.quantize.ref import quantize_ref
    c, s = quantize_ref(x.reshape(-1, x.shape[-1]))
    return c.reshape(x.shape), s.reshape(x.shape[:-1])


def _sdpa(q, kc, vc, kv_len):
    """One SDPA call (GQA) on slot-contiguous caches, the yardstick: -> a
    function of no arguments that makes it."""
    import torch
    import torch.nn.functional as F
    s = kc.shape[1]
    qs = q[:, :, None]                                   # [B,H,1,D]
    ks, vs = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(s, device=q.device)[None, :] < kv_len[:, None].long()
            )[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)


# What each kernel's launch depends on besides the data: a run of a path
# fails on a call whose signature no kernel phase checked.

def attention_route(q) -> str:
    """The route of kernel #1 a CUDA call should take, as the wrapper's
    docstring states it: bf16 at head_dim 64, 128 or 256 on the tensor
    cores (wgmma), everything else on the CUDA cores."""
    import torch
    return ("wgmma" if q.dtype == torch.bfloat16 and q.shape[-1] in (64, 128, 256)
            else "cuda_core")


def decode_route(q, k) -> str:
    """The route of kernels #2 and #3 a CUDA call should take, as the
    wrappers' docstrings state it: bf16 q at head_dim 64, 128 or 256 with
    at most 16 query heads per kv head on the tensor cores (mma.sync),
    everything else on the CUDA cores. q [B,H,D]; k the cache or arena."""
    import torch
    return ("tensor_core" if q.dtype == torch.bfloat16 and q.shape[-1] in (64, 128, 256)
            and q.shape[1] // k.shape[2] <= 16 else "cuda_core")


def attention_sig(q, k, causal, window, q_offset):
    if q_offset is None:
        q_offset = k.shape[1] - q.shape[1] if causal else 0
    return ("flash_attention", tuple(q.shape), str(q.dtype), tuple(k.shape),
            bool(causal), int(window), int(q_offset))


def decode_sig(q, k, page_table=None):
    """q [B,H,D]; k the cache (or arena, with its table)."""
    if page_table is None:
        return ("flash_decode", tuple(q.shape), str(q.dtype), tuple(k.shape), str(k.dtype))
    return ("flash_decode_paged", tuple(q.shape), str(q.dtype),
            tuple(k.shape), str(k.dtype), tuple(page_table.shape))


def quantize_sig(x):
    return ("quantize_rows", tuple(x.shape), str(x.dtype))


def dequantize_sig(q, out_dtype):
    return ("dequantize_rows", tuple(q.shape), str(out_dtype))


def quantize_kv_write_sig(k, codes, page_table):
    """k [B,1,K,D] is read through its strides; the cache is the arena
    (with its table) or slot-contiguous (no table)."""
    return ("quantize_kv_write", tuple(k.shape), str(k.dtype), tuple(k.stride()),
            tuple(codes.shape), None if page_table is None else tuple(page_table.shape))


def dequantize_sum_sig(q, n):
    return ("dequantize_sum_rows", tuple(q.shape), int(n))


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def quantize_path(x) -> str:
    """The path of the quantizer a CUDA call of `quantize` takes, as
    `q_ops.quantize_layout` chooses it ("vector": the row held in
    registers, or "element"); its codes are a fresh, aligned tensor."""
    from repro_torch.kernels.quantize.ops import quantize_layout
    return ("vector" if quantize_layout(x.shape[-1], x.element_size(), _aligned(x))
            else "element")


def kv_write_path(k, v, k_codes, v_codes) -> str:
    """The path of the fused decode-step write: `quantize_layout` at width
    D, with both rows' strides and every pointer aligned."""
    from repro_torch.kernels.quantize.ops import quantize_layout
    vec = 16 // k.element_size()
    aligned = (_aligned(k, v, k_codes, v_codes)
               and all(t.stride(i) % vec == 0 for t in (k, v) for i in (0, 2)))
    return ("vector" if quantize_layout(k.shape[-1], k.element_size(), aligned)
            else "element")


def dequantize_path(q) -> str:
    """The dequantizers' path (`q_ops.dequantize_layout`), with the output
    a fresh, aligned tensor."""
    from repro_torch.kernels.quantize.ops import dequantize_layout
    return "vector" if dequantize_layout(q.shape[-1], _aligned(q)) else "element"


def path_launches(launcher) -> dict:
    """A quantize launcher's counts: all, and by path."""
    return {"launches": launcher.launches, "vector": launcher.vector_launches,
            "element": launcher.element_launches}


def path_delta(launcher, before: dict, path: str) -> bool:
    """True iff the launcher counted exactly one launch since `before`, on
    `path`."""
    after = path_launches(launcher)
    want = {"launches": 1, "vector": int(path == "vector"), "element": int(path == "element")}
    return {k: after[k] - before[k] for k in after} == want


def rmsnorm_sig(x, eps):
    """x [..., d] as the kernel sees it: [rows, d]."""
    return ("rmsnorm", int(x.numel() // x.shape[-1]), int(x.shape[-1]), str(x.dtype),
            float(eps))


def ssd_sig(x, B, chunk):
    """x, B and C are read through their strides: those are part of it."""
    return ("ssd_scan", tuple(x.shape), str(x.dtype), tuple(x.stride()), tuple(B.shape),
            tuple(B.stride()), int(chunk))


def rmsnorm_path(x, scale) -> str:
    """The path of the RMSNorm kernel a CUDA call of `rmsnorm` takes, as
    `rms_ops.rmsnorm_layout` chooses it: "register" (the row held in
    registers) or "element". A non-contiguous x is copied, so aligned."""
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_layout
    aligned = (not x.is_contiguous() or x.data_ptr() % 16 == 0) and scale.data_ptr() % 16 == 0
    return ("register" if rmsnorm_layout(x.shape[-1], x.element_size(), aligned)
            else "element")


def decode_kernel_phase(shape: str, kv_lens, int8: bool, seed: int, checked: set,
                        paged: bool = True, pages=None, max_pages=None, smax=None, *,
                        heads=H, kv_heads=K, d=D, dtype="bfloat16"):
    """One decode kernel (paged, or slot-contiguous with `smax` positions)
    against its plain version: within one bf16 ulp of each output row's
    largest |o| (f32: 1e-5 of it), and exact zeros for kv_len 0. The call
    must take the route `decode_route` names; the row reports it, the
    splits, the device time of one call (every kernel it launches, by
    torch.profiler) and of SDPA on the same values, and the back-to-back
    CUDA-event time (`wall_ms`, which reads the host's time where that is
    the longer)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (flash_decode_paged_ref,
                                                         flash_decode_ref, gather_pages)
    q, k, v, kvl, tab = _decode_inputs(kv_lens, seed, paged, pages, max_pages, smax,
                                       heads=heads, kv_heads=kv_heads, d=d, dtype=dtype)
    kw = {}
    if int8:
        (k, ks), (v, vs) = _quantize_cache(k), _quantize_cache(v)
        kw = {"k_scale": ks, "v_scale": vs}
    launcher = fa_ops.flash_decode_paged_cuda if paged else fa_ops.flash_decode_cuda
    if paged:
        def kernel():
            return launcher(q, k, v, kvl, tab, **kw)

        def plain():
            return flash_decode_paged_ref(q, k, v, kvl, tab, **kw)

        def dense(x):
            return gather_pages(x, tab)
    else:
        def kernel():
            return launcher(q, k, v, kvl, **kw)

        def plain():
            return flash_decode_ref(q, k, v, kvl, **kw)

        def dense(x):
            return x
    counters = {r: f"{r}_launches" for r in ("tensor_core", "cuda_core")}
    before = {r: getattr(launcher, a) for r, a in counters.items()}
    out = kernel()
    torch.cuda.synchronize()
    took = [r for r, a in counters.items() if getattr(launcher, a) > before[r]]
    name = (("flash_decode_paged_" if paged else "flash_decode_")
            + ("int8" if int8 else {"bfloat16": "bf16", "float32": "f32"}[dtype]))
    if took != [decode_route(q, k)]:
        raise AssertionError(f"{name} {shape}: took route {took}, expected "
                             f"{decode_route(q, k)}")
    want = plain()
    err = (out.float() - want.float()).abs()
    if dtype == "bfloat16":
        unit, tol = bf16_row_ulp(want), 1.0
    else:
        unit, tol = want.abs().float().amax(dim=-1, keepdim=True).clamp_min(1e-30), 1e-5
    worst = (err / unit).max().item()
    zeros = bool((out[kvl == 0] == 0).all())
    if not (worst <= tol and zeros and torch.isfinite(out).all()):
        raise AssertionError(f"{name} {shape}: kernel vs plain max |diff| "
                             f"{err.max().item()} ({worst} of the tolerance unit), "
                             f"zeros={zeros}")
    checked.add(decode_sig(q, k, tab))
    capacity = tab.shape[1] * PAGE if paged else smax
    b = len(kv_lens)
    splits = (fa_ops.decode_splits(b, kv_heads, capacity, fa_ops._sm_count(q.device))[0]
              if took[0] == "tensor_core" else 1)
    kernel_ms, device_ops, by_kernel = device_ms_per_call(kernel)
    wall_ms = time_ms(kernel)
    plain_ms = time_ms(plain, iters=10, warmup=2)
    # the yardstick sees the same values as slot-contiguous caches of q's type
    kc, vc = dense(k), dense(v)
    if int8:
        kc = (kc.float() * dense(ks)[..., None]).to(q.dtype)
        vc = (vc.float() * dense(vs)[..., None]).to(q.dtype)
    sdpa = _sdpa(q, kc, vc, kvl)
    library_ms, library_ops, _ = device_ms_per_call(sdpa)
    library_wall_ms = time_ms(sdpa)
    tokens = sum(kv_lens)
    esize = q.element_size()
    kv_bytes = tokens * kv_heads * d * (1 if int8 else esize) * 2
    if int8:
        kv_bytes += tokens * kv_heads * 4 * 2
    table_bytes = sum(-(-n // PAGE) for n in kv_lens) * 4 if paged else 0
    nbytes = 2 * b * heads * d * esize + kv_bytes + table_bytes + b * 4
    flops = 4 * heads * d * tokens + (2 * kv_heads * d * tokens * 2 if int8 else 0)
    peak = BF16_TENSOR_FLOPS_PER_S if took[0] == "tensor_core" else F32_FLOPS_PER_S
    bound_ms, bound_by = bound(nbytes, flops, peak)
    row = {"phase": "kernel", "kernel": name, "shape": shape, "route": took[0],
           "splits": splits, "device_ops_per_call": device_ops,
           "device_ms_by_kernel": by_kernel, "slots": b,
           "heads": heads, "kv_heads": kv_heads, "head_dim": d, "dtype": dtype,
           "cache": list(k.shape), "kv_len_min": min(kv_lens), "kv_len_max": max(kv_lens),
           "kv_tokens": tokens, "max_abs_err": err.max().item(),
           "max_err_over_unit": worst,
           "tolerance": ("1 bf16 ulp of each row's max |plain|" if dtype == "bfloat16"
                         else "1e-5 of each row's max |plain|"),
           "kernel_ms": kernel_ms, "wall_ms": wall_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / kernel_ms,
           "library_ms": library_ms, "library_ops_per_call": library_ops,
           "library_wall_ms": library_wall_ms,
           "library": "F.scaled_dot_product_attention(enable_gqa=True)",
           "timing": "kernel_ms, library_ms: device time a call (torch.profiler); "
                     "wall_ms, library_wall_ms, plain_ms: CUDA events, back to back"}
    if paged:
        row["table_width"] = tab.shape[1]
    emit(row)
    return row


def decode_sync_phase(line):
    """The decode entries (`flash_decode_paged`, `flash_decode`) at the
    engine's shape and at long context, bf16 and int8, under
    torch.cuda.set_sync_debug_mode("error"), which raises on any host
    synchronisation inside the call; each output equals, bitwise, that of
    the same call made outside the mode."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    rng = np.random.default_rng(SEED + 6)
    long_lens = [int(n) for n in rng.integers(2048, 4097, 16)]
    cases = []
    for shape, lens, paged, kw in (
            ("engine", [160, 97, 0, 33], True,
             {"pages": DEVICE_PAGES, "max_pages": MAX_LEN // PAGE}),
            ("static_decode", [144] * REQUESTS, False, {"smax": MAX_LEN}),
            ("long_context", long_lens, True, {}),
            ("long_context", long_lens, False, {"smax": 4096})):
        for int8 in (False, True):
            q, k, v, kvl, tab = _decode_inputs(lens, 60 + len(cases), paged, **kw)
            extra = {}
            if int8:
                (k, ks), (v, vs) = _quantize_cache(k), _quantize_cache(v)
                extra = {"k_scale": ks, "v_scale": vs}
            call = ((lambda q=q, k=k, v=v, kvl=kvl, tab=tab, extra=extra:
                     fa_ops.flash_decode_paged(q, k, v, kvl, tab, **extra)) if paged else
                    (lambda q=q, k=k, v=v, kvl=kvl, extra=extra:
                     fa_ops.flash_decode(q, k, v, kvl, **extra)))
            cases.append((f"{'paged' if paged else 'contiguous'}_{shape}_"
                          f"{'int8' if int8 else 'bf16'}", call))
    outside = {name: call() for name, call in cases}
    torch.cuda.synchronize()
    inside = {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name, call in cases:
            inside[name] = call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    same = {name: bool(torch.equal(inside[name], outside[name])) for name in inside}
    row = {"phase": "decode_sync_debug", "card": line, "mode": "error",
           "calls": list(inside), "bitwise_equal": same}
    emit(row)
    if not all(same.values()):
        raise AssertionError(f"decode under sync debug: outputs differ {same}")
    return row


def f32_decode_phase(line, checked):
    """The decode kernels' CUDA-core route on its own path. No configuration
    of the repo reaches it from a model (every serve path is bf16 at
    head_dim 128), so its path is the decode entry `flash_decode` on f32
    tensors at qwen2.5-14b's attention width and the static loop's shape
    (q [8, 40, 128], caches [8, 160, 8, 128], kv_len 144), counts reset just
    before and read just after: one launch, on the CUDA cores, of a shape
    the kernel phases checked, and a finite f32 output."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    q, k, v, kvl, _ = _decode_inputs([144] * REQUESTS, SEED + 7, False, smax=MAX_LEN,
                                     dtype="float32")
    with launch_signatures() as (seen, calls, launches):
        o = fa_ops.flash_decode(q, k, v, kvl)
        torch.cuda.synchronize()
    unchecked = sorted(seen - checked)
    checks = {
        "one_launch": launches["flash_decode"] == 1,
        "took_cuda_core": launches["flash_decode_cuda_core"] == 1,
        "every_launch_recorded": calls == launches,
        "every_launch_shape_checked": not unchecked,
        "f32_output": o.shape == q.shape and o.dtype == torch.float32,
        "finite": bool(torch.isfinite(o).all()),
    }
    row = {"phase": "f32_decode", "q": list(q.shape), "kv": list(k.shape), "card": line,
           "launches": launches, "launch_signatures": sorted(seen),
           "unchecked_signatures": unchecked, "checks": checks}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"f32 decode: failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def attention_kernel_phase(shape: str, b: int, sq: int, seed: int, checked: set, *,
                           skv=None, heads=H, kv_heads=K, d=D, dtype="bfloat16",
                           window=0, q_offset=0):
    """Kernel #1 (causal) against its plain version: within one bf16 ulp of
    each output row's largest |o| (f32 inputs: 1e-5 of it), every row; a
    row with no visible key holds the mean of v over all keys of its kv
    head (as the JAX oracle's), which it is held to by the same rule. The
    call must take the route `attention_route` names (bf16 at head_dim 64,
    128 or 256: wgmma; else the CUDA cores); the row reports it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                         flash_attention_ref)
    skv = skv or sq
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shp, generator=gen, device="cuda").to(dt)
               for shp in ((b, sq, heads, d), (b, skv, kv_heads, d), (b, skv, kv_heads, d)))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))   # kernel layout

    def kernel():
        return flash_attention_cuda(q, k, v, **kw)

    def plain():
        return flash_attention_ref(qt, kt, vt, **kw)
    counters = {r: f"{r}_launches" for r in ("wgmma", "cuda_core")}
    before = {r: getattr(flash_attention_cuda, a) for r, a in counters.items()}
    out = kernel()
    torch.cuda.synchronize()
    took = [r for r, a in counters.items() if getattr(flash_attention_cuda, a) > before[r]]
    if took != [attention_route(q)]:
        raise AssertionError(f"flash_attention {shape}: took route {took}, expected "
                             f"{attention_route(q)}")
    want = plain().transpose(1, 2)
    err = (out.float() - want.float()).abs()
    if dtype == "bfloat16":
        unit, tol = bf16_row_ulp(want), 1.0
    else:
        unit, tol = want.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30), 1e-5
    worst = (err / unit).max().item()
    off = k.shape[1] - sq if q_offset is None else q_offset
    mask = attention_mask(sq, skv, "cuda", causal=True, window=window, q_offset=off)
    empty = ~mask.any(dim=-1)                                     # rows with no key
    # [B, Sq, H, D]: query head h reads kv head h // (H / K)
    vmean = v.float().mean(dim=1).repeat_interleave(heads // kv_heads, dim=1)
    no_key_err = (out[:, empty].float() - vmean[:, None]).abs()
    no_key_worst = (no_key_err / unit[:, empty]).max().item() if bool(empty.any()) else 0.0
    if not (worst <= tol and no_key_worst <= tol and torch.isfinite(out).all()):
        raise AssertionError(f"flash_attention {shape}: kernel vs plain max |diff| "
                             f"{err.max().item()} ({worst} of the tolerance unit), rows "
                             f"without a key {no_key_worst} units from the mean of v")
    checked.add(attention_sig(q, k, True, window, q_offset))
    kernel_ms = time_ms(kernel, iters=20, warmup=3)
    plain_ms = time_ms(plain, iters=5, warmup=1)
    if q_offset == 0 and window == 0 and sq == skv:
        sdpa_kw = {"is_causal": True}
    else:   # SDPA's causal mask is top-left aligned: give it ours
        sdpa_kw = {"attn_mask": mask}
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True, **sdpa_kw), iters=20, warmup=3)
    pairs = int(mask.sum().item())                 # (query, key) pairs this run computes
    esize = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * esize
    flops = 4 * d * pairs * b * heads
    peak = BF16_TENSOR_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
    bound_ms, bound_by = bound(nbytes, flops, peak)
    row = {"phase": "kernel", "kernel": "flash_attention_fwd", "shape": shape,
           "route": took[0], "q": list(q.shape), "kv": list(k.shape), "dtype": dtype,
           "window": window,
           "q_offset": q_offset, "pairs": pairs * b * heads, "gflop": flops / 1e9,
           "rows_without_key": int(empty.sum().item()),
           "no_key_rows_vs_mean_of_v_over_unit": no_key_worst, "max_abs_err": err.max().item(),
           "max_err_over_unit": worst,
           "tolerance": ("1 bf16 ulp of each row's max |plain|" if dtype == "bfloat16"
                         else "1e-5 of each row's max |plain|"),
           "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_peak": peak, "library_ms": library_ms,
           "library": "F.scaled_dot_product_attention(enable_gqa=True, "
                      + ("is_causal=True)" if "is_causal" in sdpa_kw else "attn_mask=mask)"),
           "kernel_tflop_s": flops / kernel_ms / 1e9}
    emit(row)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def _quantize_input(rows: int, cols: int, dtype: str, seed: int, nonfinite: bool = False):
    """Rows of very different sizes, the first all zeros (scale 1). With
    `nonfinite`, rows 1-5 hold a NaN, +inf, -inf, NaN with both infinities,
    and only NaN (a NaN or an infinity in a gradient on DDL's pod hop, or
    in a k/v row on the int8 serve path)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((rows, cols), generator=gen, device="cuda")
         * torch.rand((rows, 1), generator=gen, device="cuda") * 4).to(getattr(torch, dtype))
    x[0] = 0
    if nonfinite:
        nan, inf = float("nan"), float("inf")
        x[1, 3] = nan
        x[2, 0] = inf
        x[3, cols - 1] = -inf
        x[4, :3] = torch.tensor([nan, inf, -inf])
        x[5] = nan
    return x


def quantize_kernel_phase(shape: str, rows: int, seed: int, checked: set, *, cols: int = D,
                          dtype: str = "bfloat16", timed: bool = True, nonfinite: bool = False,
                          offset: int = 0):
    """The quantizer against its plain version, bitwise (codes and scales),
    asserting the path it took; timed unless `timed` is False (a shape
    checked only for its launch signature); with `nonfinite`, on rows
    holding NaN and infinities; with `offset`, on rows that start that many
    elements into their buffer (unaligned: the element path)."""
    import torch
    from repro_torch.kernels.quantize.ops import quantize_cuda
    from repro_torch.kernels.quantize.ref import quantize_ref
    x = _quantize_input(rows, cols, dtype, seed, nonfinite)
    if offset:
        buf = torch.empty(rows * cols + offset, dtype=x.dtype, device="cuda")
        x = buf[offset:].view(rows, cols).copy_(x)
    path = quantize_path(x)
    before = path_launches(quantize_cuda)
    q, s = quantize_cuda(x)
    torch.cuda.synchronize()
    if not path_delta(quantize_cuda, before, path):
        raise AssertionError(f"quantize {shape}: did not take the {path} path")
    pq, ps = quantize_ref(x)
    if not (torch.equal(q, pq) and torch.equal(s.view(torch.int32), ps.view(torch.int32))):
        raise AssertionError(f"quantize {shape}: codes or scales differ from the "
                             "plain version")
    checked.add(quantize_sig(x))
    row = {"phase": "kernel", "kernel": "quantize_rows", "shape": shape, "rows": rows,
           "cols": cols, "dtype": dtype, "path": path,
           "max_abs_err": float((q.float() - pq.float()).abs().max()),
           "tolerance": "bitwise"}
    if nonfinite:
        row["nonfinite_rows"] = {"scales": [str(x) for x in s[1:6].tolist()],
                                 "codes_of_nan_elements": q[x.isnan()].unique().tolist()}
    if timed:
        # the launch is shorter than its wrapper's host time: back-to-back
        # events read the host, the profiler the kernel itself
        back_to_back_ms = time_ms(lambda: quantize_cuda(x))
        kernel_ms = device_ms(lambda: quantize_cuda(x), "quantize_rows_kernel")
        plain_ms = time_ms(lambda: quantize_ref(x), iters=20)
        bound_ms, bound_by = bound(rows * cols * x.element_size() + rows * cols + rows * 4,
                                   rows * cols * 5)
        row.update({"kernel_ms": kernel_ms, "kernel_ms_by": "torch.profiler",
                    "back_to_back_ms": back_to_back_ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    emit(row)
    return row


def dequantize_kernel_phase(shape: str, rows: int, cols: int, seed: int, checked: set, *,
                            out_dtype: str = "float32", timed: bool = True):
    """The dequantizer against its plain version, bitwise, on the codes and
    scales of the quantizer's plain version; timed unless `timed` is False.
    Its bound is bytes: 1 B of code in and 4 (f32) or 2 (bf16) B out an
    element, 4 B of scale a row, for one multiply an element. No single
    PyTorch call computes it (`q.float() * scale[:, None]` is two passes):
    library_ms is null."""
    import torch
    from repro_torch.kernels.quantize.ops import dequantize_cuda
    from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_ref
    q, s = quantize_ref(_quantize_input(rows, cols, "float32", seed))
    dt = getattr(torch, out_dtype)
    path = dequantize_path(q)
    before = path_launches(dequantize_cuda)
    out = dequantize_cuda(q, s, dt)
    torch.cuda.synchronize()
    if not path_delta(dequantize_cuda, before, path):
        raise AssertionError(f"dequantize {shape}: did not take the {path} path")
    want = dequantize_ref(q, s, dt)
    ints = torch.int32 if dt == torch.float32 else torch.int16
    if not torch.equal(out.view(ints), want.view(ints)):
        raise AssertionError(f"dequantize {shape}: output differs from the plain version")
    checked.add(dequantize_sig(q, dt))
    row = {"phase": "kernel", "kernel": "dequantize_rows", "shape": shape, "rows": rows,
           "cols": cols, "out_dtype": out_dtype, "path": path,
           "max_abs_err": float((out.float() - want.float()).abs().max()),
           "tolerance": "bitwise"}
    if timed:
        back_to_back_ms = time_ms(lambda: dequantize_cuda(q, s, dt))
        kernel_ms = device_ms(lambda: dequantize_cuda(q, s, dt), "dequantize_rows")
        plain_ms = time_ms(lambda: dequantize_ref(q, s, dt), iters=20)
        bound_ms, bound_by = bound(rows * cols * (1 + out.element_size()) + rows * 4,
                                   rows * cols)
        row.update({"kernel_ms": kernel_ms, "kernel_ms_by": "torch.profiler",
                    "back_to_back_ms": back_to_back_ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    emit(row)
    del q, s, out, want
    return row


def _kv_write_inputs(b: int, paged: bool, seed: int, dtype: str = "bfloat16"):
    """The decode step's k/v rows [b, 1, K, D] (slot 0's second kv head of
    k all NaN, slot 1's v holding one NaN), int8 caches with arbitrary
    contents (the engine's arena of DEVICE_PAGES + 1 pages of PAGE for 4
    slots, MAX_LEN / PAGE pages a slot beyond; slot-contiguous [b,
    MAX_LEN]), positions with writes at a page's start and end (and past
    MAX_LEN on slot-contiguous caches), every fourth slot inactive, and,
    paged, a table as the pool keeps it: each active slot's pages distinct
    and scrambled, the rest on the null page (the arena's last)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    max_pages = MAX_LEN // PAGE
    if paged:
        shape = (DEVICE_PAGES + 1 if b <= SLOTS else b * max_pages + 1, PAGE)
        starts = [PAGE, PAGE - 1, 0, MAX_LEN - 1]
    else:
        shape = (b, MAX_LEN)
        starts = [2 * MAX_LEN, PAGE - 1, 0, MAX_LEN - 1, PAGE]
    pos = [starts[i % len(starts)] for i in range(b)]
    act = [i % 4 != 2 for i in range(b)]
    k, v = ((torch.randn((b, 1, K, D), generator=gen, device="cuda") * 3).to(getattr(torch, dtype))
            for _ in range(2))
    k[0, 0, 1] = float("nan")
    v[min(1, b - 1), 0, 0, 5] = float("nan")
    caches = [torch.randint(-127, 128, shape + (K, D), generator=gen, device="cuda",
                            dtype=torch.int8) for _ in range(2)]
    caches += [torch.rand(shape + (K,), generator=gen, device="cuda") for _ in range(2)]
    table = None
    if paged:
        null = shape[0] - 1
        table = torch.full((b, max_pages), null, dtype=torch.int32)
        perm = torch.randperm(null, generator=torch.Generator().manual_seed(seed))
        nxt = 0
        for i in range(b):
            if act[i]:
                need = pos[i] // PAGE + 1
                table[i, :need] = perm[nxt:nxt + need]
                nxt += need
        table = table.cuda()
    positions = torch.tensor(pos, dtype=torch.int32, device="cuda")
    active = torch.tensor(act, device="cuda")
    return k, v, caches, table, positions, active


def _kv_write_composition(k, v, caches, table, positions, active):
    """The decode step's int8 write as it ran before the fused kernel:
    each of k and v through the quantize kernel, then codes and scales
    written by four gather/where/scatter passes (`paging.paged_write`, or
    `_slot_write` at min(pos, Smax - 1)). A yardstick only."""
    import torch
    from repro_torch.kernels.quantize.ops import quantize_cuda
    from repro_torch.models import paging
    from repro_torch.models.transformer import _slot_write
    kc, vc, ks, vs = caches
    (kq, kss), (vq, vss) = (quantize_cuda(x.reshape(-1, x.shape[-1])) for x in (k, v))
    b = k.shape[0]
    new = {"k": kq.reshape(k.shape), "v": vq.reshape(v.shape),
           "ks": kss.reshape(b, 1, -1), "vs": vss.reshape(b, 1, -1)}
    slots = None if table is not None else torch.clamp(positions, max=kc.shape[1] - 1)
    for cache, key in ((ks, "ks"), (vs, "vs"), (kc, "k"), (vc, "v")):
        if table is None:
            _slot_write(cache, new[key], slots, active)
        else:
            paging.paged_write(cache, new[key], table, positions, active, kc.shape[1])


def quantize_kv_write_kernel_phase(shape: str, b: int, paged: bool, seed: int, checked: set,
                                   *, dtype: str = "bfloat16"):
    """The fused decode-step write against its plain version on copies of
    the same caches, bitwise on every byte of codes and scales (inactive
    slots, NaN rows, a page's first and last position, positions past
    Smax), under torch.cuda.set_sync_debug_mode("error") (the wrapper reads
    no device value on the host), asserting its path; timed by
    torch.profiler beside the composition it replaces (two quantize
    launches and four plain writes: its device time and device operations
    a call). Bound: bytes, k and v read and codes and scales written."""
    import torch
    from repro_torch.kernels.quantize.ops import quantize_kv_write_cuda
    from repro_torch.kernels.quantize.ref import quantize_kv_write_ref
    k, v, caches, table, positions, active = _kv_write_inputs(b, paged, seed, dtype)
    want = [c.clone() for c in caches]
    quantize_kv_write_ref(k, v, *want, table, positions, active)
    got = [c.clone() for c in caches]
    path = kv_write_path(k, v, got[0], got[1])
    before = path_launches(quantize_kv_write_cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        quantize_kv_write_cuda(k, v, *got, table, positions, active)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not path_delta(quantize_kv_write_cuda, before, path):
        raise AssertionError(f"quantize_kv_write {shape}: did not take the {path} path")
    same = all(torch.equal(g.view(torch.uint8) if g.dtype == torch.int8 else g.view(torch.int32),
                           w.view(torch.uint8) if w.dtype == torch.int8 else w.view(torch.int32))
               for g, w in zip(got, want))
    if not same:
        raise AssertionError(f"quantize_kv_write {shape}: caches differ from the plain version")
    checked.add(quantize_kv_write_sig(k, got[0], table))
    kernel_ms, ops, by = device_ms_per_call(
        lambda: quantize_kv_write_cuda(k, v, *got, table, positions, active))
    comp_ms, comp_ops, _ = device_ms_per_call(
        lambda: _kv_write_composition(k, v, got, table, positions, active))
    plain_ms = time_ms(lambda: quantize_kv_write_ref(k, v, *got, table, positions, active),
                       iters=20)
    elems = 2 * b * K * D
    bound_ms, bound_by = bound(elems * k.element_size() + elems + 2 * b * K * 4
                               + b * (4 + 1 + (4 if paged else 0)), elems * 5)
    row = {"phase": "kernel", "kernel": "quantize_kv_write", "shape": shape, "slots": b,
           "kv_heads": K, "head_dim": D, "paged": paged, "dtype": dtype, "path": path,
           "max_abs_err": 0.0, "tolerance": "bitwise", "sync_debug": "error",
           "kernel_ms": kernel_ms, "kernel_ms_by": "torch.profiler", "device_ops": ops,
           "by_kernel": by, "composition_ms": comp_ms, "composition_device_ops": comp_ops,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None}
    emit(row)
    return row


def dequantize_sum_kernel_phase(shape: str, pods: int, rows: int, n: int, seed: int,
                                checked: set, *, cols: int = 1024, timed: bool = True):
    """The pod sum against its plain version (the pod hop's loop), bitwise,
    on the codes and scales of `pods` pods' quantized rows (one pod's rows
    holding NaN and infinities), asserting its path; timed unless `timed`
    is False, by torch.profiler beside the composition it replaces (a zero
    fill, a dequantize launch and an add a pod). Bound: bytes, every pod's
    codes and scales read, n f32 written; 2 operations an element a pod.
    No single PyTorch call computes it: library_ms is null."""
    import torch
    from repro_torch.kernels.quantize.ops import dequantize_cuda, dequantize_sum_rows_cuda
    from repro_torch.kernels.quantize.ref import dequantize_sum_rows_ref, quantize_ref
    parts = [quantize_ref(_quantize_input(rows, cols, "float32", seed + p,
                                          nonfinite=p == 1 and rows > 5))
             for p in range(pods)]
    qg = torch.stack([c for c, _ in parts])
    sg = torch.stack([sc for _, sc in parts])
    del parts
    path = dequantize_path(qg)
    before = path_launches(dequantize_sum_rows_cuda)
    out = dequantize_sum_rows_cuda(qg, sg, n)
    torch.cuda.synchronize()
    if not path_delta(dequantize_sum_rows_cuda, before, path):
        raise AssertionError(f"dequantize_sum_rows {shape}: did not take the {path} path")
    want = dequantize_sum_rows_ref(qg, sg, n)
    if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"dequantize_sum_rows {shape}: output differs from the plain "
                             "version")
    checked.add(dequantize_sum_sig(qg, n))
    row = {"phase": "kernel", "kernel": "dequantize_sum_rows", "shape": shape, "pods": pods,
           "rows": rows, "cols": cols, "n": n, "path": path,
           "max_abs_err": float((out - want).abs().nan_to_num().max()),
           "tolerance": "bitwise"}
    if timed:
        def composition():
            total = torch.zeros(n, dtype=torch.float32, device="cuda")
            for i in range(pods):
                total = total + dequantize_cuda(qg[i], sg[i]).reshape(-1)[:n]
            return total
        kernel_ms, ops, _ = device_ms_per_call(lambda: dequantize_sum_rows_cuda(qg, sg, n))
        comp_ms, comp_ops, comp_by = device_ms_per_call(composition)
        plain_ms = time_ms(lambda: dequantize_sum_rows_ref(qg, sg, n), iters=20)
        bound_ms, bound_by = bound(pods * (rows * cols + rows * 4) + n * 4, 2 * pods * n)
        row.update({"kernel_ms": kernel_ms, "kernel_ms_by": "torch.profiler", "device_ops": ops,
                    "composition_ms": comp_ms, "composition_device_ops": comp_ops,
                    "composition_by_kernel": comp_by, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    emit(row)
    del qg, sg, out, want
    return row


def bf16_ulp(x):
    """One bf16 ulp (8 significand bits) at each element's |x|, floored at
    the smallest normal."""
    import torch
    e = torch.floor(torch.log2(x.abs().float().clamp_min(1e-30)))
    return torch.exp2(e - 7).clamp_min(2.0 ** -126)


def rmsnorm_kernel_phase(shape: str, rows: int, d: int, seed: int, checked: set, *,
                         dtype="bfloat16", eps=1e-6, offset=0):
    """The RMSNorm kernel against its plain version on rows of varied
    scale (one all zero): bf16 within one bf16 ulp of each element (both
    are the f32 value x * r * s rounded once, and the f32 values differ by
    a few f32 ulps of the row's sum of squares and rsqrt, so they round to
    the same or neighbouring bf16 values); f32 within 2e-6 of each
    element (one product chain per element, with r = rsqrt(mean + eps)
    computed from sums in other orders: a few f32 ulps). x starts `offset`
    elements into its buffer (an unaligned start with offset 1). The call
    must take the path `rmsnorm_path` names, which the row reports with the
    warps a row (`ops.rmsnorm_layout`). Kernel and `F.rms_norm` are both
    timed on the card by torch.profiler (every kernel a call launches), and
    both back to back by CUDA events too."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_cuda, rmsnorm_layout
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((rows, d), generator=gen, device="cuda")
         * (torch.rand((rows, 1), generator=gen, device="cuda") * 8 + 0.05)).to(
             getattr(torch, dtype))
    if offset:
        x = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(rows, d)
    x[min(1, rows - 1)] = 0
    scale = 1 + 0.2 * torch.randn((d,), generator=gen, device="cuda")

    def kernel():
        return rmsnorm_cuda(x, scale, eps=eps)

    def plain():
        return rmsnorm_ref(x, scale, eps=eps)
    path = rmsnorm_path(x, scale)
    counters = {p: f"{p}_launches" for p in RMSNORM_KERNELS}
    before = {p: getattr(rmsnorm_cuda, a) for p, a in counters.items()}
    out = kernel()
    torch.cuda.synchronize()
    took = [p for p, a in counters.items() if getattr(rmsnorm_cuda, a) > before[p]]
    if took != [path]:
        raise AssertionError(f"rmsnorm {shape}: took path {took}, expected {path}")
    want = plain()
    err = (out.float() - want.float()).abs()
    if dtype == "bfloat16":
        unit, tol = bf16_ulp(want), 1.0
    else:
        unit, tol = want.abs().clamp_min(1e-30), 2e-6
    worst = (err / unit).max().item()
    differing = (out != want).double().mean().item()
    if not (worst <= tol and out.dtype == x.dtype and bool(torch.isfinite(out).all())):
        raise AssertionError(f"rmsnorm {shape}: kernel vs plain max |diff| "
                             f"{err.max().item()} ({worst} of the tolerance unit)")
    checked.add(rmsnorm_sig(x, eps))
    back_to_back_ms = time_ms(kernel)
    kernel_ms = device_ms(kernel, RMSNORM_KERNELS[path])
    plain_ms = time_ms(plain, iters=20)
    w = scale.to(x.dtype)             # F.rms_norm takes a weight of the input's type

    def library():
        return F.rms_norm(x, (d,), weight=w, eps=eps)
    library_ms, library_ops, library_by = device_ms_per_call(library)
    library_back_to_back_ms = time_ms(library)
    nbytes = 2 * x.numel() * x.element_size() + 4 * d
    bound_ms, bound_by = bound(nbytes, 4 * x.numel())
    layout = rmsnorm_layout(d, x.element_size(), path == "register")
    row = {"phase": "kernel", "kernel": "rmsnorm", "shape": shape, "rows": rows, "d": d,
           "dtype": dtype, "eps": eps, "path": path, "kernel_name": RMSNORM_KERNELS[path],
           "warps_per_row": layout[0] if layout else None,
           "vectors_per_lane": layout[1] if layout else None, "x_offset": offset,
           "max_abs_err": err.max().item(),
           "max_err_over_unit": worst, "share_of_elements_differing": differing,
           "tolerance": ("1 bf16 ulp of each element" if dtype == "bfloat16"
                         else "2e-6 of each element"),
           "kernel_ms": kernel_ms, "kernel_ms_by": "torch.profiler",
           "back_to_back_ms": back_to_back_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_share": bound_ms / kernel_ms,
           "library_ms": library_ms, "library_ms_by": "torch.profiler, every kernel a call",
           "library_ops_per_call": library_ops, "library_ms_by_kernel": library_by,
           "library_back_to_back_ms": library_back_to_back_ms,
           "library": "F.rms_norm(x, (d,), weight=scale in x's dtype, eps=eps)",
           "kernel_over_library": kernel_ms / library_ms,
           "kernel_gb_s": nbytes / kernel_ms / 1e6}
    emit(row)
    return row


def rmsnorm_grad_phase(rows: int, d: int, seed: int):
    """The autograd Function the model calls on the card (kernel forward,
    plain analytic backward) against torch autograd through the plain
    version, f32: output within 2e-6 of each element, dx and dscale within
    1e-5 of their largest |value| (the terms of dx cancel); the forward
    launches the kernel once; bf16 x gives a bf16 dx and an f32 dscale."""
    import torch
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, d), generator=gen, device="cuda") * 3
    scale = 1 + 0.2 * torch.randn((d,), generator=gen, device="cuda")
    dy = torch.randn((rows, d), generator=gen, device="cuda")
    before = rms_ops.rmsnorm_cuda.launches
    xk, sk = x.clone().requires_grad_(), scale.clone().requires_grad_()
    out = rms_ops.rmsnorm(xk, sk, eps=1e-6)
    out.backward(dy)
    launched = rms_ops.rmsnorm_cuda.launches - before
    xp, sp = x.clone().requires_grad_(), scale.clone().requires_grad_()
    want = rmsnorm_ref(xp, sp, eps=1e-6)
    want.backward(dy)

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()
    xb = x.bfloat16().requires_grad_()
    rms_ops.rmsnorm(xb, sk.detach().requires_grad_(), eps=1e-6).backward(dy.bfloat16())
    checks = {
        "out_within_2e-6": ((out - want).abs() / want.abs().clamp_min(1e-30)).max().item()
                           <= 2e-6,
        "dx_within_1e-5": rel(xk.grad, xp.grad) <= 1e-5,
        "dscale_within_1e-5": rel(sk.grad, sp.grad) <= 1e-5,
        "one_launch": launched == 1,
        "bf16_dx_dtype": xb.grad.dtype == torch.bfloat16,
    }
    emit({"phase": "rmsnorm_grad", "rows": rows, "d": d, "dx_rel_err": rel(xk.grad, xp.grad),
          "dscale_rel_err": rel(sk.grad, sp.grad), "tolerance": "1e-5 of the largest |value|",
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"rmsnorm grad: failed checks "
                             f"{[k for k, v in checks.items() if not v]}")


def _log_uniform(shape, lo, hi, gen):
    """exp(U[log lo, log hi]) on the card."""
    import math
    import torch
    u = torch.rand(shape, generator=gen, device="cuda")
    return torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))


def _ssd_inputs(b, l, h, p, g, n, dtype, seed, dt_kind):
    """Scan inputs on the card as apply_ssm hands them over: x, B and C
    views into one [b, l, h*p + 2*g*n] buffer of `dtype` (the convolution's
    output), A = -uniform[1, 16) [h] (the range of the `ssm_a` init) and
    dt f32 [b, l, h]: "softplus", softplus(normal), as a model with
    dt_bias 0 gives it; "trained", a level per (batch row, head) log-
    uniform on [1e-3, 1e-1] (the range Mamba-2 draws dt_bias from) times
    exp(N(0, 0.5**2)) per position, where the state carried from one chunk
    to the next keeps a share of itself that the check can see."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(seed)
    di = h * p
    buf = torch.randn((b, l, di + 2 * g * n), generator=gen, device="cuda").to(dtype)
    x = buf[..., :di].reshape(b, l, h, p)
    B = buf[..., di:di + g * n].reshape(b, l, g, n)
    C = buf[..., di + g * n:].reshape(b, l, g, n)
    noise = torch.randn((b, l, h), generator=gen, device="cuda")
    if dt_kind == "softplus":
        dt = F.softplus(noise)
    elif dt_kind == "trained":
        dt = _log_uniform((b, 1, h), 1e-3, 1e-1, gen) * torch.exp(0.5 * noise)
    else:
        raise ValueError(dt_kind)
    A = -(torch.rand((h,), generator=gen, device="cuda") * 15.0 + 1.0)
    return x, dt, A, B, C


def _scan_without_decayed_state(x, dt, A, B, C, chunk):
    """The plain scan with a planted fault: the state handed to each chunk
    is the previous chunk's own contribution S alone, the older state it
    should carry on, exp(cum_last) * h, dropped. Chunk c's rows are the
    plain scan's over chunks c-1 and c from a zero state."""
    import torch
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    q = min(chunk, x.shape[1])
    ys = []
    for c0 in range(0, x.shape[1], q):
        a, e = max(c0 - q, 0), c0 + q
        y = ssd_scan_ref(x[:, a:e], dt[:, a:e], A, B[:, a:e], C[:, a:e], chunk=q)[0]
        ys.append(y[:, c0 - a:])
    return torch.cat(ys, dim=1)


def _chunk_decays(dt, A, chunk):
    """exp(cum_last) of every chunk but the last, per (batch row, chunk,
    head): the share of the state that each chunk hands on to the next."""
    import torch
    b, l, h = dt.shape
    q = min(chunk, l)
    dA = torch.nn.functional.pad(dt * A, (0, 0, 0, (-l) % q))
    cum_last = dA.double().reshape(b, -1, q, h).sum(dim=2)
    return torch.exp(cum_last[:, :-1]).flatten()


def ssd_kernel_phase(shape: str, b: int, l: int, seed: int, checked: set, *, h=64, p=64,
                     g=1, n=128, chunk=256, dtype="bfloat16", dt_kind="softplus", route=None):
    """The SSD scan kernel against its plain version, per (batch row,
    head): bf16 within one bf16 ulp of that head's largest |y| (the two
    f32 results, summed in other orders, round apart by at most that);
    f32 within 2e-5 of it. Both take the chunk's prefix sums of dt * A in
    f64 and round each once, so their decays differ only by the f32 exp;
    the products over n and the chunk's rows sum in other orders.

    Where the sequence spans chunks, the plain scan with a planted fault —
    the older state exp(cum_last) * h dropped from what each chunk hands
    on — is held to the plain scan by the same rule and its error
    reported, with the chunks' decays exp(cum_last): with softplus(normal)
    dt they are ~0 and the fault is invisible; with "trained" dt the row
    fails unless the faulty scan lies 10 tolerances away, so a kernel
    with that fault could not pass it.

    The call must take the route `ssd_ops.ssd_route` names (`route`, where
    given, must be it too); the row reports it, and the device time of one
    call, every kernel it launches summed (torch.profiler), beside the
    back-to-back CUDA-event time (`wall_ms`)."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    x, dt, A, B, C = _ssd_inputs(b, l, h, p, g, n, getattr(torch, dtype), seed, dt_kind)
    launcher = ssd_ops.ssd_scan_cuda

    def kernel():
        return launcher(x, dt, A, B, C, chunk=chunk)

    def plain():
        return ssd_scan_ref(x, dt, A, B, C, chunk=chunk)[0]
    expected = ssd_ops.ssd_route(x, B, C, chunk)
    counters = {r: f"{r}_launches" for r in SSD_KERNELS}
    before = {r: getattr(launcher, a) for r, a in counters.items()}
    out = kernel()
    torch.cuda.synchronize()
    took = [r for r, a in counters.items() if getattr(launcher, a) > before[r]]
    if took != [expected] or (route is not None and expected != route):
        raise AssertionError(f"ssd_scan {shape}: took route {took}, expected {expected} "
                             f"(wanted {route})")
    want = plain()
    err = (out.float() - want.float()).abs().amax(dim=(1, 3))          # [b, h]
    top = want.float().abs().amax(dim=(1, 3)).clamp_min(1e-30)
    if dtype == "bfloat16":
        unit, tol = torch.exp2(torch.floor(torch.log2(top)) - 7), 1.0
    else:
        unit, tol = top, 2e-5
    worst = (err / unit).max().item()
    if not (worst <= tol and bool(torch.isfinite(out).all())):
        raise AssertionError(f"ssd_scan {shape}: kernel vs plain max |diff| "
                             f"{err.max().item()} ({worst} of the tolerance unit)")
    carry = None
    if l > chunk:
        faulty = _scan_without_decayed_state(x, dt, A, B, C, chunk).float()
        fault_worst = ((faulty - want.float()).abs().amax(dim=(1, 3)) / unit).max().item()
        decays = _chunk_decays(dt, A, chunk)
        carry = {"chunk_decay_min": decays.min().item(),
                 "chunk_decay_median": decays.median().item(),
                 "chunk_decay_max": decays.max().item(),
                 "chunk_decay_share_above_1e-3": (decays > 1e-3).double().mean().item(),
                 "decayed_state_dropped_err_over_unit": fault_worst}
        del faulty
        if dt_kind == "trained" and not fault_worst > 10 * tol:
            raise AssertionError(f"ssd_scan {shape}: the plain scan without the decayed "
                                 f"state lies only {fault_worst} units from it")
    checked.add(ssd_sig(x, B, chunk))
    wall_ms = time_ms(kernel, iters=10, warmup=2)
    kernel_ms, device_ops, by_kernel = device_ms_per_call(kernel)
    if not set(by_kernel) <= set(SSD_KERNELS[took[0]]) | {"Memset"}:
        raise AssertionError(f"ssd_scan {shape}: a call ran {sorted(by_kernel)}")
    plain_ms = time_ms(plain, iters=3, warmup=1)
    q = min(chunk, l)
    rows = [min(q, l - c0) for c0 in range(0, l, q)]
    pairs = sum(r * (r + 1) // 2 for r in rows)     # causal (i, j) pairs in the chunks
    # scores C_i . B_j and S . (dt x) over the pairs; the inter-chunk readout
    # and the state update, p x n products per row each
    flops = b * h * (2 * pairs * (n + p) + 4 * l * p * n)
    esize = x.element_size()
    nbytes = 2 * b * l * h * p * esize + b * l * h * 4 + h * 4 + 2 * b * l * g * n * esize
    peak = BF16_TENSOR_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
    bound_ms, bound_by = bound(nbytes, flops, peak)
    q = min(chunk, l)
    nc1 = -(-l // q) - 1
    row = {"phase": "kernel", "kernel": "ssd_scan", "shape": shape, "route": took[0],
           "x": list(x.shape), "groups": g, "state": n, "chunk": chunk, "dtype": dtype,
           "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
           "workspace_mbytes": (b * nc1 * h * (p * n + 1) * 4 / 1e6
                                if took[0] == "tensor_core" else 0.0),
           "max_abs_err": err.max().item(),
           "max_err_over_unit": worst, "dt": dt_kind, "carry": carry,
           "tolerance": ("1 bf16 ulp of each (batch, head)'s max |plain|"
                         if dtype == "bfloat16" else "2e-5 of each (batch, head)'s max |plain|"),
           "kernel_ms": kernel_ms, "device_ops_per_call": device_ops,
           "device_ms_by_kernel": by_kernel, "wall_ms": wall_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bound_peak": peak,
           "bound_share": bound_ms / kernel_ms,
           "library_ms": None, "library": "none: no single PyTorch call computes the scan",
           "timing": "kernel_ms: device time a call, every kernel summed (torch.profiler); "
                     "wall_ms, plain_ms: CUDA events, back to back",
           "kernel_tflop_s": flops / kernel_ms / 1e9}
    emit(row)
    del x, dt, A, B, C, out, want
    torch.cuda.empty_cache()
    return row


def kernel_phases(num_layers: int):
    """Each kernel against its plain version at every shape the paths give
    it and at a long-context shape: flash attention's tensor-core route at
    the static prefill (8 prompts of 128), the engine's whole-prompt
    prefill (1 of 128), a long prompt, a ragged long prompt, a window with
    an offset, head_dim 64, a window over a long prompt and rows without a
    key at head_dim 256, and its
    CUDA-core route in f32 at the static prefill's shape and with a window
    and an offset; slot-contiguous
    decode at the static loop's cache (8 x 160, kv_len 129..159) and the
    slot decode's (4 x 160, ragged with a 0), bf16 and int8; paged decode
    at the engine's arena and table; both decode layouts at long context,
    with 16 and 9 query heads per kv head, head_dim 256 and 64, on the
    tensor cores, and in f32 on the CUDA cores; quantize at each decoded token's rows
    and the pool's quantize of a prefill cache of 2 and of num_layers
    layers; the SSD scan at the Mamba-2 forward's 4 x 2048 tokens (views
    of the convolution's output, as apply_ssm passes them), a ragged
    length, a length under the chunk, two groups, a chunk of 100 rows and
    head_dim 32 with state 64 on the tensor cores, f32, a narrow f32 head
    and a narrow bf16 head on the CUDA cores, and the main and ragged
    shapes again with dt in a trained model's range, where the state
    carried across chunks shows; RMSNorm at the train step's rows, every
    serve path's, Mamba-2's, ragged, f32 and a narrow row (the row held in
    registers by 1, 2, 4 and 8 warps), two rows of the element path (a
    width of no whole 16-byte vectors, an unaligned start), and its
    autograd Function's gradient.
    The first row of each kernel is the main path's shape.
    -> ({kernel: [rows]}, the launch signatures checked)."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    long_lens = [int(n) for n in rng.integers(2048, 4097, 16)]
    out, checked = {}, set()
    # kernel #1 by route: bf16 at head_dim 64/128/256 on the tensor cores
    # (the model's prefill), f32 on the CUDA cores
    out["flash_attention_fwd_wgmma"] = [
        attention_kernel_phase("static_prefill", REQUESTS, PROMPT, 11, checked),
        attention_kernel_phase("engine_prefill", 1, PROMPT, 12, checked),
        attention_kernel_phase("long_prompt", 2, 4096, 13, checked),
        attention_kernel_phase("long_prompt_ragged", 2, 3001, 51, checked),
        attention_kernel_phase("bf16_window_offset", 2, 100, 52, checked, skv=230, heads=10,
                               kv_heads=2, window=50, q_offset=130),
        attention_kernel_phase("d64", 1, 1500, 53, checked, heads=6, kv_heads=6, d=64),
        # a window that starts the kv walk past the first tiles, and tiles
        # wholly outside it for one warpgroup's rows only
        attention_kernel_phase("bf16_window_long", 1, 1000, 55, checked, heads=8, kv_heads=2,
                               window=200),
        attention_kernel_phase("rows_without_key", 1, 96, 15, checked, skv=80, heads=4,
                               kv_heads=4, d=256, q_offset=None),
    ]
    out["flash_attention_fwd_cuda_core"] = [
        attention_kernel_phase("f32_prefill", REQUESTS, PROMPT, 54, checked,
                               dtype="float32"),
        attention_kernel_phase("f32_window_offset", 2, 100, 14, checked, skv=230, heads=10,
                               kv_heads=2, d=64, dtype="float32", window=50, q_offset=130),
    ]
    # the static loop's decode steps see kv_len PROMPT + 1 .. MAX_LEN - 1
    static_lens = [(PROMPT + 1 + MAX_LEN - 1) // 2] * REQUESTS
    out["flash_decode_bf16"] = [
        decode_kernel_phase("static_decode", static_lens, False, 16, checked, paged=False,
                            smax=MAX_LEN),
        decode_kernel_phase("static_decode_first", [PROMPT + 1] * REQUESTS, False, 17, checked,
                            paged=False, smax=MAX_LEN),
        decode_kernel_phase("static_decode_last", [MAX_LEN - 1] * REQUESTS, False, 18, checked,
                            paged=False, smax=MAX_LEN),
        decode_kernel_phase("slot_decode", [160, 97, 0, 33], False, 19, checked, paged=False,
                            smax=MAX_LEN),
        decode_kernel_phase("long_context", long_lens, False, 20, checked, paged=False,
                            smax=4096),
    ]
    out["flash_decode_int8"] = [
        decode_kernel_phase("slot_decode", [160, 97, 0, 33], True, 21, checked, paged=False,
                            smax=MAX_LEN),
        decode_kernel_phase("long_context", long_lens, True, 22, checked, paged=False,
                            smax=4096),
    ]
    for int8 in (False, True):
        name = "flash_decode_paged_" + ("int8" if int8 else "bf16")
        out[name] = [decode_kernel_phase("engine", [160, 97, 0, 33], int8, 1, checked,
                                         pages=DEVICE_PAGES, max_pages=MAX_LEN // PAGE),
                     decode_kernel_phase("long_context", long_lens, int8, 2, checked)]
    # the tensor-core route at the group sizes and head widths of the repo's
    # other configs: G 16 at D 128 (qwen3-moe, 64/4 heads), G 9 (starcoder2-7b,
    # 36/4), G 16 at D 256 (recurrentgemma-9b, 16/1), D 64 with G 1 (6/6)
    for int8 in (False, True):
        kind = "int8" if int8 else "bf16"
        out[f"flash_decode_paged_{kind}"].append(decode_kernel_phase(
            "long_context_g16", long_lens, int8, 61 + int8, checked, heads=64, kv_heads=4))
        out[f"flash_decode_{kind}"].append(decode_kernel_phase(
            "long_context_g9", long_lens, int8, 63 + int8, checked, paged=False, smax=4096,
            heads=36, kv_heads=4))
    out["flash_decode_paged_bf16"].append(decode_kernel_phase(
        "long_context_g16_d256", long_lens, False, 65, checked, heads=16, kv_heads=1, d=256))
    out["flash_decode_bf16"].append(decode_kernel_phase(
        "d64_g1", [160, 97, 0, 33, 1500], False, 66, checked, paged=False, smax=1536,
        heads=6, kv_heads=6, d=64))
    # the CUDA-core route: f32 (its own path, `f32_decode_phase`)
    out["flash_decode_cuda_core"] = [
        decode_kernel_phase("f32_static_decode", [144] * REQUESTS, False, 67, checked,
                            paged=False, smax=MAX_LEN, dtype="float32"),
        decode_kernel_phase("f32_engine", [160, 97, 0, 33], False, 68, checked,
                            pages=DEVICE_PAGES, max_pages=MAX_LEN // PAGE, dtype="float32"),
    ]
    out["quantize_rows"] = [
        quantize_kernel_phase("kv_rows_32", SLOTS * K, 3, checked),
        quantize_kernel_phase("kv_rows_128", 16 * K, 4, checked),
        quantize_kernel_phase("prefill", 4 * MAX_LEN * K, 5, checked),
        quantize_kernel_phase("pool_ingest_2_layers", 2 * MAX_LEN * K, 6, checked),
        quantize_kernel_phase(f"pool_ingest_{num_layers}_layers",
                              num_layers * MAX_LEN * K, 7, checked),
        quantize_kernel_phase("nonfinite_rows", 64, 8, checked, timed=False, nonfinite=True),
        quantize_kernel_phase("nonfinite_rows_pod_hop", 64, 9, checked, cols=1024,
                              dtype="float32", timed=False, nonfinite=True),
        # the element path: a width of no whole 16-byte vectors, an unaligned start
        quantize_kernel_phase("element_37x100", 37, 77, checked, cols=100, timed=False,
                              nonfinite=True),
        quantize_kernel_phase("element_unaligned", 64, 78, checked, cols=1024,
                              dtype="float32", timed=False, offset=1)]
    # the decode step's fused int8 write: the engine's arena (4 slots) and
    # 16 slots, paged and slot-contiguous
    out["quantize_kv_write"] = [
        quantize_kv_write_kernel_phase("engine", SLOTS, True, 79, checked),
        quantize_kv_write_kernel_phase("slots_16", 16, True, 80, checked),
        quantize_kv_write_kernel_phase("contiguous", SLOTS, False, 81, checked),
        quantize_kv_write_kernel_phase("contiguous_16", 16, False, 82, checked)]
    from repro_torch.configs import get_config
    m = get_config(MAMBA)
    # the SSD scan by route: bf16 at head_dim and state multiples of 16 on
    # the tensor cores (the model's scan), f32 and other shapes on the CUDA cores
    tc = {"route": "tensor_core"}
    out["ssd_scan_tensor_core"] = [
        ssd_kernel_phase("mamba2_forward", SSD_BATCH, SSD_LEN, 23, checked, h=m.ssm_nheads,
                         p=m.ssm_headdim, g=m.ssm_ngroups, n=m.ssm_state, chunk=m.ssm_chunk,
                         **tc),
        ssd_kernel_phase("mamba2_forward_trained_dt", SSD_BATCH, SSD_LEN, 29, checked,
                         h=m.ssm_nheads, p=m.ssm_headdim, g=m.ssm_ngroups, n=m.ssm_state,
                         chunk=m.ssm_chunk, dt_kind="trained", **tc),
        ssd_kernel_phase("ragged_2000", 2, 2000, 24, checked, **tc),
        ssd_kernel_phase("ragged_2000_trained_dt", 2, 2000, 30, checked, dt_kind="trained",
                         **tc),
        ssd_kernel_phase("under_chunk_100", SSD_BATCH, 100, 25, checked, **tc),
        ssd_kernel_phase("groups_2", 2, SSD_LEN, 27, checked, g=2, **tc),
        # a chunk that is not a whole number of 64-row tiles, ragged at the end
        ssd_kernel_phase("chunk_100_ragged_trained_dt", 2, 1000, 70, checked, chunk=100,
                         dt_kind="trained", **tc),
        # head_dim 32 and state 64: half the warps of a state block idle
        ssd_kernel_phase("p32_n64_g2_trained_dt", 2, 700, 71, checked, h=8, p=32, g=2, n=64,
                         chunk=128, dt_kind="trained", **tc),
    ]
    out["ssd_scan_cuda_core"] = [
        ssd_kernel_phase("f32", 2, SSD_LEN, 26, checked, dtype="float32", route="cuda_core"),
        ssd_kernel_phase("narrow_f32", 2, 300, 28, checked, h=8, p=40, g=2, n=48, chunk=64,
                         dtype="float32", route="cuda_core"),
        ssd_kernel_phase("narrow_bf16", 2, 300, 72, checked, h=8, p=40, g=2, n=48, chunk=64,
                         route="cuda_core"),
    ]
    d, md = get_config(ARCH).d_model, m.d_model
    out["rmsnorm"] = [
        rmsnorm_kernel_phase("train_step", TRAIN_BATCH * TRAIN_SEQ, d, 31, checked),
        rmsnorm_kernel_phase("static_prefill", REQUESTS * PROMPT, d, 32, checked),
        rmsnorm_kernel_phase("static_decode", REQUESTS, d, 33, checked),
        rmsnorm_kernel_phase("engine_prefill_chunk", CHUNK, d, 34, checked),
        rmsnorm_kernel_phase("engine_whole_prefill", PROMPT, d, 35, checked),
        rmsnorm_kernel_phase("engine_decode", SLOTS, d, 36, checked),
        rmsnorm_kernel_phase("ragged_300", 300, d, 37, checked),
        rmsnorm_kernel_phase("mamba2_forward", SSD_BATCH * SSD_LEN, md, 38, checked,
                             eps=m.norm_eps),
        rmsnorm_kernel_phase("mamba2_2x2048", 2 * SSD_LEN, md, 39, checked, eps=m.norm_eps),
        rmsnorm_kernel_phase("train_step_f32", TRAIN_BATCH * TRAIN_SEQ, d, 40, checked,
                             dtype="float32"),
        rmsnorm_kernel_phase("narrow_37x64", 37, 64, 41, checked),
        # the element path: a width that is no whole number of vectors, and an
        # unaligned start
        rmsnorm_kernel_phase("element_37x100", 37, 100, 73, checked),
        rmsnorm_kernel_phase("element_unaligned_300", 300, d, 74, checked, offset=1),
        # the row over four and eight warps: f32 at d 8192 and 16384
        rmsnorm_kernel_phase("f32_8192", 512, 8192, 75, checked, dtype="float32"),
        rmsnorm_kernel_phase("f32_16384", 256, 16384, 76, checked, dtype="float32"),
    ]
    rmsnorm_grad_phase(TRAIN_BATCH * TRAIN_SEQ, d, 42)
    ddl_kernel_phases(out, checked)
    return out, checked


def ddl_kernel_phases(out: dict, checked: set):
    """The quantizer, the pod sum and the dequantizer at DDL's compressed
    pod hop: a full 2**24-element slice of a gradient shard ([16384, 1024]
    f32), the ragged tail of the embedding's grad, the pod sum over 2 pods
    (the main path) and 4, the dequantizer (error feedback's) with a bf16
    output and at narrow shapes, each timed; then every other slice the two
    DDL phases give the kernels, and those of the error-feedback path,
    checked without timing. Adds the rows to `out`; the pod-hop slice is
    the first row of the quantizer's (its main path's shape)."""
    from repro_torch.configs import get_smoke_config
    cfg = _ddl_config(DDL_LAYERS, DDL_MESH).model
    d = cfg.d_model
    full = ddl_pod_hop_sizes(cfg, 1, overlap=True)
    tail = cfg.vocab_size * d % (1 << 24)
    out["dequantize_rows"] = [
        dequantize_kernel_phase("pod_hop_slice", 1 << 14, 1024, 43, checked),
        dequantize_kernel_phase("embedding_grad_tail", -(-tail // 1024), 1024, 44, checked),
        dequantize_kernel_phase("pod_hop_slice_bf16", 1 << 14, 1024, 45, checked,
                                out_dtype="bfloat16"),
        dequantize_kernel_phase("narrow_37x64", 37, 64, 46, checked),
        dequantize_kernel_phase("element_5x30", 5, 30, 83, checked, timed=False)]
    out["dequantize_sum_rows"] = [
        dequantize_sum_kernel_phase("pod_hop_slice", DDL_MESH[0], 1 << 14, 1 << 24, 84,
                                    checked),
        dequantize_sum_kernel_phase("pod_hop_slice_4_pods", 4, 1 << 14, 1 << 24, 85, checked),
        dequantize_sum_kernel_phase("embedding_grad_tail", DDL_MESH[0], -(-tail // 1024), tail,
                                    86, checked),
        dequantize_sum_kernel_phase("element_7x30", 2, 7, 200, 87, checked, cols=30,
                                    timed=False)]
    quantize_rows = out.setdefault("quantize_rows", [])
    quantize_rows.insert(0, quantize_kernel_phase("pod_hop_slice", 1 << 14, 47, checked,
                                                  cols=1024, dtype="float32"))
    quantize_rows.append(quantize_kernel_phase("embedding_grad_tail", -(-tail // 1024), 48,
                                               checked, cols=1024, dtype="float32"))
    smoke = get_smoke_config(ARCH)
    # RMSNorm at each DDL rank's rows
    out.setdefault("rmsnorm", []).extend([
        rmsnorm_kernel_phase("ddl_rank", TRAIN_BATCH * TRAIN_SEQ // DDL_MESH[0], d, 49, checked),
        rmsnorm_kernel_phase("ddl_smoke_rank", DDL_SMOKE_BATCH // 4 * DDL_SMOKE_SEQ,
                             smoke.d_model, 49, checked, eps=smoke.norm_eps)])
    sizes = set(full) | {n for ov in (False, True)
                         for n in ddl_pod_hop_sizes(smoke, DDL_SMOKE_MESH[1], overlap=ov)}
    sizes |= set(ddl_ef_slices())
    for i, n in enumerate(sorted(sizes)):
        quantize_kernel_phase(f"pod_hop_{n}", -(-n // 1024), 50 + i, checked, cols=1024,
                              dtype="float32", timed=False)
        dequantize_kernel_phase(f"pod_hop_{n}", -(-n // 1024), 1024, 50 + i, checked,
                                timed=False)
        dequantize_sum_kernel_phase(f"pod_hop_{n}", DDL_MESH[0], -(-n // 1024), n, 50 + i,
                                    checked, timed=False)


# the CUDA launchers whose counts a run of a path resets and reads
def _launchers():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"flash_attention": fa_ops.flash_attention_cuda,
            "flash_decode": fa_ops.flash_decode_cuda,
            "flash_decode_paged": fa_ops.flash_decode_paged_cuda,
            "quantize_rows": q_ops.quantize_cuda,
            "quantize_kv_write": q_ops.quantize_kv_write_cuda,
            "dequantize_rows": q_ops.dequantize_cuda,
            "dequantize_sum_rows": q_ops.dequantize_sum_rows_cuda,
            "rmsnorm": rms_ops.rmsnorm_cuda,
            "ssd_scan": ssd_ops.ssd_scan_cuda}


@contextlib.contextmanager
def launch_signatures():
    """Record the launch signature of every kernel call inside the block,
    with every launch count set to 0 on entry. The dispatchers the model
    calls through (`flash_attention`, `flash_decode`, `flash_decode_paged`,
    `quantize`, `quantize_kv_write`, `dequantize`, `dequantize_sum_rows`,
    `rmsnorm`, `ssd_scan`) are swapped for recording stand-ins
    that call them; the wrappers below them launch and count as always. ->
    (signatures seen, {kernel: calls recorded}, {kernel: launches}), the
    last filled on exit, for the caller to match the calls against. The
    flash-attention calls are also counted by the route `attention_route`
    expects (`flash_attention_wgmma`, `flash_attention_cuda_core`), and the
    decode calls by the route `decode_route` expects
    (`flash_decode_tensor_core`, `flash_decode_paged_cuda_core`, ...), the
    scan calls by the route `ssd_ops.ssd_route` names (`ssd_scan_tensor_core`,
    `ssd_scan_cuda_core`) and the RMSNorm calls by the path `rmsnorm_path`
    names (`rmsnorm_register`, `rmsnorm_element`), and the int8 calls by
    the path `quantize_path`, `kv_write_path` or `dequantize_path` names
    (`quantize_rows_vector`, `dequantize_sum_rows_element`, ...), against
    the wrappers' per-route counts."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    launchers = _launchers()
    routes = {"flash_attention_wgmma": ("flash_attention", "wgmma_launches"),
              "flash_attention_cuda_core": ("flash_attention", "cuda_core_launches"),
              "rmsnorm_register": ("rmsnorm", "register_launches"),
              "rmsnorm_element": ("rmsnorm", "element_launches")}
    for name in ("flash_decode", "flash_decode_paged", "ssd_scan"):
        for route in ("tensor_core", "cuda_core"):
            routes[f"{name}_{route}"] = (name, f"{route}_launches")
    for name in ("quantize_rows", "quantize_kv_write", "dequantize_rows", "dequantize_sum_rows"):
        for path in ("vector", "element"):
            routes[f"{name}_{path}"] = (name, f"{path}_launches")
    seen, calls, launches = set(), {name: 0 for name in [*launchers, *routes]}, {}
    attend, decode, paged, quantize, scan = (fa_ops.flash_attention, fa_ops.flash_decode,
                                             fa_ops.flash_decode_paged, q_ops.quantize,
                                             ssd_ops.ssd_scan)
    norm, dequantize = rms_ops.rmsnorm, q_ops.dequantize
    kv_write, dequantize_sum = q_ops.quantize_kv_write, q_ops.dequantize_sum_rows

    def attend_spy(q, k, v, *, causal=True, window=0, q_offset=None):
        seen.add(attention_sig(q, k, causal, window, q_offset))
        calls["flash_attention"] += 1
        calls["flash_attention_" + attention_route(q)] += 1
        return attend(q, k, v, causal=causal, window=window, q_offset=q_offset)

    def decode_spy(q, k_cache, v_cache, kv_len, **kw):
        q3 = q[:, 0] if q.dim() == 4 else q
        seen.add(decode_sig(q3, k_cache))
        calls["flash_decode"] += 1
        calls["flash_decode_" + decode_route(q3, k_cache)] += 1
        return decode(q, k_cache, v_cache, kv_len, **kw)

    def paged_spy(q, k_pages, v_pages, kv_len, page_table, **kw):
        q3 = q[:, 0] if q.dim() == 4 else q
        seen.add(decode_sig(q3, k_pages, page_table))
        calls["flash_decode_paged"] += 1
        calls["flash_decode_paged_" + decode_route(q3, k_pages)] += 1
        return paged(q, k_pages, v_pages, kv_len, page_table, **kw)

    def quantize_spy(x):
        seen.add(quantize_sig(x))
        calls["quantize_rows"] += 1
        calls["quantize_rows_" + quantize_path(x)] += 1
        return quantize(x)

    def kv_write_spy(k, v, k_codes, v_codes, k_scale, v_scale, page_table, positions, active):
        seen.add(quantize_kv_write_sig(k, k_codes, page_table))
        calls["quantize_kv_write"] += 1
        calls["quantize_kv_write_" + kv_write_path(k, v, k_codes, v_codes)] += 1
        return kv_write(k, v, k_codes, v_codes, k_scale, v_scale, page_table, positions, active)

    def dequantize_spy(q, scale, out_dtype=torch.float32):
        seen.add(dequantize_sig(q, out_dtype))
        calls["dequantize_rows"] += 1
        calls["dequantize_rows_" + dequantize_path(q)] += 1
        return dequantize(q, scale, out_dtype)

    def dequantize_sum_spy(q, scale, n):
        seen.add(dequantize_sum_sig(q, n))
        calls["dequantize_sum_rows"] += 1
        calls["dequantize_sum_rows_" + dequantize_path(q)] += 1
        return dequantize_sum(q, scale, n)

    def scan_spy(x, dt, A, B, C, *, chunk=256):
        seen.add(ssd_sig(x, B, chunk))
        calls["ssd_scan"] += 1
        calls["ssd_scan_" + ssd_ops.ssd_route(x, B, C, chunk)] += 1
        return scan(x, dt, A, B, C, chunk=chunk)

    def norm_spy(x, scale, *, eps=1e-6):
        seen.add(rmsnorm_sig(x, eps))
        calls["rmsnorm"] += 1
        calls["rmsnorm_" + rmsnorm_path(x, scale)] += 1
        return norm(x, scale, eps=eps)
    (fa_ops.flash_attention, fa_ops.flash_decode, fa_ops.flash_decode_paged,
     q_ops.quantize, ssd_ops.ssd_scan) = (attend_spy, decode_spy, paged_spy, quantize_spy,
                                          scan_spy)
    rms_ops.rmsnorm, q_ops.dequantize = norm_spy, dequantize_spy
    q_ops.quantize_kv_write, q_ops.dequantize_sum_rows = kv_write_spy, dequantize_sum_spy
    for fn in launchers.values():
        fn.launches = 0
    for owner, attr in routes.values():
        setattr(launchers[owner], attr, 0)
    try:
        yield seen, calls, launches
    finally:
        (fa_ops.flash_attention, fa_ops.flash_decode, fa_ops.flash_decode_paged,
         q_ops.quantize, ssd_ops.ssd_scan) = attend, decode, paged, quantize, scan
        rms_ops.rmsnorm, q_ops.dequantize = norm, dequantize
        q_ops.quantize_kv_write, q_ops.dequantize_sum_rows = kv_write, dequantize_sum
        launches.update({name: fn.launches for name, fn in launchers.items()})
        launches.update({name: getattr(launchers[owner], attr)
                         for name, (owner, attr) in routes.items()})


def _serve(model, params, kv_dtype, rows=None, around_run=None, prefill_chunk=CHUNK):
    """Serve the trace once, inside `around_run` (a context manager) if
    given; -> (engine, requests, finite logits?, seconds of eng.run)."""
    import numpy as np
    from repro_torch.serve import ServeEngine, synth_requests
    eng = ServeEngine(model, slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
                      prefill_chunk=prefill_chunk, device_pages=DEVICE_PAGES, params=params,
                      kv_dtype=kv_dtype, device="cuda")
    finite = [True]
    select = eng._select

    def checked(req, row):
        finite[0] &= bool(np.isfinite(row).all())
        if rows is not None:
            rows.setdefault(req.rid, []).append(row.copy())
        return select(req, row)
    eng._select = checked
    reqs = synth_requests(model.cfg, REQUESTS, PROMPT, GEN, np.random.default_rng(SEED))
    with around_run if around_run is not None else contextlib.nullcontext():
        t0 = time.monotonic()
        eng.run(reqs)
        wall = time.monotonic() - t0
    del eng._select       # no reference cycle: the engine (and params) can go
    return eng, reqs, finite[0], wall


def _dense_rows(model, params, req):
    """One dense pass at model width (naive attention, plain RMSNorm, no
    kernel) over a request's prompt and its generated tokens but the last;
    row j scores generated token j. -> [GEN, V] f32 numpy."""
    import numpy as np
    import torch
    toks = np.concatenate([req.prompt, np.asarray(req.tokens[:-1], np.int32)])
    cache = model.init_cache(1, MAX_LEN, "cuda")
    with torch.no_grad(), plain_versions():
        logits, _ = model.prefill_chunk(
            params, cache, {"tokens": torch.from_numpy(toks[None]).cuda()}, 0, len(toks))
    return logits[0, len(req.prompt) - 1:].float().cpu().numpy()


def _wide(w) -> bool:
    """The dense row's top-2 margin exceeds 2**-4 of its max |logit|."""
    import numpy as np
    top2 = np.partition(w, -2)[-2:]
    return top2[1] - top2[0] > 2.0 ** -4 * float(np.abs(w).max())


def _deviation(reference, rows):
    """Logits rows of a run against a reference's, per request ({rid:
    rows}). -> {"worst": max over rows of max |diff| / max |reference|,
    "prefill_row": the same for the prefill rows alone, "argmax_mismatches":
    rows whose argmax differs where the reference's top-2 margin is wide}."""
    import numpy as np
    worst = first = 0.0
    mismatches = 0
    for rid, want in reference.items():
        got = np.stack(rows[rid])
        assert want.shape == got.shape, (want.shape, got.shape)
        for i, (g, w) in enumerate(zip(got, want)):
            dev = float(np.abs(g - w).max()) / float(np.abs(w).max())
            worst = max(worst, dev)
            if i == 0:
                first = max(first, dev)
            if _wide(w) and int(np.argmax(g)) != int(np.argmax(w)):
                mismatches += 1
    return {"worst": worst, "prefill_row": first, "argmax_mismatches": mismatches}


def engine_phase(model, params, kv_dtype, line, checked, dense_tol=None,
                 prefill_chunk=CHUNK):
    """Serve the trace with counts reset just before and read just after;
    check the run, that every launch had a signature the kernel phases
    held against the plain version, and the logits of the first and last
    request against the dense pass (argmax always; the deviation too when
    dense_tol is given). prefill_chunk=0 prefills whole prompts, through
    the flash-attention kernel when the model's attn_impl is "pallas"."""
    import torch
    rows = {}
    torch.cuda.reset_peak_memory_stats()
    with launch_signatures() as (seen, calls, launches):
        eng, reqs, finite, wall = _serve(model, params, kv_dtype, rows,
                                         prefill_chunk=prefill_chunk)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    m = eng.metrics()
    cfg = model.cfg
    layers = cfg.num_layers
    kernel_prefill = prefill_chunk == 0 and model.attn_impl == "pallas"
    bad = [(r.rid, r.status, len(r.tokens)) for r in reqs
           if r.status != "ok" or len(r.tokens) != GEN]
    dense = _deviation({r.rid: _dense_rows(model, params, r) for r in (reqs[0], reqs[-1])},
                       rows)
    unchecked = sorted(seen - checked)
    # every model call (each prefill chunk or whole prompt, each tick)
    # normalises 2 x layers + 1 times
    prefill_calls = len(reqs) * (-(-PROMPT // prefill_chunk) if prefill_chunk else 1)
    norms = (2 * layers + 1) * (int(m["ticks"]) + prefill_calls)
    checks = {
        "all_ok_32_tokens": not bad,
        "spilled": m["pool_spilled_pages"] > 0,
        "returned": m["pool_fetched_pages"] + m["pool_prefetched_pages"] > 0,
        "decode_launches_eq_layers_x_ticks":
            launches["flash_decode_paged"] == layers * int(m["ticks"]),
        # int8: the decode step's fused write once a layer-tick, the row
        # quantizer only at the pool's boundary (k and v of each prefill)
        "quantize_launches": (launches["quantize_kv_write"] == layers * int(m["ticks"])
                              and launches["quantize_rows"] == 2 * len(reqs))
                             if kv_dtype == "int8"
                             else launches["quantize_rows"] == launches["quantize_kv_write"] == 0,
        "quantize_took_vector": launches["quantize_rows_vector"] == launches["quantize_rows"]
                                and launches["quantize_kv_write_vector"]
                                == launches["quantize_kv_write"],
        "attention_launches": launches["flash_attention"]
            == (layers * len(reqs) if kernel_prefill else 0),
        "attention_took_wgmma": launches["flash_attention_wgmma"]
            == launches["flash_attention"],
        "decode_took_tensor_core":
            launches["flash_decode_paged_tensor_core"] == launches["flash_decode_paged"],
        "no_contiguous_decode": launches["flash_decode"] == 0,
        "rmsnorm_launches": launches["rmsnorm"] == norms,
        "every_launch_recorded": calls == launches,
        "every_launch_shape_checked": not unchecked,
        "finite_logits": finite,
        "dense_argmax": dense["argmax_mismatches"] == 0,
    }
    if dense_tol is not None:
        checks["dense_within_tol"] = dense["worst"] <= dense_tol
    row = {"phase": "engine", "kv_dtype": kv_dtype, "arch": ARCH,
           "layers": layers, "d_model": cfg.d_model, "requests": len(reqs),
           "prompt": PROMPT, "gen": GEN, "slots": SLOTS, "page_size": PAGE,
           "device_pages": DEVICE_PAGES, "prefill_chunk": prefill_chunk,
           "attn_impl": model.attn_impl, "card": line,
           "decode_tok_s": m["decode_tok_s"], "ttft_mean_s": m.get("ttft_mean_s"),
           "ttft_p95_s": m.get("ttft_p95_s"), "tpot_p50_s": m.get("tpot_p50_s"),
           "tpot_p95_s": m.get("tpot_p95_s"), "ticks": m["ticks"],
           "mean_concurrency": m["mean_concurrency"], "run_s": wall,
           "max_memory_allocated_gb": peak_gb,
           "pool_spilled_pages": m["pool_spilled_pages"],
           "pool_fetched_pages": m["pool_fetched_pages"],
           "pool_prefetched_pages": m["pool_prefetched_pages"],
           "decode_launches": launches["flash_decode_paged"],
           "decode_tensor_core_launches": launches["flash_decode_paged_tensor_core"],
           "quantize_launches": launches["quantize_rows"],
           "quantize_kv_write_launches": launches["quantize_kv_write"],
           "attention_launches": launches["flash_attention"],
           "attention_wgmma_launches": launches["flash_attention_wgmma"],
           "rmsnorm_launches": launches["rmsnorm"],
           "launch_signatures": sorted(seen), "unchecked_signatures": unchecked,
           "dense": dense, "dense_tol": dense_tol, "checks": checks, "bad": bad}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"engine {kv_dtype} ({layers} layers, prefill_chunk "
                             f"{prefill_chunk}): failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row, {r.rid: list(r.tokens) for r in reqs}


@contextlib.contextmanager
def plain_versions():
    """Swap the attention and RMSNorm dispatchers the model calls for their
    plain versions, which then run on the same (CUDA) tensors, RMSNorm
    under ordinary autograd."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                         flash_decode_ref)
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    attend, decode, norm = fa_ops.flash_attention, fa_ops.flash_decode, rms_ops.rmsnorm

    def attend_plain(q, k, v, *, causal=True, window=0, q_offset=None):
        return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=causal, window=window,
                                   q_offset=q_offset).transpose(1, 2)

    def decode_plain(q, k_cache, v_cache, kv_len, **kw):
        return flash_decode_ref(q[:, 0], k_cache, v_cache, kv_len, **kw)[:, None]
    fa_ops.flash_attention, fa_ops.flash_decode, rms_ops.rmsnorm = (attend_plain,
                                                                    decode_plain, rmsnorm_ref)
    try:
        yield
    finally:
        fa_ops.flash_attention, fa_ops.flash_decode, rms_ops.rmsnorm = attend, decode, norm


def _static_plain_steps(model, params, reqs, toks):
    """The static loop's steps with its kernels swapped for their plain
    versions (the same GEMMs at the same shapes), teacher-forced with the
    kernel run's tokens. -> [GEN, N, V] f32 numpy."""
    import torch
    from repro_torch.serve import static_batch_from_requests
    forced = torch.from_numpy(toks).cuda()
    with plain_versions():
        logits, cache = model.prefill(params, static_batch_from_requests(model.cfg, reqs, "cuda"),
                                      cache_len=MAX_LEN)
        steps = [logits]
        for i in range(GEN - 1):
            logits, cache = model.decode_step(params, cache, {"tokens": forced[:, i:i + 1]},
                                              PROMPT + i)
            steps.append(logits)
    return torch.stack(steps).float().cpu().numpy()


def static_phase(model, params, line, checked, engine_tokens, dense_tol=None):
    """`run_static` on the engine's trace (8 prompts of 128, 32 greedy
    tokens): the flash-attention prefill of the whole batch, then 31
    lockstep decode steps through the slot-contiguous flash-decode kernel,
    with counts reset just before and read just after.

    Every request's logits are held against the same loop with its kernels
    swapped for their plain versions, teacher-forced with its tokens (the
    same GEMMs at the same shapes, so only the kernels differ): no argmax
    flip where that run's top-2 margin is wide. Against the dense pass
    (other GEMM shapes, naive attention) and the engine's greedy tokens —
    which may part only at a step whose dense margin is narrow — they are
    held when dense_tol is given (2 layers, with the deviations within it)
    and reported at full depth, where bf16 GEMMs of other shapes alone move
    the logits by more than the margin rule allows."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import run_static
    from repro_torch.serve import synth_requests
    cfg = model.cfg
    layers = cfg.num_layers
    reqs = synth_requests(cfg, REQUESTS, PROMPT, GEN, np.random.default_rng(SEED))
    recorded = []          # each step's logits, kept on the card until the end
    prefill, decode_step = model.prefill, model.decode_step

    def prefill_rec(*args, **kw):
        logits, cache = prefill(*args, **kw)
        recorded.append(logits)
        return logits, cache

    def decode_rec(*args, **kw):
        logits, cache = decode_step(*args, **kw)
        recorded.append(logits)
        return logits, cache
    model.prefill, model.decode_step = prefill_rec, decode_rec
    try:
        with launch_signatures() as (seen, calls, launches):
            _, toks, t = run_static(model, reqs, PROMPT, GEN, params=params, device="cuda")
    finally:
        del model.prefill, model.decode_step
    steps = torch.stack(recorded).float().cpu().numpy()        # [GEN, N, V]
    del recorded
    rows = {r.rid: list(steps[:, i]) for i, r in enumerate(reqs)}
    plain_steps = _static_plain_steps(model, params, reqs, toks)
    plain_rows = {r.rid: plain_steps[:, i] for i, r in enumerate(reqs)}
    plain = _deviation(plain_rows, rows)
    for i, r in enumerate(reqs):
        r.tokens = [int(x) for x in toks[i]]
    dense_rows = {r.rid: _dense_rows(model, params, r) for r in reqs}
    dense = _deviation(dense_rows, rows)
    plain_dense = _deviation(dense_rows, {rid: list(x) for rid, x in plain_rows.items()})
    parted = []    # (rid, first step where static and engine differ, its dense margin / max)
    for r in reqs:
        diff = [j for j, (a, b) in enumerate(zip(r.tokens, engine_tokens[r.rid])) if a != b]
        if diff:
            w = dense_rows[r.rid][diff[0]]
            top2 = np.partition(w, -2)[-2:]
            parted.append((r.rid, diff[0], float((top2[1] - top2[0]) / np.abs(w).max())))
    unchecked = sorted(seen - checked)
    checks = {
        "tokens_shape": toks.shape == (REQUESTS, GEN),
        "attention_launches_eq_layers": launches["flash_attention"] == layers,
        "attention_took_wgmma": launches["flash_attention_wgmma"] == layers,
        "decode_launches_eq_layers_x_steps": launches["flash_decode"] == layers * (GEN - 1),
        "decode_took_tensor_core":
            launches["flash_decode_tensor_core"] == launches["flash_decode"],
        "no_paged_or_quantize_launches":
            launches["flash_decode_paged"] == 0 and launches["quantize_rows"] == 0
            and launches["quantize_kv_write"] == 0,
        "rmsnorm_launches_eq_norms_x_steps": launches["rmsnorm"] == (2 * layers + 1) * GEN,
        "every_launch_recorded": calls == launches,
        "every_launch_shape_checked": not unchecked,
        "finite_logits": bool(np.isfinite(steps).all()),
        "plain_argmax": plain["argmax_mismatches"] == 0,
    }
    if dense_tol is not None:
        checks["plain_within_tol"] = plain["worst"] <= dense_tol
        checks["dense_within_tol"] = dense["worst"] <= dense_tol
        checks["dense_argmax"] = dense["argmax_mismatches"] == 0
        checks["engine_parity"] = all(m <= 2.0 ** -4 for _, _, m in parted)
    row = {"phase": "static", "arch": ARCH, "layers": layers, "d_model": cfg.d_model,
           "attn_impl": model.attn_impl, "requests": REQUESTS, "prompt": PROMPT, "gen": GEN,
           "card": line, "prefill_ms": t["prefill_s"] * 1e3, "decode_s": t["decode_s"],
           "decode_tok_s": t["decode_tok_s"], "launches": launches,
           "launch_signatures": sorted(seen), "unchecked_signatures": unchecked,
           "plain": plain, "dense": dense, "plain_vs_dense": plain_dense,
           "dense_tol": dense_tol,
           "engine_parity": {"requests_identical": REQUESTS - len(parted),
                             "parted_at_margin": parted},
           "checks": checks}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"static ({layers} layers): failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def prefill_route_ab_phase(model, params, line):
    """What kernel #1's redesign moves end to end: the static loop's
    prefill step (`build_prefill_step`, as `run_static` builds it: 8
    prompts of 128 into the decode-capacity cache) on the same weights in
    one process, with the prefill attention on its tensor-core route and
    with the CUDA-core kernel (flash_attention_fwd.cu, which takes bf16 at
    head_dim 128 too) called in its place, in turns (tensor cores, CUDA
    cores, CUDA cores, tensor cores), 3 warm prefills a turn, each timed
    on the host clock to its synchronize. The run_static row's prefill_ms
    is one cold call; these are warm. Launches here are not counted."""
    import numpy as np
    import torch
    from repro_torch.config.base import ShapeConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.serve import static_batch_from_requests, synth_requests
    from repro_torch.train.steps import StepSpec, build_prefill_step
    reqs = synth_requests(model.cfg, REQUESTS, PROMPT, GEN, np.random.default_rng(SEED))
    batch = static_batch_from_requests(model.cfg, reqs, "cuda")
    prefill_fn, _ = build_prefill_step(model, ShapeConfig("serve_prefill", "prefill", PROMPT,
                                                          REQUESTS), StepSpec(cache_len=MAX_LEN))
    attend = fa_ops.flash_attention

    def cuda_core(q, k, v, *, causal=True, window=0, q_offset=None):
        if q_offset is None:
            q_offset = k.shape[1] - q.shape[1] if causal else 0
        out = torch.empty_like(q)
        _build.extension().flash_attention(q, k, v, out, bool(causal), int(window),
                                           int(q_offset), 1.0 / math.sqrt(q.shape[-1]))
        return out
    times = {"wgmma": [], "cuda_core": []}
    prefill_fn(params, batch)                   # warm: allocator, cuBLAS
    for route in ("wgmma", "cuda_core", "cuda_core", "wgmma"):
        fa_ops.flash_attention = attend if route == "wgmma" else cuda_core
        try:
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prefill_fn(params, batch)
                torch.cuda.synchronize()
                times[route].append((time.perf_counter() - t0) * 1e3)
        finally:
            fa_ops.flash_attention = attend
    med = {r: float(np.median(t)) for r, t in times.items()}
    row = {"phase": "prefill_route_ab", "arch": ARCH, "layers": model.cfg.num_layers,
           "requests": REQUESTS, "prompt": PROMPT, "card": line, "prefill_ms": times,
           "median_ms": med, "wgmma_minus_cuda_core_ms": med["wgmma"] - med["cuda_core"]}
    emit(row)
    return row


def _shapes(tree):
    """Sorted leaf shapes of a nested dict (of tensors or ParamDefs)."""
    if isinstance(tree, dict):
        return sorted(x for sub in tree.values() for x in _shapes(sub))
    return [tuple(tree.shape)]


def slot_decode_phase(model, params, line, checked):
    """The slot decode step without a page arena (slot-contiguous caches,
    the flash_decode kernel) against the paged step (flash_decode_paged)
    on the same params, cache contents, positions and tokens, with model-
    width then int8 KV: 4 steps of 4 slots (one inactive), counts reset
    just before and read just after; the logits of the active slots within
    2**-5 of each row's max |logit|. -> {kv_dtype: the run's launches}."""
    import numpy as np
    import torch
    from repro_torch.config.base import ShapeConfig
    from repro_torch.models import kvquant
    from repro_torch.models.paging import PageArena
    from repro_torch.train.steps import StepSpec, build_slot_decode_step
    cfg = model.cfg
    layers = cfg.num_layers
    steps = 4
    shape = ShapeConfig("slot_decode", "decode", MAX_LEN, SLOTS)
    max_pages = MAX_LEN // PAGE
    arena = PageArena(page_size=PAGE, device_pages=DEVICE_PAGES, slots=SLOTS,
                      max_pages=max_pages)
    start = np.array([120, 97, 0, 33], np.int32)
    active = np.array([True, True, False, True])
    rng = np.random.default_rng(SEED + 3)
    # a scrambled table mapping every page the steps reach; the rest null
    table = np.full((SLOTS, max_pages), DEVICE_PAGES, np.int32)
    perm = rng.permutation(DEVICE_PAGES)
    nxt = 0
    for b in np.flatnonzero(active):
        need = -(-(int(start[b]) + steps) // PAGE)
        table[b, :need] = perm[nxt:nxt + need]
        nxt += need
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    content = {key: torch.randn((layers, SLOTS, MAX_LEN, K, D), generator=gen,
                                device="cuda").bfloat16() for key in ("k", "v")}
    toks = rng.integers(0, cfg.vocab_size, (steps, SLOTS, 1))
    active_t = torch.from_numpy(active).cuda()
    out = {}
    for kv_dtype in ("model", "int8"):
        layer = (kvquant.quantize_cache_tree(content) if kv_dtype == "int8"
                 else dict(content))
        contiguous = {"stack0": {"attn_0": {key: x.clone() for key, x in layer.items()}}}
        paged_layer = {}
        for key, x in layer.items():      # [L, SLOTS, MAX_LEN, ...] -> arena rows
            a = torch.zeros((layers, DEVICE_PAGES + 1, PAGE) + tuple(x.shape[3:]),
                            dtype=x.dtype, device="cuda")
            for b, j in zip(*np.nonzero(table != DEVICE_PAGES)):
                a[:, table[b, j]] = x[:, b, j * PAGE:(j + 1) * PAGE]
            paged_layer[key] = a
        paged = {"stack0": {"attn_0": paged_layer},
                 "page_table": torch.from_numpy(table).cuda()}
        runs = {}
        with launch_signatures() as (seen, calls, launches):
            for name, cache, spec in (("contiguous", contiguous, StepSpec(kv_dtype=kv_dtype)),
                                      ("paged", paged, StepSpec(kv_dtype=kv_dtype, arena=arena))):
                fn, defs = build_slot_decode_step(model, shape, spec)
                assert _shapes(defs) == _shapes(cache), (name, _shapes(defs), _shapes(cache))
                logits = []
                for i in range(steps):
                    pos = torch.from_numpy(np.where(active, start + i, 0).astype(np.int32)).cuda()
                    lg, _ = fn(params, cache, {"tokens": torch.from_numpy(toks[i]).cuda()},
                               pos, active_t)
                    logits.append(lg[active_t].float())
                runs[name] = torch.stack(logits)
        got, want = runs["contiguous"], runs["paged"]
        dev = ((got - want).abs().amax(dim=-1) / want.abs().amax(dim=-1)).max().item()
        unchecked = sorted(seen - checked)
        # int8: one fused k/v write a layer a step, in each of the two runs
        writes = 2 * layers * steps if kv_dtype == "int8" else 0
        checks = {
            "contiguous_launches_eq_layers_x_steps": launches["flash_decode"] == layers * steps,
            "paged_launches_eq_layers_x_steps": launches["flash_decode_paged"] == layers * steps,
            "decode_took_tensor_core":
                launches["flash_decode_tensor_core"] == layers * steps
                and launches["flash_decode_paged_tensor_core"] == layers * steps,
            "quantize_launches": launches["quantize_kv_write"] == writes
                                 and launches["quantize_rows"] == 0,
            "rmsnorm_launches": launches["rmsnorm"] == 2 * (2 * layers + 1) * steps,
            "every_launch_recorded": calls == launches,
            "every_launch_shape_checked": not unchecked,
            "finite_logits": bool(torch.isfinite(got).all()),
            "within_tol": dev <= 2.0 ** -5,
        }
        emit({"phase": "slot_decode", "kv_dtype": kv_dtype, "layers": layers, "slots": SLOTS,
              "max_len": MAX_LEN, "steps": steps, "card": line, "max_dev": dev,
              "bitwise_equal": bool(torch.equal(got, want)), "tolerance": 2.0 ** -5,
              "launches": launches, "launch_signatures": sorted(seen),
              "unchecked_signatures": unchecked, "checks": checks})
        if not all(checks.values()):
            raise AssertionError(f"slot decode {kv_dtype}: failed checks "
                                 f"{[k for k, v in checks.items() if not v]}")
        out[kv_dtype] = launches
    return out


def busy_seconds(intervals) -> float:
    """Length of the union of [start_ns, end_ns) intervals, in seconds:
    time in which at least one of them ran."""
    total = 0
    cur_start = cur_end = None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total / 1e9


def device_summary(prof, wall: float):
    """What a torch.profiler run saw on the card. The device is busy while
    at least one kernel, copy or fill runs (the union of their intervals,
    so overlaps count once); its busy share is that over `wall`, the
    host's seconds for the run, which the profiler's own host overhead
    lengthens, so the share is a lower bound. The port's own kernels (the
    `__global__` functions of csrc/) are also summed by kernel. -> a dict
    for the phase row."""
    import re
    from torch.autograd import DeviceType
    from repro_torch.kernels import _build
    ours = {name for src in _build.CSRC.glob("*.cu") for name in re.findall(
        r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?\s+(\w+)\(", src.read_text())}
    intervals, by_name, runtime_launches = [], {}, 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            start, dur = ev.start_ns(), ev.duration_ns()
            intervals.append((start, start + dur))
            total, count = by_name.get(ev.name(), (0, 0))
            by_name[ev.name()] = (total + dur, count + 1)
        elif ev.name() in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"):
            runtime_launches += 1
    if not intervals:
        raise AssertionError("the profiler saw no device activity")
    busy = busy_seconds(intervals)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    port = {}
    for n, (t, c) in by_name.items():
        short = re.sub(r"[<(].*", "", n.replace("(anonymous namespace)", ""))
        short = short.split("::")[-1].split()[-1]
        if short in ours:
            total, count = port.get(short, (0, 0))
            port[short] = (total + t, count + c)
    return {"run_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
            "device_summed_s": sum(e - s for s, e in intervals) / 1e9,
            "device_events": len(intervals), "runtime_launch_calls": runtime_launches,
            "top_device": [{"name": n[:120], "s": t / 1e9, "count": c} for n, (t, c) in top],
            "port_kernels": {n: {"s": t / 1e9, "count": c} for n, (t, c) in sorted(port.items())}}


def profile_phase(model, params, line):
    """The trace once more with each KV width, under torch.profiler: the
    device's busy share over the seconds of eng.run, its top kernels, and
    the runtime launch calls of the run and per layer-tick (every launch of
    the run over layers x ticks: what the host dispatches for one layer of
    one decode step, the prefill's spread over them). -> {kv_dtype: row}."""
    from torch.profiler import ProfilerActivity, profile
    rows = {}
    for kv_dtype in ("model", "int8"):
        t0 = time.monotonic()
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        eng, _, _, wall = _serve(model, params, kv_dtype, around_run=prof)
        m = eng.metrics()
        summary = device_summary(prof, wall)
        layer_ticks = model.cfg.num_layers * int(m["ticks"])
        rows[kv_dtype] = {"phase": "profile", "kv_dtype": kv_dtype,
                          "layers": model.cfg.num_layers, "card": line,
                          "seconds": time.monotonic() - t0, **summary, "ticks": m["ticks"],
                          "layer_ticks": layer_ticks,
                          "launch_calls_per_layer_tick":
                              summary["runtime_launch_calls"] / layer_ticks,
                          "decode_tok_s": m["decode_tok_s"]}
        emit(rows[kv_dtype])
        del eng, prof
    return rows


def compare_logits(got, want, margin: float):
    """Logits [..., V] of a run against a reference's, row by row on the
    card. -> {"worst": max over rows of max |diff| / max |want|,
    "argmax_flips": rows whose argmax differs, "argmax_flips_wide": those
    where want's top-2 margin exceeds `margin` of its max |logit|,
    "wide_rows": rows with such a margin, "rows"}."""
    import torch
    v = want.shape[-1]
    g_all, w_all = got.reshape(-1, v), want.reshape(-1, v)
    worst, flips, flips_wide, wide = 0.0, 0, 0, 0
    for i in range(0, w_all.shape[0], 1024):
        g, w = g_all[i:i + 1024].float(), w_all[i:i + 1024].float()
        top = w.abs().amax(dim=-1)
        worst = max(worst, ((g - w).abs().amax(dim=-1) / top.clamp_min(1e-30)).max().item())
        top2 = w.topk(2, dim=-1).values
        is_wide = (top2[:, 0] - top2[:, 1]) > margin * top
        flip = g.argmax(dim=-1) != w.argmax(dim=-1)
        flips += int(flip.sum().item())
        flips_wide += int((flip & is_wide).sum().item())
        wide += int(is_wide.sum().item())
    return {"worst": worst, "argmax_flips": flips, "argmax_flips_wide": flips_wide,
            "wide_rows": wide, "rows": int(w_all.shape[0]), "margin": margin}


def forward_phase(model, params, line, checked):
    """qwen2.5-14b `Model.forward` (2 layers, attn_impl="pallas") on the
    static prefill's batch, 8 prompts of 128, against `Model.prefill` on
    the same tokens: the same ops at the same shapes up to the head, so the
    hidden state entering the head is bitwise equal at the last position;
    the head's GEMM has another M (all rows against the last), so the
    logits are held within one bf16 ulp of each row's max |logit|. Counts
    reset just before, read just after: per layer 1 flash-attention and 2
    RMSNorm launches each, and the final norm."""
    import numpy as np
    import torch
    from repro_torch.models import model as model_mod
    rng = np.random.default_rng(SEED + 4)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (REQUESTS, PROMPT))).cuda()
    heads = []
    head = model_mod.lm_logits

    def head_rec(cfg, p, x):
        heads.append(x)
        return head(cfg, p, x)
    model_mod.lm_logits = head_rec
    try:
        with torch.no_grad(), launch_signatures() as (seen, calls, launches):
            logits, aux = model.forward(params, {"tokens": toks})
            last, _ = model.prefill(params, {"tokens": toks})
    finally:
        model_mod.lm_logits = head
    layers = model.cfg.num_layers
    diff = (logits[:, -1].float() - last.float()).abs()
    ulps = (diff / bf16_row_ulp(last)).max().item()
    unchecked = sorted(seen - checked)
    checks = {
        "logits_shape": tuple(logits.shape) == (REQUESTS, PROMPT, model.cfg.vocab_size),
        "aux_zero": aux.item() == 0.0,
        "hidden_bitwise_equal": torch.equal(heads[0][:, -1], heads[1][:, 0]),
        "last_row_within_1_ulp": ulps <= 1.0,
        "same_argmax": torch.equal(logits[:, -1].argmax(-1), last.argmax(-1)),
        "attention_launches": launches["flash_attention"] == 2 * layers,
        "attention_took_wgmma": launches["flash_attention_wgmma"] == 2 * layers,
        "rmsnorm_launches": launches["rmsnorm"] == 2 * (2 * layers + 1),
        "every_launch_recorded": calls == launches,
        "every_launch_shape_checked": not unchecked,
        "finite_logits": bool(torch.isfinite(logits).all()),
    }
    row = {"phase": "forward_vs_prefill", "arch": ARCH, "layers": layers,
           "attn_impl": model.attn_impl, "batch": REQUESTS, "seq": PROMPT, "card": line,
           "last_row_bitwise_equal": torch.equal(logits[:, -1], last),
           "last_row_max_ulps": ulps, "launches": launches,
           "launch_signatures": sorted(seen), "unchecked_signatures": unchecked,
           "checks": checks}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"forward vs prefill: failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def f32_attention_phase(line, checked):
    """Kernel #1's CUDA-core route on its own path. No configuration of the
    repo reaches that route from a model (all are bf16 at head_dim 64, 128
    or 256), so its path is the attention entry `flash_attention` on f32
    tensors at qwen2.5-14b's attention width and the static prefill's
    shape (q [8, 128, 40, 128], k and v [8, 128, 8, 128]), counts reset
    just before and read just after: one launch, on the CUDA cores, of a
    shape the kernel phases checked, and a finite f32 output."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    q = torch.randn((REQUESTS, PROMPT, H, D), generator=gen, device="cuda")
    k, v = (torch.randn((REQUESTS, PROMPT, K, D), generator=gen, device="cuda")
            for _ in range(2))
    with launch_signatures() as (seen, calls, launches):
        o = fa_ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
    unchecked = sorted(seen - checked)
    checks = {
        "one_launch": launches["flash_attention"] == 1,
        "took_cuda_core": launches["flash_attention_cuda_core"] == 1,
        "every_launch_recorded": calls == launches,
        "every_launch_shape_checked": not unchecked,
        "f32_output": o.shape == q.shape and o.dtype == torch.float32,
        "finite": bool(torch.isfinite(o).all()),
    }
    row = {"phase": "f32_attention", "q": list(q.shape), "kv": list(k.shape), "card": line,
           "launches": launches, "launch_signatures": sorted(seen),
           "unchecked_signatures": unchecked, "checks": checks}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"f32 attention: failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def f32_ssd_phase(line, checked):
    """The SSD scan's CUDA-core route on its own path. The repo's Mamba-2
    config (bf16, head_dim 64, state 128) reaches only the tensor-core
    route, so this path is the scan entry `ssd_scan` on f32 views of one
    buffer, as apply_ssm hands them over, at mamba2-1.3b's widths (64 heads
    of 64, state 128, chunk 256) on 2 x 2048 tokens, counts reset just
    before and read just after: one launch, on the CUDA cores, of a shape
    the kernel phases checked, and a finite f32 output."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    x, dt, A, B, C = _ssd_inputs(2, SSD_LEN, 64, 64, 1, 128, torch.float32, 26, "softplus")
    with launch_signatures() as (seen, calls, launches):
        y = ssd_ops.ssd_scan(x, dt, A, B, C, chunk=256)
        torch.cuda.synchronize()
    unchecked = sorted(seen - checked)
    checks = {
        "one_launch": launches["ssd_scan"] == 1,
        "took_cuda_core": launches["ssd_scan_cuda_core"] == 1,
        "every_launch_recorded": calls == launches,
        "every_launch_shape_checked": not unchecked,
        "f32_output": y.shape == x.shape and y.dtype == torch.float32,
        "finite": bool(torch.isfinite(y).all()),
    }
    row = {"phase": "f32_ssd", "x": list(x.shape), "card": line, "launches": launches,
           "launch_signatures": sorted(seen), "unchecked_signatures": unchecked,
           "checks": checks}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"f32 ssd scan: failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def _first_layers(params, n: int):
    """The model's params with the decoder cut to its first n layers
    (views into the stacked [L, ...] leaves)."""
    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:n]
    return {**params, "decoder": cut(params["decoder"])}


def _mamba_batch(cfg, seed):
    """SSD_BATCH sequences of SSD_LEN random tokens, next-token labels."""
    import numpy as np
    import torch
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (SSD_BATCH, SSD_LEN + 1))
    return {"tokens": torch.from_numpy(toks[:, :-1]).cuda(),
            "labels": torch.from_numpy(toks[:, 1:]).cuda()}


def _trained_dt_bias(params, seed):
    """Every dt_bias leaf drawn as Mamba-2 draws it, in place: softplus^-1
    of a per-head dt0 log-uniform on [1e-3, 1e-1]. (The JAX package and
    the port init it to 0, so dt = softplus(dt_raw) ~ 0.7 and exp(cum_last)
    over a chunk of 256 rows is ~0: the state carried across chunks would
    not show in the comparison.)"""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for key, leaf in params.items():
        if isinstance(leaf, dict):
            _trained_dt_bias(leaf, seed + 1)
        elif key == "dt_bias":
            dt0 = _log_uniform(leaf.shape, 1e-3, 1e-1, gen)
            leaf.copy_(dt0 + torch.log(-torch.expm1(-dt0)))


def _timed_forward(model, params, batch):
    """-> (logits, aux, seconds to the last kernel's end)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, aux = model.forward(params, batch)
    torch.cuda.synchronize()
    return logits, aux, time.monotonic() - t0


def mamba_phases(line, checked):
    """mamba2-1.3b's forward and loss at full width (d_model 2048, 64 SSM
    heads of 64, state 128, chunk 256, vocab 50280) on 4 x 2048 tokens,
    random weights from a seed with dt_bias as Mamba-2 draws it (so the
    state carried across chunks counts), with counts reset just before and
    read just after each run.

    2 layers: Model(ssd_impl="pallas").forward and .loss against the same
    model with ssd_impl="ref" (the plain scan; every other op the same):
    logits within 2**-5 of each row's max |logit|, no argmax flip where
    the plain run's top-2 margin exceeds that, the loss within 1%.
    Each forward launches the RMSNorm kernel layers + 1 times.
    48 layers: the forward through the kernel, 48 launches exactly, against
    the same forward through the plain scan: no argmax flip where the
    margin exceeds 2**-4 of the row max (48 random bf16 layers carry
    one-ulp differences far: the value deviation is reported, not held),
    both losses reported; the forward timed three more times, and once
    under torch.profiler (busy share, top kernels).
    -> the 48-layer row."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.layers import cross_entropy
    from repro_torch.models.model import Model
    cfg = get_config(MAMBA)
    t0 = time.monotonic()
    params = Model(cfg).init(SEED + 5, "cuda")
    _trained_dt_bias(params, SEED + 6)
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": MAMBA, "seconds": time.monotonic() - t0,
          "params": cfg.param_count(), "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    batch = _mamba_batch(cfg, SEED + 5)
    tokens = SSD_BATCH * SSD_LEN

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    params2 = _first_layers(params, 2)
    kernel2, plain2 = Model(cfg2, ssd_impl="pallas"), Model(cfg2, ssd_impl="ref")
    with torch.no_grad():
        with launch_signatures() as (seen, calls, launches):
            logits_k, aux_k = kernel2.forward(params2, batch)
            loss_k, parts_k = kernel2.loss(params2, batch)
        logits_p, _ = plain2.forward(params2, batch)
        loss_p, _ = plain2.loss(params2, batch)
    cmp2 = compare_logits(logits_k, logits_p, 2.0 ** -5)
    unchecked = sorted(seen - checked)
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    checks = {
        "logits_shape": tuple(logits_k.shape) == (SSD_BATCH, SSD_LEN, cfg.vocab_size),
        "aux_zero": aux_k.item() == 0.0,
        "scan_launches_eq_layers_x_2": launches["ssd_scan"] == 2 * 2,
        "scan_on_tensor_cores": launches["ssd_scan_tensor_core"] == 2 * 2,
        "rmsnorm_launches_eq_2_x_(layers+1)": launches["rmsnorm"] == 2 * (2 + 1),
        "no_other_launches": all(n == 0 for k, n in launches.items()
                                 if k.split("_")[0] not in ("ssd", "rmsnorm")),
        "every_launch_recorded": calls == launches,
        "every_launch_shape_checked": not unchecked,
        "finite": bool(torch.isfinite(logits_k).all()) and bool(torch.isfinite(loss_k)),
        "within_2**-5": cmp2["worst"] <= 2.0 ** -5,
        "argmax_wide": cmp2["argmax_flips_wide"] == 0,
        "loss_within_1%": loss_rel <= 1e-2,
    }
    emit({"phase": "mamba2_reference", "arch": MAMBA, "layers": 2, "batch": SSD_BATCH,
          "seq": SSD_LEN, "card": line, "plain": cmp2, "loss_kernel": loss_k.item(),
          "loss_plain": loss_p.item(), "ce_kernel": parts_k["ce"].item(),
          "loss_rel_diff": loss_rel, "launches": launches,
          "launch_signatures": sorted(seen), "unchecked_signatures": unchecked,
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"mamba2 2 layers: failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    del logits_k, logits_p, params2
    torch.cuda.empty_cache()

    layers = cfg.num_layers
    kernel_model, plain_model = Model(cfg, ssd_impl="pallas"), Model(cfg, ssd_impl="ref")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        with launch_signatures() as (seen, calls, launches):
            logits_k, aux_k, kernel_s = _timed_forward(kernel_model, params, batch)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        loss_k = cross_entropy(logits_k, batch["labels"]).item()
        logits_p, _, plain_s = _timed_forward(plain_model, params, batch)
        loss_p = cross_entropy(logits_p, batch["labels"]).item()
        cmp48 = compare_logits(logits_k, logits_p, 2.0 ** -4)
        finite = bool(torch.isfinite(logits_k).all())
        del logits_k, logits_p
        again = [_timed_forward(kernel_model, params, batch)[2] for _ in range(3)]
        again_plain = _timed_forward(plain_model, params, batch)[2]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled_s = _timed_forward(kernel_model, params, batch)[2]
    unchecked = sorted(seen - checked)
    checks = {
        "scan_launches_eq_layers": launches["ssd_scan"] == layers,
        "scan_on_tensor_cores": launches["ssd_scan_tensor_core"] == layers,
        "rmsnorm_launches_eq_layers+1": launches["rmsnorm"] == layers + 1,
        "no_other_launches": all(n == 0 for k, n in launches.items()
                                 if k.split("_")[0] not in ("ssd", "rmsnorm")),
        "every_launch_recorded": calls == launches,
        "every_launch_shape_checked": not unchecked,
        "finite": finite and loss_k == loss_k,
        "argmax_wide": cmp48["argmax_flips_wide"] == 0,
    }
    row = {"phase": "mamba2_forward", "arch": MAMBA, "layers": layers, "batch": SSD_BATCH,
           "seq": SSD_LEN, "card": line, "forward_s": kernel_s, "forward_s_again": again,
           "tokens_per_s": tokens / min(again), "plain_forward_s": [plain_s, again_plain],
           "max_memory_allocated_gb": peak_gb, "plain": cmp48, "loss_kernel": loss_k,
           "loss_plain": loss_p, "launches": launches, "launch_signatures": sorted(seen),
           "unchecked_signatures": unchecked, "checks": checks,
           "profile": device_summary(prof, profiled_s)}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"mamba2 48 layers: failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    del params
    torch.cuda.empty_cache()
    return row


def _train_config(layers: int, **kw):
    """qwen2.5-14b at full width, cut to `layers`, trained on one device with
    LMS off on TRAIN_BATCH x TRAIN_SEQ tokens a step."""
    import dataclasses
    from repro_torch.config.base import LMSConfig, MeshSpec, ShapeConfig, TrainConfig
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(ARCH), num_layers=layers)
    return TrainConfig(model=cfg, shape=ShapeConfig("train", "train", TRAIN_SEQ, TRAIN_BATCH),
                       mesh=MeshSpec((1, 1), ("data", "model")),
                       lms=LMSConfig(enabled=False), seed=SEED, **kw)


def _rel_frobenius(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


@contextlib.contextmanager
def _norm_as(fn):
    """The RMSNorm dispatcher the model calls swapped for fn."""
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    norm = rms_ops.rmsnorm
    rms_ops.rmsnorm = fn
    try:
        yield
    finally:
        rms_ops.rmsnorm = norm


def _plain_norm_analytic_backward(x, scale, *, eps=1e-6):
    """RMSNorm's plain forward with the kernel Function's backward (the
    analytic gradient in f32): a second plain version, which differs from
    autograd through the plain version only in the backward's f32
    roundings."""
    import torch
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

    class PlainAnalytic(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, scale):
            ctx.save_for_backward(x, scale)
            return rmsnorm_ref(x, scale, eps=eps)

        @staticmethod
        def backward(ctx, dy):
            return rmsnorm_bwd_ref(*ctx.saved_tensors, dy, eps=eps)
    return PlainAnalytic.apply(x, scale)


def train_reference_phase(line, checked):
    """3 steps of `build_train_step` at 2 layers from one init (a seeded
    torch generator, drawn again for each run) on the same 3 batches of the
    synthetic stream, through the kernels (counts reset just before, read
    just after) and through the plain versions; and step 1 once more with
    the plain forward and the kernel's analytic backward, the rounding
    floor: two plain versions that differ only in f32 roundings.

    Held: each step's loss and grad norm within 1%; exactly 4L+1 RMSNorm
    launches a step (2L+1 in the forward, 2L in the checkpointed layers'
    recompute) and none through the plain versions; step 1's grads leaf by
    leaf within 2**-5 relative Frobenius error. At random init the bf16
    grads are small sums of large terms that cancel, so roundings move
    them far: the kernel's outputs differ from the plain version's in a
    small share of elements by one bf16 ulp (the kernel rows report it),
    yet the grads move by about 1%, and the floor route lies about as far
    from the plain one. Both errors are reported.

    The A/B of that gap (ROADMAP 3.3): step 1 once more with RMSNorm swapped
    for its plain version as `plain_versions()` swaps it and every other
    kernel on (in training none other runs), reported against the plain
    run (what a rerun of it gives) and against the kernel run; and the
    floor route against the kernel run, the two differing only in
    RMSNorm's forward (kernel against plain)."""
    import torch
    from repro_torch.data import DataLoader, SyntheticTokens
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.models.model import Model
    from repro_torch.train import steps as steps_mod
    from repro_torch.tree import tree_leaves, tree_map
    L, n = TRAIN_CHECK_LAYERS, TRAIN_CHECK_STEPS
    tcfg = _train_config(L, learning_rate=TRAIN_LR, warmup_steps=0, total_steps=n)
    model = Model(tcfg.model)
    loader = DataLoader(SyntheticTokens(tcfg.model.vocab_size, seed=SEED), shard=0,
                        num_shards=1, batch_per_shard=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in next(loader).items()}
               for _ in range(n)]
    clip = steps_mod.clip_by_global_norm

    def run(around, steps):
        """-> (step 1's grads, [metrics as floats], [RMSNorm launches a
        step], what `around` yields)."""
        state = steps_mod.init_train_state(model, tcfg, SEED + 7, "cuda")
        step = steps_mod.build_train_step(model, tcfg)
        first = []

        def clip_rec(grads, max_norm):
            if not first:
                first.append(tree_map(lambda g: g.clone(), grads))
            return clip(grads, max_norm)
        steps_mod.clip_by_global_norm = clip_rec
        mets, per_step = [], []
        try:
            with around as rec:
                for b in batches[:steps]:
                    before = _launchers()["rmsnorm"].launches
                    state, m = step(state, b)
                    mets.append({k: float(v) for k, v in m.items()})
                    per_step.append(_launchers()["rmsnorm"].launches - before)
        finally:
            steps_mod.clip_by_global_norm = clip
        del state
        torch.cuda.empty_cache()
        return first[0], mets, per_step, rec

    def leaf_errors(got, want):
        return {f"/{i}": _rel_frobenius(g, w.to(g.device))
                for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want)))}

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    grads_k, mets_k, per_step, (seen, calls, launches) = run(launch_signatures(), n)
    kernel_s = time.monotonic() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    grads_p, mets_p, plain_per_step, _ = run(plain_versions(), n)
    names = []
    tree_map(lambda g: names.append(tuple(g.shape)), grads_k)
    err = leaf_errors(grads_k, grads_p)
    dtypes_ok = all(g.dtype == p.dtype for g, p in zip(tree_leaves(grads_k),
                                                      tree_leaves(grads_p)))
    grads_k = tree_map(lambda g: g.cpu(), grads_k)     # kept on the host for the A/B
    torch.cuda.empty_cache()
    grads_f, _, floor_per_step, _ = run(_norm_as(_plain_norm_analytic_backward), 1)
    floor = leaf_errors(grads_f, grads_p)
    floor_vs_kernel = leaf_errors(grads_f, grads_k)
    del grads_f
    torch.cuda.empty_cache()
    # A/B of the kernel route's gap: RMSNorm swapped for its plain version as
    # plain_versions() swaps it (plain forward, autograd backward), every
    # other kernel left on (none other runs in training): step 1 again
    grads_a, _, ab_per_step, _ = run(_norm_as(rmsnorm_ref), 1)
    ab_vs_plain = leaf_errors(grads_a, grads_p)
    ab_vs_kernel = leaf_errors(grads_a, grads_k)
    del grads_p, grads_a, grads_k
    torch.cuda.empty_cache()
    rel = {k: [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(mets_k, mets_p)]
           for k in ("loss", "grad_norm")}
    unchecked = sorted(seen - checked)
    checks = {
        "grads_within_2**-5": max(err.values()) <= 2.0 ** -5,
        "grad_dtypes": dtypes_ok,
        "loss_within_1%": max(rel["loss"]) <= 1e-2,
        "grad_norm_within_1%": max(rel["grad_norm"]) <= 1e-2,
        "finite": all(x == x and abs(x) != float("inf") for m in mets_k for x in m.values()),
        "rmsnorm_launches_4L+1_a_step": per_step == [4 * L + 1] * n,
        "plain_runs_launch_no_rmsnorm":
            plain_per_step + floor_per_step + ab_per_step == [0] * (n + 2),
        "no_other_launches": all(v == 0 for k, v in launches.items()
                                 if not k.startswith("rmsnorm")),
        "every_launch_recorded": calls == launches,
        "every_launch_shape_checked": not unchecked,
    }
    row = {"phase": "train_reference", "arch": ARCH, "layers": L, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": n, "lr": TRAIN_LR, "card": line,
           "loss_kernel": [m["loss"] for m in mets_k], "loss_plain": [m["loss"] for m in mets_p],
           "grad_norm_kernel": [m["grad_norm"] for m in mets_k],
           "grad_norm_plain": [m["grad_norm"] for m in mets_p], "rel_diff": rel,
           "grad_rel_frobenius_max": max(err.values()),
           "grad_rel_frobenius_floor_max": max(floor.values()),
           "grad_rel_frobenius_floor_vs_kernel_max": max(floor_vs_kernel.values()),
           "ab_plain_rmsnorm_vs_plain_max": max(ab_vs_plain.values()),
           "ab_plain_rmsnorm_vs_kernel_max": max(ab_vs_kernel.values()),
           "grad_leaf_shapes": names, "grad_rel_frobenius": err,
           "grad_rel_frobenius_floor": floor,
           "grad_rel_frobenius_floor_vs_kernel": floor_vs_kernel,
           "ab_plain_rmsnorm_vs_plain": ab_vs_plain, "ab_plain_rmsnorm_vs_kernel": ab_vs_kernel,
           "rmsnorm_launches_per_step": per_step, "launches": launches,
           "kernel_run_s": kernel_s, "max_memory_allocated_gb": peak_gb,
           "launch_signatures": sorted(seen), "unchecked_signatures": unchecked,
           "checks": checks}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"train reference ({L} layers): failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def _train_flops(cfg, tokens: int, seq: int):
    """-> (model FLOPs a step, FLOPs a step with the recompute): 6 N T over
    the matmul params N (attention and MLP projections and the head; the
    embedding is a lookup) plus causal attention (QK^T and PV, 4 D per
    visible (query, key) pair a head, 3x for forward and backward); the
    recompute runs every layer's forward once more."""
    d, hd = cfg.d_model, cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    layer = d * hd + 2 * d * kvd + hd * d + 3 * d * cfg.d_ff
    head = d * cfg.vocab_size
    pairs = tokens * (seq + 1) / 2                 # visible pairs over the batch
    attn_fwd = 4 * hd * pairs * cfg.num_layers
    model = 6 * (layer * cfg.num_layers + head) * tokens + 3 * attn_fwd
    return model, model + 2 * layer * cfg.num_layers * tokens + attn_fwd


def device_time_by_kind(prof) -> dict:
    """Device seconds of a torch.profiler run by kind of kernel: cuBLAS
    GEMMs (bf16 on the tensor cores, f32 on the CUDA cores), the port's
    RMSNorm kernel, reductions, and the elementwise kernels and copies."""
    from torch.autograd import DeviceType
    out = {"gemm_bf16_s": 0.0, "gemm_f32_s": 0.0, "rmsnorm_kernel_s": 0.0,
           "reduce_s": 0.0, "elementwise_and_copy_s": 0.0}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        name, dur = ev.name(), ev.duration_ns() / 1e9
        if "f32f32" in name and "gemm" in name:
            out["gemm_f32_s"] += dur
        elif any(k in name for k in ("gemm", "nvjet", "xmma", "cutlass")):
            out["gemm_bf16_s"] += dur
        elif "rmsnorm_kernel" in name:
            out["rmsnorm_kernel_s"] += dur
        elif "reduce" in name:
            out["reduce_s"] += dur
        else:
            out["elementwise_and_copy_s"] += dur
    return out


def step_split_ms(step_fn, state, batch):
    """One train step with CUDA events at its start, at the clip (the end
    of the loss and its grads: forward, the layers' recompute and the
    backward), after the clip and at its end (the optimizer). -> (state,
    {part: ms}); device time, idle gaps included."""
    import torch
    from repro_torch.train import steps as steps_mod
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    clip = steps_mod.clip_by_global_norm

    def clip_timed(grads, max_norm):
        ev[1].record()
        out = clip(grads, max_norm)
        ev[2].record()
        return out
    steps_mod.clip_by_global_norm = clip_timed
    try:
        ev[0].record()
        state, _ = step_fn(state, batch)
        ev[3].record()
    finally:
        steps_mod.clip_by_global_norm = clip
    torch.cuda.synchronize()
    return state, {"loss_and_grads_ms": ev[0].elapsed_time(ev[1]),
                   "clip_ms": ev[1].elapsed_time(ev[2]),
                   "optimizer_ms": ev[2].elapsed_time(ev[3]),
                   "step_ms": ev[0].elapsed_time(ev[3])}


def trainer_phase(line, checked):
    """The main path: `Trainer(tcfg).train(TRAIN_STEPS)` at 4 layers of
    qwen2.5-14b's full width (warmup 1, lr 3e-4, log_every 1, so each step
    is timed to its last kernel), counts reset just before and read just
    after: finite losses, 4L+1 RMSNorm launches a step and no other kernel
    (blockwise attention, as the JAX trainer's default); then one more step
    under torch.profiler (busy share, top kernels, device time by kind of
    kernel) and one split by CUDA events into the loss and its grads, the
    clip and the optimizer. -> the phase row."""
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import tree_leaves
    L = TRAIN_LAYERS
    tcfg = _train_config(L, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                         total_steps=TRAIN_STEPS)
    trainer = Trainer(tcfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with launch_signatures() as (seen, calls, launches):
        state, hist = trainer.train(steps=TRAIN_STEPS)
    run_s = time.monotonic() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batch = trainer._make_batch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.monotonic()
        state, _ = trainer.step_fn(state, batch)
        torch.cuda.synchronize()
        profiled_s = time.monotonic() - t1
    state, split = step_split_ms(trainer.step_fn, state, batch)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = statistics.median(r["time_s"] for r in hist[1:])
    model_flops, hw_flops = _train_flops(tcfg.model, tokens, TRAIN_SEQ)
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    unchecked = sorted(seen - checked)
    checks = {
        "steps": [r["step"] for r in hist] == list(range(1, TRAIN_STEPS + 1)),
        "finite_losses": all(r["loss"] == r["loss"] and abs(r["loss"]) != float("inf")
                             for r in hist),
        "rmsnorm_launches_4L+1_a_step": launches["rmsnorm"] == (4 * L + 1) * TRAIN_STEPS,
        "no_other_launches": all(v == 0 for k, v in launches.items()
                                 if not k.startswith("rmsnorm")),
        "every_launch_recorded": calls == launches,
        "every_launch_shape_checked": not unchecked,
    }
    row = {"phase": "trainer", "arch": ARCH, "layers": L, "d_model": tcfg.model.d_model,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "lr": TRAIN_LR,
           "warmup": TRAIN_WARMUP, "card": line, "params": n_params,
           "why_4_layers": "params + grads + f32 Adam mu/nu/master stay resident at ~16 B a "
                           "param (~42.5 GB); all 48 layers need ~236 GB, the case of LMS "
                           "(lms_ab, lms_gate)",
           "loss": [r["loss"] for r in hist], "grad_norm": [r["grad_norm"] for r in hist],
           "lr_per_step": [r["lr"] for r in hist], "step_s": [r["time_s"] for r in hist],
           "median_step_s_after_1": step_s, "tokens_per_s": tokens / step_s,
           "model_tflop_per_step": model_flops / 1e12,
           "model_tflop_s": model_flops / step_s / 1e12,
           "model_flops_share_of_989": model_flops / step_s / BF16_TENSOR_FLOPS_PER_S,
           "with_recompute_tflop_s": hw_flops / step_s / 1e12,
           "with_recompute_share_of_989": hw_flops / step_s / BF16_TENSOR_FLOPS_PER_S,
           "run_s": run_s, "max_memory_allocated_gb": peak_gb, "launches": launches,
           "launch_signatures": sorted(seen), "unchecked_signatures": unchecked,
           "checks": checks, "step_split_ms": split,
           "profile": {**device_summary(prof, profiled_s),
                       "by_kind": device_time_by_kind(prof)}}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"trainer ({L} layers): failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    del trainer, state, batch
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# DDL: data-parallel training, its ranks in processes of their own
# ---------------------------------------------------------------------------

def _ddl_config(layers: int, mesh, *, smoke: bool = False, batch: int = TRAIN_BATCH,
                seq: int = TRAIN_SEQ, **kw):
    """qwen2.5-14b at full width cut to `layers` (or its smoke config) on
    `mesh` (pod, data, model), LMS off, `batch` x `seq` tokens a step over
    all the ranks."""
    import dataclasses
    from repro_torch.config.base import LMSConfig, MeshSpec, ShapeConfig, TrainConfig
    from repro_torch.configs import get_config, get_smoke_config
    cfg = (get_smoke_config(ARCH) if smoke
           else dataclasses.replace(get_config(ARCH), num_layers=layers))
    return TrainConfig(model=cfg, shape=ShapeConfig("ddl", "train", seq, batch),
                       mesh=MeshSpec(tuple(mesh), DDL_AXES), lms=LMSConfig(enabled=False),
                       seed=SEED, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=DDL_STEPS, **kw)


def ddl_pod_hop_sizes(cfg, data_size: int, *, overlap: bool):
    """Elements of each call of the compressed pod hop in one train step,
    worked out from the leaf sizes: with the overlapped backward each
    layer's buckets (`make_buckets` at the default 64 MiB, padded to
    |data|, this rank's 1/|data| shard of each) and then the other leaves
    (embedding, head, final norm); without it every leaf; a leaf with no
    dimension divisible by |data| takes a plain psum. Each shard is cut into
    POD_SLICE-element slices, one call each."""
    import math
    from repro_torch.config.base import DDLConfig
    from repro_torch.core.ddl.allreduce import POD_SLICE, _choose_scatter_dim, make_buckets
    from repro_torch.core.ddl.overlap import _bucket_elems
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves
    defs = Model(cfg).param_defs()
    stacked = tree_leaves(defs["decoder"]["stack0"])
    rest = tree_leaves({k: v for k, v in defs.items() if k != "decoder"})
    shards = []

    def per_leaf(shape):
        if _choose_scatter_dim(shape, data_size) is not None:
            shards.append(math.prod(shape) // data_size)
    if overlap:
        sizes = [max(math.prod(d.shape[1:]), 1) for d in stacked]
        for _ in range(cfg.num_layers):
            for b in make_buckets(sizes, _bucket_elems(DDLConfig())):
                n = sum(sizes[i] for i in b)
                shards.append((n + (-n) % data_size) // data_size)
    else:
        for d in stacked:
            per_leaf(d.shape)
    for d in rest:
        per_leaf(d.shape)
    return [min(POD_SLICE, n - i) for n in shards for i in range(0, n, POD_SLICE)]


def ddl_ef_slices():
    """The pod-hop slices of the error-feedback path's leaf."""
    from repro_torch.core.ddl.allreduce import POD_SLICE
    return [min(POD_SLICE, DDL_EF_LEAF - i) for i in range(0, DDL_EF_LEAF, POD_SLICE)]


def _tuplify(x):
    return tuple(_tuplify(i) for i in x) if isinstance(x, list) else x


def _checksums(params) -> list:
    """Each leaf's bits summed with positional weights in int64 (wrapping):
    two replicas whose leaves are bitwise equal give equal sums, and a
    changed or moved element changes them."""
    import torch
    from repro_torch.tree import tree_leaves
    out = []
    for t in tree_leaves(params):
        flat = t.detach().reshape(-1).view(torch.int32 if t.element_size() == 4 else torch.int16)
        acc = torch.zeros((), dtype=torch.int64, device=t.device)
        for i in range(0, flat.numel(), 1 << 24):
            part = flat[i:i + (1 << 24)].long()
            acc += (part * torch.arange(i + 1, i + 1 + part.numel(), device=t.device)).sum()
        out.append(int(acc))
    return out


def _same_on_all_ranks(obj) -> bool:
    import torch.distributed as dist
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    return all(g == got[0] for g in got)


def _rank_main(rank: int, world: int, tmp: str, name: str, args):
    """A spawned rank: join the gloo group through a FileStore in `tmp`,
    run the function `name`, write its JSON result to tmp/rank<r>.json."""
    import datetime
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=DDL_TIMEOUT_S))
    try:
        out = globals()[name](rank, world, *args)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(name: str, world: int, *args, timeout: float = DDL_TIMEOUT_S):
    """Run the function `name`(rank, world, *args) in `world` processes
    started with the spawn method, all on the one card, joined over gloo;
    -> each rank's result. A failed rank stops the others and raises; so
    does the timeout, after killing them."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ddl_")
    try:
        ctx = mp.start_processes(_rank_main, args=(world, tmp, name, args), nprocs=world,
                                 start_method="spawn", join=False)
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"{name}: {world} ranks did not finish in {timeout} s")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def _plain_quantizers():
    """The quantize, dequantize and pod-sum dispatchers the pod hop calls
    swapped for their plain versions."""
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.kernels.quantize.ref import (dequantize_ref, dequantize_sum_rows_ref,
                                                  quantize_ref)
    saved = q_ops.quantize, q_ops.dequantize, q_ops.dequantize_sum_rows
    q_ops.quantize, q_ops.dequantize, q_ops.dequantize_sum_rows = (
        quantize_ref, dequantize_ref, dequantize_sum_rows_ref)
    try:
        yield
    finally:
        q_ops.quantize, q_ops.dequantize, q_ops.dequantize_sum_rows = saved


def _ddl_full_rank(rank: int, world: int):
    """One rank of the full-width DDL phase: `Trainer.train` on the 2x1x1
    mesh with compress_dcn and the overlapped backward. Every compressed
    pod-hop call counts the bytes this rank sends (int8 codes and f32
    scales, against 4 B an element uncompressed); on step 1 each call is
    also run through the plain quantizers (bitwise equal required) and
    uncompressed (the int8 result within the sum over pods of each row's
    scale / 2 of the exact f32 sum). The reductions are timed by CUDA
    events; after each step the params' checksums are compared across the
    ranks and the step's kernel launches read and reset."""
    import importlib
    import torch
    from repro_torch.config.base import DDLConfig
    from repro_torch.core.ddl import allreduce, overlap
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.kernels.quantize.ref import quantize_ref
    from repro_torch.train import steps as steps_mod
    from repro_torch.train.trainer import Trainer
    comp = importlib.import_module("repro_torch.core.ddl.compress")
    tcfg = _ddl_config(DDL_LAYERS, DDL_MESH, ddl=DDLConfig(compress_dcn=True), log_every=1)
    trainer = Trainer(tcfg, device="cuda")
    box, in_sync = {}, []
    init = trainer.init_state

    def init_state():
        st = init()
        box["params"] = st.params
        in_sync.append(_same_on_all_ranks(_checksums(st.params)))
        return st
    trainer.init_state = init_state

    hop = allreduce.compressed_allreduce_pod
    stats = {"calls": 0, "int8_bytes": 0, "f32_bytes": 0, "kernel_eq_plain": True,
             "worst_err_over_bound": 0.0, "max_abs_err": 0.0, "checked_calls": 0}
    check = [True]

    def hop_checked(x, axis, *, mesh, error_feedback=None):
        out, ef = hop(x, axis, mesh=mesh, error_feedback=error_feedback)
        rows = -(-x.numel() // 1024)
        stats["calls"] += 1
        stats["int8_bytes"] += rows * 1024 + rows * 4
        stats["f32_bytes"] += x.numel() * 4
        if check[0]:
            with _plain_quantizers():
                plain, _ = hop(x, axis, mesh=mesh, error_feedback=error_feedback)
            stats["kernel_eq_plain"] &= torch.equal(out.view(torch.int32),
                                                    plain.view(torch.int32))
            exact = mesh.psum(x.float(), axis)
            _, sc = quantize_ref(comp._to_rows(x)[0])
            pods = mesh.size(axis)
            half = mesh.all_gather(sc, axis).view(pods, -1).sum(0) / 2
            bound = half.repeat_interleave(1024)[:x.numel()] * (1 + 2.0 ** -10)
            err = (out.float() - exact).abs()
            stats["worst_err_over_bound"] = max(stats["worst_err_over_bound"],
                                                float((err / bound).max()))
            stats["max_abs_err"] = max(stats["max_abs_err"], float(err.max()))
            stats["checked_calls"] += 1
        return out, ef
    allreduce.compressed_allreduce_pod = hop_checked

    spans = []

    def timed(fn):
        def run(*a, **k):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            r = fn(*a, **k)
            e1.record()
            spans.append((e0, e1))
            return r
        return run
    overlap.reduce_tree_bucketed = timed(overlap.reduce_tree_bucketed)
    steps_mod.ddl_reduce_tree = timed(steps_mod.ddl_reduce_tree)
    step_events = []
    step_fn = trainer.step_fn

    def step_timed(state, batch):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = step_fn(state, batch)
        e1.record()
        step_events.append((e0, e1))
        return out
    trainer.step_fn = step_timed

    steps = []

    def on_step(step, row):
        torch.cuda.synchronize()
        e0, e1 = step_events[-1]
        reduce_ms = sum(a.elapsed_time(b) for a, b in spans)
        spans.clear()
        steps.append({"step": step, "loss": row["loss"], "grad_norm": row["grad_norm"],
                      "time_s": row["time_s"], "step_ms": e0.elapsed_time(e1),
                      "reduce_ms": reduce_ms,
                      "quantize_launches": q_ops.quantize_cuda.launches,
                      "dequantize_launches": q_ops.dequantize_cuda.launches,
                      "dequantize_sum_launches": q_ops.dequantize_sum_rows_cuda.launches,
                      "pod_hop_calls": stats["calls"]})
        q_ops.quantize_cuda.launches = q_ops.dequantize_cuda.launches = 0
        q_ops.dequantize_sum_rows_cuda.launches = 0
        stats["calls"] = 0
        in_sync.append(_same_on_all_ranks(_checksums(box["params"])))
        check[0] = False

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with launch_signatures() as (seen, _, _):
        trainer.train(DDL_STEPS, on_step=on_step)
    wall = time.monotonic() - t0
    same_losses = _same_on_all_ranks([(r["loss"], r["grad_norm"]) for r in steps])
    allreduce.compressed_allreduce_pod = hop
    ef_row, ef_seen = _ddl_error_feedback(trainer.mesh, rank)
    return {"rank": rank, "steps": steps, "in_sync": in_sync, "same_losses": same_losses,
            "pod_hop": {k: v for k, v in stats.items() if k != "calls"},
            "error_feedback": ef_row,
            "signatures": sorted(seen | ef_seen), "seconds": wall,
            "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "card_free_gb": torch.cuda.mem_get_info()[0] / 1e9}


def _ddl_error_feedback(mesh, rank: int):
    """Error feedback's path on a rank of the 2x1x1 mesh: one leaf of
    DDL_EF_LEAF elements reduced by `ddl_reduce_leaf` with compress_dcn and
    a nonzero EF buffer, launch counts reset just before and read just
    after (the local dequantize once a slice beside the pod sum), then
    again through the plain quantizers: the mean and the new EF bitwise
    equal. -> (row, signatures seen)."""
    import torch
    from repro_torch.core.ddl.allreduce import ddl_reduce_leaf
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7 + rank)
    g = torch.randn(DDL_EF_LEAF, generator=gen, device="cuda")
    ef = torch.randn(DDL_EF_LEAF, generator=gen, device="cuda") * 1e-2
    kw = dict(mesh=mesh, data_axis="data", pod_axis="pod", data_size=mesh.size("data"),
              pod_size=mesh.size("pod"), compress_dcn=True, topology_aware=True)
    with launch_signatures() as (seen, calls, launches):
        out, new_ef = ddl_reduce_leaf(g.clone(), error_feedback=ef.clone(), **kw)
    with _plain_quantizers():
        want, want_ef = ddl_reduce_leaf(g.clone(), error_feedback=ef.clone(), **kw)
    bitwise = (torch.equal(out.view(torch.int32), want.view(torch.int32))
               and torch.equal(new_ef.view(torch.int32), want_ef.view(torch.int32)))
    row = {"leaf": DDL_EF_LEAF, "slices": len(ddl_ef_slices()), "bitwise_vs_plain": bitwise,
           "every_launch_recorded": calls == launches,
           "launches": {k: launches[k] for k in ("quantize_rows", "dequantize_rows",
                                                 "dequantize_sum_rows", "dequantize_rows_vector")}}
    return row, seen


def _ddl_smoke_rank(rank: int, world: int):
    """One rank of the smoke-width DDL phase on the 2x2x1 mesh: the train
    step with the overlapped backward off and on, compression off and on,
    3 steps each from one init, on this rank's rows of the global batch;
    each step's loss and grad norm, and whether the params' checksums agree
    across all ranks after each step."""
    import dataclasses
    import torch
    from repro_torch.config.base import DDLConfig
    from repro_torch.data import local_rows
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.train.steps import build_train_step, init_train_state
    tcfg0 = _ddl_config(0, DDL_SMOKE_MESH, smoke=True, batch=DDL_SMOKE_BATCH,
                        seq=DDL_SMOKE_SEQ)
    mesh = make_mesh(tcfg0.mesh)
    out = {}
    for ov in (False, True):
        for c in (False, True):
            tcfg = dataclasses.replace(tcfg0, ddl=DDLConfig(compress_dcn=c, overlap_grads=ov))
            model = Model(tcfg.model)
            step = build_train_step(model, tcfg, mesh=mesh)
            state = init_train_state(model, tcfg, SEED, "cuda")
            rows, in_sync = [], [_same_on_all_ranks(_checksums(state.params))]
            with launch_signatures() as (seen, _, launches):
                for b in _ddl_batches(tcfg):
                    local = local_rows(b, mesh.dp_index, mesh.dp_size)
                    state, met = step(state, {k: torch.from_numpy(v).cuda()
                                              for k, v in local.items()})
                    rows.append({"loss": float(met["loss"]),
                                 "grad_norm": float(met["grad_norm"])})
                    in_sync.append(_same_on_all_ranks(_checksums(state.params)))
            out[f"overlap={ov},compress={c}"] = {
                "rows": rows, "in_sync": in_sync, "signatures": sorted(seen),
                "quantize_launches": launches["quantize_rows"],
                "dequantize_launches": launches["dequantize_rows"],
                "dequantize_sum_launches": launches["dequantize_sum_rows"]}
    return out


def _ddl_batches(tcfg):
    """The global batches of DDL_STEPS steps of the synthetic stream."""
    from repro_torch.data import DataLoader, SyntheticTokens
    loader = DataLoader(SyntheticTokens(tcfg.model.vocab_size, seed=tcfg.seed), shard=0,
                        num_shards=1, batch_per_shard=tcfg.shape.global_batch,
                        seq_len=tcfg.shape.seq_len)
    return [next(loader) for _ in range(DDL_STEPS)]


def ddl_phase(line, checked):
    """The main path of data-parallel training at qwen2.5-14b's full width,
    cut to 1 layer: `Trainer.train` for 3 steps on 2 ranks (a 2x1x1 mesh:
    2 pods of 1 data rank) with compress_dcn and the overlapped backward,
    2048 tokens a rank a step. The ranks share the one card and talk over
    gloo, staged through host memory, so the times are those of two ranks
    time-slicing one card, not DDL's speed across cards.

    Memory: 1 layer is 1.833 B params (embedding and head 778.6 M each, the
    layer 275.3 M); with the f32 embedding, bf16 weights, their grads and
    AdamW's f32 moments and master copy that is ~32.4 GB a rank, ~65 GB for
    two, and the reduction works on 2**24-element slices of a leaf.

    Held: (a) every param leaf's checksum equal across the ranks at init
    and after every step; (b) on step 1, every pod-hop call through the
    kernels bitwise equal to the same call through the plain quantizers;
    (c) the int8 sum within the sum over pods of scale/2 of each 1024-row
    of the exact f32 sum; (d) each step's launches: quantize and the pod
    sum once for each compressed slice, worked out from the leaf sizes and
    buckets, and no dequantize; (e) finite losses, equal on both ranks;
    (f) error feedback's path after the steps (`_ddl_error_feedback`): its
    launches, and its mean and EF bitwise through the kernels and through
    the plain versions; and every launch at a shape the kernel phases
    checked. -> the phase row."""
    import torch
    tcfg = _ddl_config(DDL_LAYERS, DDL_MESH)
    pods = DDL_MESH[0]
    slices = len(ddl_pod_hop_sizes(tcfg.model, DDL_MESH[1], overlap=True))
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    ranks = spawn_ranks("_ddl_full_rank", pods)
    r0 = ranks[0]
    unchecked = {_tuplify(sig) for r in ranks for sig in r["signatures"]} - checked
    checks = {
        "replicas_in_sync": all(all(r["in_sync"]) and len(r["in_sync"]) == DDL_STEPS + 1
                                for r in ranks),
        "kernels_eq_plain_bitwise": all(r["pod_hop"]["kernel_eq_plain"]
                                        and r["pod_hop"]["checked_calls"] == slices
                                        for r in ranks),
        "within_int8_bound": all(r["pod_hop"]["worst_err_over_bound"] <= 1.0 for r in ranks),
        # a step: quantize and the pod sum once a slice, no dequantize (no EF)
        "launches": all(s["quantize_launches"] == slices
                        and s["dequantize_sum_launches"] == slices
                        and s["dequantize_launches"] == 0
                        and s["pod_hop_calls"] == slices for r in ranks for s in r["steps"]),
        # error feedback's path: the local dequantize once a slice, on the vector path
        "error_feedback": all(
            r["error_feedback"]["bitwise_vs_plain"] and r["error_feedback"]["every_launch_recorded"]
            and r["error_feedback"]["launches"] == {
                "quantize_rows": len(ddl_ef_slices()), "dequantize_rows": len(ddl_ef_slices()),
                "dequantize_sum_rows": len(ddl_ef_slices()),
                "dequantize_rows_vector": len(ddl_ef_slices())} for r in ranks),
        "finite_equal_losses": all(r["same_losses"] for r in ranks) and all(
            math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]) for s in r0["steps"]),
        "shapes_checked": not unchecked}
    steady = r0["steps"][1:]
    row = {"phase": "ddl_full_width", "arch": ARCH, "layers": DDL_LAYERS,
           "mesh": list(DDL_MESH), "ranks": pods, "backend": "gloo (host-staged)",
           "compress_dcn": True, "overlap_grads": True,
           "tokens_per_rank": TRAIN_BATCH * TRAIN_SEQ // pods, "card": line,
           "note": "two ranks time-slice one card over gloo through host memory: "
                   "not DDL's speed across cards",
           "steps": r0["steps"], "expected_slices_per_step": slices,
           "error_feedback": r0["error_feedback"],
           "step_ms_steady": sum(s["step_ms"] for s in steady) / len(steady),
           "reduce_ms_steady": sum(s["reduce_ms"] for s in steady) / len(steady),
           "reduce_share_steady": (sum(s["reduce_ms"] for s in steady)
                                   / sum(s["step_ms"] for s in steady)),
           "pod_hop_bytes_per_step": r0["pod_hop"]["int8_bytes"] / DDL_STEPS,
           "pod_hop_f32_bytes_per_step": r0["pod_hop"]["f32_bytes"] / DDL_STEPS,
           "pod_hop_worst_err_over_bound": max(r["pod_hop"]["worst_err_over_bound"]
                                               for r in ranks),
           "pod_hop_max_abs_err": max(r["pod_hop"]["max_abs_err"] for r in ranks),
           "peak_allocated_gb": [r["peak_allocated_gb"] for r in ranks],
           "card_free_gb_at_end": [r["card_free_gb"] for r in ranks],
           "rank_seconds": [r["seconds"] for r in ranks],
           "seconds": time.monotonic() - t0, "checks": checks,
           "unchecked_shapes": sorted(map(str, unchecked))}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"ddl (full width): failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def ddl_smoke_phase(line, checked):
    """The hierarchical schedule with |data| = 2 on the card: 4 ranks on a
    2x2x1 mesh at the qwen2.5-14b smoke config (the one part at reduced
    width: 4 full-width replicas do not fit one card), the overlapped
    backward off and on x compression off and on, 3 steps each, each held
    against one rank (the train step on a 1-device mesh) on the global
    batch from the same init. Tolerance, stated before the first run: the
    ranks' bf16 GEMMs have a quarter of the rows, so cuBLAS may sum in
    another order, and the int8 pod hop rounds each grad element by up to
    half its row's scale: loss within 5e-3 relative, grad norm within
    2e-2. Replicas stay bitwise in sync; compressed runs launch quantize
    and the pod sum as the leaf sizes say, and no dequantize. -> the phase
    row."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.train.steps import build_train_step, init_train_state
    tcfg = _ddl_config(0, (1, 1, 1), smoke=True, batch=DDL_SMOKE_BATCH, seq=DDL_SMOKE_SEQ)
    model = Model(tcfg.model)
    step = build_train_step(model, tcfg)
    state = init_train_state(model, tcfg, SEED, "cuda")
    reference = []
    for b in _ddl_batches(tcfg):
        state, met = step(state, {k: torch.from_numpy(v).cuda() for k, v in b.items()})
        reference.append({"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"])})
    del state
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    ranks = spawn_ranks("_ddl_smoke_rank", 4)
    data = DDL_SMOKE_MESH[1]
    variants, checks, unchecked = {}, {}, set()
    for name, v in ranks[0].items():
        ov, c = "overlap=True" in name, "compress=True" in name
        slices = len(ddl_pod_hop_sizes(tcfg.model, data, overlap=ov)) * DDL_STEPS if c else 0
        err = [{k: abs(row[k] - ref[k]) / abs(ref[k]) for k in ("loss", "grad_norm")}
               for row, ref in zip(v["rows"], reference)]
        unchecked |= {_tuplify(sig) for r in ranks for sig in r[name]["signatures"]} - checked
        checks[name] = {
            "in_sync": all(all(r[name]["in_sync"]) for r in ranks),
            "same_metrics": all(r[name]["rows"] == v["rows"] for r in ranks),
            "loss": max(e["loss"] for e in err) <= 5e-3,
            "grad_norm": max(e["grad_norm"] for e in err) <= 2e-2,
            "launches": all(r[name]["quantize_launches"] == slices
                            and r[name]["dequantize_sum_launches"] == slices
                            and r[name]["dequantize_launches"] == 0 for r in ranks)}
        variants[name] = {"rows": v["rows"], "rel_err": err,
                          "quantize_launches": v["quantize_launches"],
                          "dequantize_launches": v["dequantize_launches"],
                          "dequantize_sum_launches": v["dequantize_sum_launches"]}
    ok = all(all(c.values()) for c in checks.values()) and not unchecked
    emit({"phase": "ddl_smoke_width", "arch": ARCH, "config": "smoke",
          "mesh": list(DDL_SMOKE_MESH), "ranks": 4, "backend": "gloo (host-staged)",
          "batch": DDL_SMOKE_BATCH, "seq": DDL_SMOKE_SEQ, "card": line,
          "reference": reference, "variants": variants, "checks": checks,
          "unchecked_shapes": sorted(map(str, unchecked)),
          "seconds": time.monotonic() - t0})
    if not ok:
        raise AssertionError("ddl (smoke width, 4 ranks): failed checks")



# ---------------------------------------------------------------------------
# LMS: training beyond the card's memory on one card
# ---------------------------------------------------------------------------

def _meminfo() -> dict:
    """/proc/meminfo in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for row in f:
            key, val = row.split(":", 1)
            parts = val.split()
            out[key] = int(parts[0]) * (1024 if parts[1:] == ["kB"] else 1)
    return out


MEMINFO_KEYS = ("MemTotal", "MemFree", "MemAvailable", "Cached", "Shmem", "AnonPages",
                "Mlocked", "Unevictable")


def _mem_row() -> dict:
    """The /proc/meminfo fields of MEMINFO_KEYS, in bytes."""
    mem = _meminfo()
    return {k: mem.get(k) for k in MEMINFO_KEYS}


def host_phase(line):
    """The host: MemTotal and MemAvailable, and the achieved pinned copy
    rate between host and card, HOST_COPY_BYTES each way, host to device,
    device to host, and both at once (each on a stream of its own), timed
    with CUDA events, the median of HOST_COPY_REPS: the link rate swap
    time is held against (`hw.host_bw`, 64 GB/s a direction, is a data
    sheet's figure). -> the phase row."""
    import ctypes
    import gc
    import statistics
    import torch
    # what the earlier phases freed, handed back first: Python's cycles,
    # the card's cached blocks, and the C heap's free pages (glibc keeps
    # freed blocks under its mmap threshold in the heap until trimmed)
    anon_before = _meminfo().get("AnonPages")
    gc.collect()
    torch.cuda.empty_cache()
    ctypes.CDLL("libc.so.6").malloc_trim(0)
    mem = _meminfo()
    n = HOST_COPY_BYTES
    host = [torch.empty(n, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
    dev = [torch.empty(n, dtype=torch.uint8, device="cuda") for _ in range(2)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]

    def timed(copies):
        """Seconds from a start event all streams wait on to the last end."""
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        ends = []
        for stream, fn in zip(streams, copies):
            stream.wait_event(start)
            with torch.cuda.stream(stream):
                fn()
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                ends.append(end)
        torch.cuda.synchronize()
        return max(start.elapsed_time(e) for e in ends) / 1e3

    def h2d():
        dev[0].copy_(host[0], non_blocking=True)

    def d2h():
        host[1].copy_(dev[1], non_blocking=True)
    rates = {}
    for name, copies, nbytes in (("h2d", [h2d], n), ("d2h", [d2h], n),
                                 ("both", [h2d, d2h], 2 * n)):
        timed(copies)
        secs = [timed(copies) for _ in range(HOST_COPY_REPS)]
        rates[name] = {"bytes": nbytes, "seconds": secs,
                       "gb_s": nbytes / statistics.median(secs) / 1e9}
    row = {"phase": "host", "card": line, "meminfo": {k: mem.get(k) for k in MEMINFO_KEYS},
           "anon_pages_before_trim": anon_before,
           "mem_total_bytes": mem["MemTotal"],
           "mem_available_bytes": mem["MemAvailable"], "copy_bytes": n,
           "h2d_gb_s": rates["h2d"]["gb_s"], "d2h_gb_s": rates["d2h"]["gb_s"],
           "both_gb_s": rates["both"]["gb_s"], "rates": rates,
           "hw_host_bw_gb_s": 64.0}
    emit(row)
    del host, dev
    return row


def _swap_per_step(before: dict, after: dict, steps: int) -> dict:
    """{counter: (after - before) / steps} of the `lms.swap_*` counters."""
    return {k: (v - before.get(k, 0)) / steps for k, v in sorted(after.items())}


def _implied_rmsnorm_launches(plan, layers: int) -> int:
    """RMSNorm launches a step the plan's assignment implies: 2L+1 in the
    forward (two a layer and the final norm), and in the backward's replay
    one a layer for each of attn_norm and mlp_norm the plan rematerializes
    (a saved or offloaded norm output is not recomputed); 4L+1 without a
    plan (every layer recomputed whole)."""
    if plan is None:
        return 4 * layers + 1
    remat = sum(plan.assignment.get(n, "remat") == "remat" for n in ("attn_norm", "mlp_norm"))
    return 2 * layers + 1 + remat * layers


def _lms_run(tcfg, steps: int, profile=None):
    """A `Trainer` on the card for `steps` steps from its seed, the state
    set up (placed as its plan says) and timed first; counts reset just
    before the steps and read just after. -> (trainer, final state,
    history, facts)."""
    import torch
    from repro_torch.core.lms import offload as off
    from repro_torch.train.trainer import Trainer
    trainer = Trainer(tcfg, device="cuda", profile=profile)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    state = trainer.init_state()
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    init = [state]
    trainer.init_state = lambda: init.pop()
    before = off.swap_counters()
    t1 = time.monotonic()
    with launch_signatures() as (seen, calls, launches):
        state, hist = trainer.train(steps=steps)
    run_s = time.monotonic() - t1
    facts = {"setup_s": setup_s, "run_s": run_s, "peak_bytes": torch.cuda.max_memory_allocated(),
             "pinned_bytes": off.pinned_bytes(),
             "swap_per_step": _swap_per_step(before, off.swap_counters(), steps),
             "seen": seen, "calls": calls, "launches": launches}
    return trainer, state, hist, facts


def _plan_row(plan) -> dict:
    if plan is None:
        return None
    return {"peak_bytes": plan.peak_bytes, "budget": plan.budget, "fits": plan.fits,
            "host_bytes": plan.host_bytes, "swap_bytes_per_step": plan.swap_bytes_per_step,
            "swap_bytes": dict(plan.swap_schedule.swap_bytes) if plan.swap_schedule else {},
            "residency": plan.residency, "assignment": plan.assignment,
            "prefetch_depth": plan.swap_schedule.prefetch_depth if plan.swap_schedule else None,
            "summary": plan.summary()}


def lms_ab_phase(line, checked):
    """LMS against resident at qwen2.5-14b's full width cut to
    LMS_AB_LAYERS layers, 2 x 2048 tokens a step, LMS_STEPS steps of
    `Trainer.train` from one seed: first under the plan of
    LMSConfig(hbm_budget=LMS_AB_BUDGET) (params and optimizer state in
    pinned host memory, streamed; resid, attn_norm, qkv, attn_out and
    mlp_norm offloaded, mlp_hidden recomputed), then resident
    (LMSConfig(enabled=False)). Held: every step's loss and grad norm and
    every param after the last step bitwise equal; finite losses; the
    RMSNorm launches a step the plan's assignment implies
    (`_implied_rmsnorm_launches`) and none of another kernel. Reported:
    both step times (median after step 1) and their ratio, LMS's overhead
    at this size; the swap counters a step by class against the plan's
    `swap_schedule.swap_bytes`; the measured peak against the plan's.
    -> the phase row."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.config.base import LMSConfig
    from repro_torch.core.lms import offload as off
    from repro_torch.tree import tree_leaves
    L, n = LMS_AB_LAYERS, LMS_STEPS
    base = _train_config(L, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=n)
    runs, params = {}, {}
    for name, lms in (("streamed", LMSConfig(hbm_budget=LMS_AB_BUDGET)),
                      ("resident", LMSConfig(enabled=False))):
        trainer, state, hist, facts = _lms_run(dataclasses.replace(base, lms=lms), n)
        plan = trainer.plan
        # kept where they lie (the stack in pinned host memory, the rest on
        # the card) and compared leaf by leaf on the card
        params[name] = tree_leaves(state.params)
        unchecked = sorted(facts["seen"] - checked)
        launches = facts["launches"]
        runs[name] = {
            "plan": _plan_row(plan), "loss": [r["loss"] for r in hist],
            "grad_norm": [r["grad_norm"] for r in hist], "step_s": [r["time_s"] for r in hist],
            "median_step_s_after_1": statistics.median(r["time_s"] for r in hist[1:]),
            "setup_s": facts["setup_s"], "max_memory_allocated_bytes": facts["peak_bytes"],
            "pinned_bytes": facts["pinned_bytes"], "swap_per_step": facts["swap_per_step"],
            "rmsnorm_launches_per_step": launches["rmsnorm"] / n,
            "implied_rmsnorm_launches_per_step": _implied_rmsnorm_launches(plan, L),
            "launches": launches, "unchecked_signatures": unchecked,
            "checks": {"finite": all(math.isfinite(r["loss"]) for r in hist),
                       "rmsnorm_launches_as_the_plan_implies":
                           launches["rmsnorm"] == n * _implied_rmsnorm_launches(plan, L),
                       "no_other_launches": all(v == 0 for k, v in launches.items()
                                                if not k.startswith("rmsnorm")),
                       "every_launch_recorded": facts["calls"] == launches,
                       "every_launch_shape_checked": not unchecked}}
        del trainer, state, hist
        torch.cuda.empty_cache()
    s, r = runs["streamed"], runs["resident"]
    same_params = [torch.equal(a.to(b.device), b)
                   for a, b in zip(params["streamed"], params["resident"])]
    del params
    off.release_arenas()
    swap = s["swap_per_step"]
    plan = s["plan"]
    checks = {**{f"streamed_{k}": v for k, v in s["checks"].items()},
              **{f"resident_{k}": v for k, v in r["checks"].items()},
              "plan_streams_params_and_optimizer":
                  set(plan["swap_bytes"]) == {"params", "optimizer"},
              "loss_bitwise": s["loss"] == r["loss"],
              "grad_norm_bitwise": s["grad_norm"] == r["grad_norm"],
              "params_bitwise": all(same_params)}
    row = {"phase": "lms_ab", "arch": ARCH, "layers": L, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": n, "card": line, "hbm_budget": LMS_AB_BUDGET,
           "streamed": s, "resident": r,
           "overhead": s["median_step_s_after_1"] / r["median_step_s_after_1"] - 1,
           "params_unequal": [i for i, ok in enumerate(same_params) if not ok],
           "swap_vs_plan": {
               "params_in_per_step": swap.get("lms.swap_in_bytes.params", 0),
               "params_out_per_step": swap.get("lms.swap_out_bytes.params", 0),
               "params_priced": plan["swap_bytes"].get("params"),
               "optimizer_in_out_per_step": swap.get("lms.swap_in_bytes.optimizer", 0)
               + swap.get("lms.swap_out_bytes.optimizer", 0),
               "optimizer_priced": plan["swap_bytes"].get("optimizer"),
               "activations_in_out_per_step": swap.get("lms.swap_in_bytes.activations", 0)
               + swap.get("lms.swap_out_bytes.activations", 0)},
           "peak_vs_plan": {"measured": s["max_memory_allocated_bytes"],
                            "plan": plan["peak_bytes"],
                            "delta": s["max_memory_allocated_bytes"] - plan["peak_bytes"]},
           "checks": checks}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"lms_ab: failed checks {[k for k, v in checks.items() if not v]}")
    return row


def copy_seconds(prof) -> dict:
    """Device seconds of a torch.profiler run's host-device copies by
    direction, and the busy time of the copies and of everything else
    (kernels, fills): {h2d_s, d2h_s, copy_busy_s, compute_busy_s,
    overlap_s}, the last the time both ran at once."""
    from torch.autograd import DeviceType
    out = {"h2d_s": 0.0, "d2h_s": 0.0}
    copies, compute = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        name, start, dur = ev.name(), ev.start_ns(), ev.duration_ns()
        if "HtoD" in name or "DtoH" in name:
            out["h2d_s" if "HtoD" in name else "d2h_s"] += dur / 1e9
            copies.append((start, start + dur))
        else:
            compute.append((start, start + dur))
    out["copy_busy_s"] = busy_seconds(copies)
    out["compute_busy_s"] = busy_seconds(compute)
    out["overlap_s"] = (out["copy_busy_s"] + out["compute_busy_s"]
                        - busy_seconds(copies + compute))
    return out


def _pinned_state_bytes(layers: int) -> int:
    """Pinned host bytes of qwen2.5-14b's train state at `layers` layers
    when the plan puts the stack's params and the AdamW state on the host
    (the port's layout rule, `train.steps._state_layout`)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.layers import DTYPES
    from repro_torch.models.model import Model
    from repro_torch.train import steps as steps_mod
    model = Model(dataclasses.replace(get_config(ARCH), num_layers=layers))
    paths = [(path, d.shape, DTYPES[d.dtype])
             for path, d in steps_mod._def_paths(model.param_defs())]
    return steps_mod._state_layout(paths, "adamw", True, True)[0]


def _grad_bytes(layers: int) -> int:
    """Bytes of the grads (the params' dtypes, on the card)."""
    import dataclasses
    import math as m
    from repro_torch.configs import get_config
    from repro_torch.models.layers import DTYPES
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves
    model = Model(dataclasses.replace(get_config(ARCH), num_layers=layers))
    return sum(m.prod(d.shape) * DTYPES[d.dtype].itemsize
               for d in tree_leaves(model.param_defs()))


def _layerwise_loss(model, state, batch):
    """The loss of `batch` under `state`'s params without the executor: a
    no-grad forward that copies one layer at a time from pinned host memory
    to the card and calls `apply_layer`, then the final norm, the head and
    the cross-entropy, as `Model.loss` composes them."""
    import torch
    from repro_torch.models import transformer as tr
    from repro_torch.models.layers import (apply_norm, cross_entropy, embed_tokens,
                                           lm_logits)
    from repro_torch.tree import tree_map
    cfg = model.cfg
    params = state.params
    with torch.no_grad():
        x = embed_tokens(cfg, params["embed"], batch["tokens"])
        ctx = model._ctx(x.shape[1], x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.num_layers):
            layer = tree_map(lambda t: t.to("cuda"), tr._layer(params["decoder"]["stack0"], i))
            x, da = tr.apply_layer(cfg, "attn", layer["attn_0"], x, ctx)
            aux = aux + da
        x = apply_norm(cfg, params["final_norm"], x)
        ce = cross_entropy(lm_logits(cfg, params["embed"], x), batch["labels"])
        return ce + 0.01 * aux


def gate_layers(host_row) -> int:
    """The gate's depth: the most layers L <= 48 whose pinned state fits
    LMS_HOST_SHARE of MemAvailable as the host phase read it. Fails, naming
    the host's memory, unless that state plus the grads exceeds the card's
    80 GB."""
    avail, total = host_row["mem_available_bytes"], host_row["mem_total_bytes"]
    fit = [L for L in range(1, 49) if _pinned_state_bytes(L) <= LMS_HOST_SHARE * avail]
    if not fit:
        raise AssertionError(f"lms_gate: the host's MemAvailable {avail} B (MemTotal "
                             f"{total} B) holds no layer's pinned state")
    L = max(fit)
    pinned, grads = _pinned_state_bytes(L), _grad_bytes(L)
    if pinned + grads <= CARD_BYTES:
        raise AssertionError(
            f"lms_gate: the host's MemAvailable {avail} B (MemTotal {total} B) holds the "
            f"pinned state of {L} layers ({pinned} B), which with the grads ({grads} B) "
            f"does not exceed the card's {CARD_BYTES} B")
    return L


def lms_gate_phase(line, checked, host_row, ab_row, L):
    """The paper's case: qwen2.5-14b at full width with the most layers
    L <= 48 whose pinned state (bf16 stack params, f32 AdamW mu, nu and
    master) fits LMS_HOST_SHARE of MemAvailable, trained LMS_STEPS steps of
    2 x 2048 tokens by `Trainer` under an LMS plan. It fails, naming the
    host's memory, unless that state plus the grads exceeds the card's 80
    GB: the run must be training beyond the card's capacity.

    The budget, by the planner's own means: the audited live-bytes margin
    m = lms_ab's measured peak - its plan's peak + LMS_MARGIN_ALLOWANCE
    (what the executor holds beyond the plan's pricing), fed as the plan's
    profile (`CostModel.from_reports(None, {"steps": [{"name": "train",
    "plan_delta_bytes": m}]})`), which tightens the budget by m and charges
    m into the plan's peak. hbm_budget is the card's unless the params
    would not stream there (params + grads under half the budget): then
    the largest budget under which they stream. No retry on out of memory.

    Held: finite losses; step 1's loss bitwise equal to the phase's own
    no-grad forward (`_layerwise_loss`), independent of the executor; the
    RMSNorm launches the plan implies. Reported: step time (median after
    step 1), tokens/s, model FLOP/s and its share of 989 TFLOP/s, the
    measured peak against the plan's, the pinned bytes against
    `plan.host_bytes`, the host-to-device and device-to-host bytes a step
    from the counters against `plan.swap_bytes_per_step`, the link rate
    they give over the step against the host phase's, and the state's set
    up time. -> the phase row."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.config.base import LMSConfig
    from repro_torch.core.lms import offload as off
    from repro_torch.core.lms.costmodel import CostModel
    from repro_torch.core.lms.planner import PlanRequest, plan as plan_lms
    from repro_torch.data import DataLoader, SyntheticTokens
    from repro_torch.models.model import Model
    n = LMS_STEPS
    pinned, grads = _pinned_state_bytes(L), _grad_bytes(L)
    margin = int(ab_row["peak_vs_plan"]["delta"]) + LMS_MARGIN_ALLOWANCE
    profile = CostModel.from_reports(None, {"steps": [{"name": "train",
                                                       "plan_delta_bytes": margin}]})
    base = _train_config(L, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=n)

    def plan_at(budget):
        lms = LMSConfig(hbm_budget=budget)
        return lms, plan_lms(PlanRequest(cfg=base.model, shape=base.shape, mesh=base.mesh,
                                         lms=lms, optimizer=base.optimizer), profile=profile)
    lms, plan = plan_at(0)
    budget_why = "the card's: the params stream there"
    if plan.swap_schedule is None or not plan.swap_schedule.streams_params:
        n_params = base.model.param_count()
        # params stream iff 2 N + 2 N > (budget (1 - workspace) - m) / 2
        budget = int(0.99 * (2 * 4 * n_params + max(margin, 0)) / (1 - lms.workspace_frac))
        budget_why = (f"lowered from the card's: at {L} layers params + grads "
                      f"({4 * n_params} B priced) stay under half the budget, so the plan "
                      f"keeps params resident; at {budget} B they stream")
        lms, plan = plan_at(budget)
    derivation = {"lms_ab_measured_peak": ab_row["peak_vs_plan"]["measured"],
                  "lms_ab_plan_peak": ab_row["peak_vs_plan"]["plan"],
                  "allowance": LMS_MARGIN_ALLOWANCE, "margin": margin,
                  "hbm_budget": lms.hbm_budget, "why": budget_why}
    emit({"phase": "lms_gate_plan", "layers": L,
          "mem_available_bytes": host_row["mem_available_bytes"],
          "mem_total_bytes": host_row["mem_total_bytes"], "meminfo_now": _mem_row(),
          "host_share": LMS_HOST_SHARE, "pinned_state_bytes": pinned,
          "grad_bytes": grads, "budget_derivation": derivation, "plan": _plan_row(plan)})
    if not plan.swap_schedule.streams_params:
        raise AssertionError("lms_gate: the plan does not stream the params")
    tcfg = dataclasses.replace(base, lms=lms)
    model = Model(tcfg.model)
    loader = DataLoader(SyntheticTokens(tcfg.model.vocab_size, seed=SEED), shard=0,
                        num_shards=1, batch_per_shard=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    first = {k: torch.from_numpy(v).cuda() for k, v in next(loader).items()}
    from repro_torch.train.trainer import Trainer
    trainer = Trainer(tcfg, device="cuda", profile=profile)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    state = trainer.init_state()
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    ref_loss = float(_layerwise_loss(model, state, first))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init = [state]
    trainer.init_state = lambda: init.pop()
    del state
    before = off.swap_counters()
    with launch_signatures() as (seen, calls, launches):
        state, hist = trainer.train(steps=n)
    peak = torch.cuda.max_memory_allocated()
    swap = _swap_per_step(before, off.swap_counters(), n)
    pinned_now = off.pinned_bytes()
    step_s = statistics.median(r["time_s"] for r in hist[1:])
    # where the step's time goes: one more step split by CUDA events (the
    # loss and its grads, the clip, the optimizer sweep), and one under
    # torch.profiler (the device's busy share, its copies by direction)
    batch = trainer._make_batch()
    state, split = step_split_ms(trainer.step_fn, state, batch)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.monotonic()
        state, _ = trainer.step_fn(state, batch)
        torch.cuda.synchronize()
        profiled_s = time.monotonic() - t1
    profiled = {**device_summary(prof, profiled_s), "copies": copy_seconds(prof)}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    model_flops, hw_flops = _train_flops(tcfg.model, tokens, TRAIN_SEQ)
    h2d = sum(v for k, v in swap.items() if k.startswith("lms.swap_in_bytes."))
    d2h = sum(v for k, v in swap.items() if k.startswith("lms.swap_out_bytes."))
    unchecked = sorted(seen - checked)
    implied = _implied_rmsnorm_launches(plan, L)
    checks = {"finite": all(math.isfinite(r["loss"]) for r in hist),
              "step1_loss_bitwise_layerwise_forward": hist[0]["loss"] == ref_loss,
              "beyond_the_card": pinned_now + grads > CARD_BYTES,
              "rmsnorm_launches_as_the_plan_implies": launches["rmsnorm"] == n * implied,
              "no_other_launches": all(v == 0 for k, v in launches.items()
                                       if not k.startswith("rmsnorm")),
              "every_launch_recorded": calls == launches,
              "every_launch_shape_checked": not unchecked}
    row = {"phase": "lms_gate", "arch": ARCH, "layers": L, "d_model": tcfg.model.d_model,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": n, "card": line,
           "params": tcfg.model.param_count(), "hbm_budget": lms.hbm_budget,
           "loss": [r["loss"] for r in hist], "layerwise_loss_step1": ref_loss,
           "grad_norm": [r["grad_norm"] for r in hist], "step_s": [r["time_s"] for r in hist],
           "median_step_s_after_1": step_s, "tokens_per_s": tokens / step_s,
           "model_tflop_per_step": model_flops / 1e12,
           "model_tflop_s": model_flops / step_s / 1e12,
           "model_flops_share_of_989": model_flops / step_s / BF16_TENSOR_FLOPS_PER_S,
           "with_recompute_tflop_s": hw_flops / step_s / 1e12,
           "setup_s": setup_s,
           "peak_vs_plan": {"measured": peak, "plan": plan.peak_bytes},
           "pinned_vs_plan": {"measured": pinned_now, "plan_host_bytes": plan.host_bytes},
           "grad_bytes": grads, "state_plus_grads_bytes": pinned_now + grads,
           "swap_per_step": swap,
           "h2d_bytes_per_step": h2d, "d2h_bytes_per_step": d2h,
           "plan_swap_bytes_per_step": plan.swap_bytes_per_step,
           "link_gb_s_in_step": {"h2d": h2d / step_s / 1e9, "d2h": d2h / step_s / 1e9,
                                 "both": (h2d + d2h) / step_s / 1e9},
           "host_phase_gb_s": {"h2d": host_row["h2d_gb_s"], "d2h": host_row["d2h_gb_s"],
                               "both": host_row["both_gb_s"]},
           "rmsnorm_launches_per_step": launches["rmsnorm"] / n,
           "implied_rmsnorm_launches_per_step": implied, "launches": launches,
           "step_split_ms": split, "profile": profiled,
           "unchecked_signatures": unchecked, "checks": checks}
    emit(row)
    del trainer, state, batch
    torch.cuda.empty_cache()
    off.release_arenas()
    if not all(checks.values()):
        raise AssertionError(f"lms_gate ({L} layers): failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def reference_phase(line, checked):
    """The trace at full width but 2 layers, where bf16 rounding stays
    small, held against the dense pass: 4 bf16 ulps of each row's largest
    |logit| (2**-5 of it) at model width, 2**-4 with int8 KV pages. (At 48
    layers, GEMMs of other shapes alone — chunked against one-shot prefill,
    no kernel involved — move the logits by several percent, so the
    full-depth run holds only the argmax where the dense margin is wide.)
    On the same weights: the engine with the flash-attention prefill
    (argmax), the static loop (2**-5, and the engine's tokens), the slot
    decode step without a page arena against the paged one, and
    `Model.forward` against `Model.prefill`.
    -> {kv_dtype: launches of the slot decode phase}."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(ARCH), num_layers=2)
    model = Model(cfg, attn_impl="blockwise")
    params = model.init(SEED + 1, "cuda")
    _, tokens = engine_phase(model, params, "model", line, checked, dense_tol=2.0 ** -5)
    # int8 codes hold each k/v element to half a step of its row's amax/127
    # (0.4% of the row's largest |value|) on top of the bf16 rounding
    engine_phase(model, params, "int8", line, checked, dense_tol=2.0 ** -4)
    kernel_model = Model(cfg, attn_impl="pallas")
    engine_phase(kernel_model, params, "model", line, checked, prefill_chunk=0)
    static_phase(kernel_model, params, line, checked, tokens, dense_tol=2.0 ** -5)
    launches = slot_decode_phase(kernel_model, params, line, checked)
    forward_phase(kernel_model, params, line, checked)
    del params
    torch.cuda.empty_cache()
    return launches


def lms_phases(line, checked):
    """The LMS phases: the host, lms_ab, lms_gate. The gate's depth is
    chosen first, from the host phase's MemAvailable, and its pinned state
    reserved once (`offload.reserve_pinned`), so lms_ab's state and then
    the gate's reuse one pinned arena: on the card's machine pinned memory
    does not come back to MemAvailable once freed, even after the process
    exits (PERF.md §6). -> their rows."""
    from repro_torch.core.lms import offload as off
    host_row = host_phase(line)
    layers = gate_layers(host_row)
    t0 = time.monotonic()
    off.reserve_pinned(_pinned_state_bytes(layers), "cuda")
    emit({"phase": "lms_reserve", "layers": layers, "bytes": _pinned_state_bytes(layers),
          "seconds": time.monotonic() - t0, "meminfo": _mem_row()})
    ab_row = lms_ab_phase(line, checked)
    return host_row, ab_row, lms_gate_phase(line, checked, host_row, ab_row, layers)


def main() -> int:
    line = device_phase()
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    sass_row = build_phase()
    kernels, checked = kernel_phases(get_config(ARCH).num_layers)
    f32_attention_row = f32_attention_phase(line, checked)
    f32_decode_row = f32_decode_phase(line, checked)
    f32_ssd_row = f32_ssd_phase(line, checked)
    decode_sync_phase(line)
    slot_launches = reference_phase(line, checked)
    mamba_row = mamba_phases(line, checked)
    train_reference_phase(line, checked)
    trainer_row = trainer_phase(line, checked)

    t0 = time.monotonic()
    model = Model(get_config(ARCH), attn_impl="blockwise")
    params = model.init(SEED, "cuda")
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": ARCH, "seconds": time.monotonic() - t0,
          "params": model.cfg.param_count(),
          "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    model_row, tokens = engine_phase(model, params, "model", line, checked)
    int8_row, _ = engine_phase(model, params, "int8", line, checked)
    kernel_model = Model(get_config(ARCH), attn_impl="pallas")
    static_row = static_phase(kernel_model, params, line, checked, tokens)
    prefill_route_ab_phase(kernel_model, params, line)

    eng, reqs, _, _ = _serve(model, params, "model")
    again = {r.rid: list(r.tokens) for r in reqs}
    same = again == tokens
    emit({"phase": "determinism", "identical_tokens": same})
    if not same:
        raise AssertionError("the model-width trace gave other tokens on a rerun")
    del eng
    profiled = profile_phase(model, params, line)
    # the engine by KV width, from this run: tok/s of the engine rows,
    # launch calls per layer-tick of the profiled reruns
    emit({"phase": "engine_by_kv_width", "layers": model.cfg.num_layers, "card": line,
          **{kv: {"decode_tok_s": row["decode_tok_s"],
                  "quantize_kv_write_launches": row["quantize_kv_write_launches"],
                  "launch_calls_per_layer_tick": profiled[kv]["launch_calls_per_layer_tick"],
                  "runtime_launch_calls": profiled[kv]["runtime_launch_calls"]}
             for kv, row in (("model", model_row), ("int8", int8_row))}})
    # the DDL ranks are processes of their own on the same card: free it
    del model, params
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    ddl_row = ddl_phase(line, checked)
    ddl_smoke_phase(line, checked)
    lms_phases(line, checked)

    decode_kernel = "src/repro/kernels/flash_attention/decode_kernel.py"
    replaces = {
        "flash_attention_fwd_wgmma": "src/repro/kernels/flash_attention/kernel.py:76",
        "flash_attention_fwd_cuda_core": "src/repro/kernels/flash_attention/kernel.py:76",
        "flash_decode_bf16": f"{decode_kernel}:233",
        "flash_decode_int8": f"{decode_kernel}:233",
        "flash_decode_paged_bf16": f"{decode_kernel}:155",
        "flash_decode_paged_int8": f"{decode_kernel}:155",
        "flash_decode_cuda_core": f"{decode_kernel}:233",
        "quantize_rows": "src/repro/kernels/quantize/kernel.py:25",
        "quantize_kv_write": "src/repro/kernels/quantize/kernel.py:25",
        "dequantize_rows": "src/repro/kernels/quantize/kernel.py:46",
        "dequantize_sum_rows": "src/repro/kernels/quantize/kernel.py:46",
        "ssd_scan_tensor_core": "src/repro/kernels/ssd_scan/kernel.py:72",
        "ssd_scan_cuda_core": "src/repro/kernels/ssd_scan/kernel.py:72",
        "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:24",
    }
    csrc = "src/repro_torch/kernels/csrc"
    sources = {
        "flash_attention_fwd_wgmma": f"{csrc}/flash_attention_wgmma.cu",
        "flash_attention_fwd_cuda_core": f"{csrc}/flash_attention_fwd.cu",
        "flash_decode_bf16": f"{csrc}/flash_decode.cu",
        "flash_decode_int8": f"{csrc}/flash_decode.cu",
        "flash_decode_paged_bf16": f"{csrc}/flash_decode.cu",
        "flash_decode_paged_int8": f"{csrc}/flash_decode.cu",
        "flash_decode_cuda_core": f"{csrc}/flash_decode.cu",
        "quantize_rows": f"{csrc}/quantize.cu",
        "quantize_kv_write": f"{csrc}/quantize.cu",
        "dequantize_rows": f"{csrc}/quantize.cu",
        "dequantize_sum_rows": f"{csrc}/quantize.cu",
        "ssd_scan_tensor_core": f"{csrc}/ssd_scan_mma.cu",
        "ssd_scan_cuda_core": f"{csrc}/ssd_scan.cu",
        "rmsnorm": f"{csrc}/rmsnorm.cu",
    }
    # each kernel's launches on its main path: the 48-layer static loop
    # (kernel #1's tensor-core route, kernel #3's), the f32 attention call
    # (kernel #1's CUDA-core route), the f32 decode call (that of #2 and #3),
    # the slot decode without an arena (int8), the 48-layer engine,
    # the 48-layer Mamba-2 forward (the scan's tensor-core route), the f32
    # scan call (its CUDA-core route), the 4-layer Trainer's 5 steps, the
    # full-width DDL Trainer's 3 steps (rank 0; the pod sum), and error
    # feedback's path after them (the dequantizer)
    launches = {"flash_attention_fwd_wgmma": static_row["launches"]["flash_attention_wgmma"],
                "flash_attention_fwd_cuda_core":
                    f32_attention_row["launches"]["flash_attention_cuda_core"],
                "flash_decode_bf16": static_row["launches"]["flash_decode"],
                "flash_decode_int8": slot_launches["int8"]["flash_decode"],
                "flash_decode_paged_bf16": model_row["decode_launches"],
                "flash_decode_paged_int8": int8_row["decode_launches"],
                "flash_decode_cuda_core": f32_decode_row["launches"]["flash_decode_cuda_core"],
                "quantize_rows": int8_row["quantize_launches"],
                "quantize_kv_write": int8_row["quantize_kv_write_launches"],
                "dequantize_rows": ddl_row["error_feedback"]["launches"]["dequantize_rows"],
                "dequantize_sum_rows": sum(st["dequantize_sum_launches"]
                                           for st in ddl_row["steps"]),
                "ssd_scan_tensor_core": mamba_row["launches"]["ssd_scan_tensor_core"],
                "ssd_scan_cuda_core": f32_ssd_row["launches"]["ssd_scan_cuda_core"],
                "rmsnorm": trainer_row["launches"]["rmsnorm"]}
    out = []
    for name, phase_rows in kernels.items():
        main_row = phase_rows[0]              # the main path's shape
        out.append({"name": name, "route": "cuda", "source": sources[name],
                    "replaces": replaces[name], "launches": launches[name],
                    "max_abs_err": max(r["max_abs_err"] for r in phase_rows),
                    "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
                    "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                    "library_ms": main_row["library_ms"]})
    emit({"phase": "sass_summary", "kernel": "fa_wgmma_kernel",
          "hgmma_total": sass_row["hgmma_total"], "hgmma": sass_row["hgmma"],
          "decode_kernel": "fd_mma_kernel", "decode_hmma_total": sass_row["decode_hmma_total"],
          "ssd_tensor_core": sass_row["ssd_tensor_core"]})
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
