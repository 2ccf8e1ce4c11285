#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py        # from the repo root, on a machine with the card

Phases, each printed as one JSON line (any failure raises and exits
non-zero, printing no result):

1. device — the card's name and power limit as nvidia-smi gives them (also
   printed raw on a line of its own);
2. build — the CUDA kernels built from the repo's sources (seconds);
3. kernels — each kernel on the card against its plain PyTorch version at
   every shape the served trace gives it and at a long-context shape, with
   its time, the plain version's, the least time the card could take
   (bound) and, for decode, one PyTorch SDPA call on gathered caches as a
   yardstick (never called by the port);
4. engine — the serve engine at the full width of qwen2.5-14b, first at 2
   layers, then at the full 48 (random bf16 weights from a seed), serving
   8 requests with half the device pages full residency needs, so the
   backlog spills to pinned host memory; each with model-width KV pages,
   then int8. Every kernel launch's shape must be one the kernel phases
   checked, and the logits are held against a dense one-shot pass over
   each request's prompt and tokens;
5. determinism — the 48-layer model-width trace again, token for token;
6. profile — that trace once more under torch.profiler: the device's busy
   share and its top kernels.

The line before the last lists every ported kernel with its launches on
the main path; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12          # CUDA cores, outside the tensor cores

ARCH = "qwen2.5-14b"
H, K, D, PAGE = 40, 8, 128, 16   # qwen2.5-14b attention
SEED = 0
# the served trace: 8 requests of prompt 128 + 32 greedy tokens on 4 slots,
# with half the 40 device pages full residency needs
REQUESTS, PROMPT, GEN = 8, 128, 32
SLOTS, MAX_LEN, CHUNK, DEVICE_PAGES = 4, 160, 32, 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float):
    """-> (bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the f32 peak (the kernels compute in f32)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
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


def _paged_inputs(kv_lens, seed, pages=None, max_pages=None):
    """q + bf16 arenas + a scrambled table on the card: each slot owns
    distinct random pages in random order; empty slots and unused entries
    point at the null page (the last row); spare pages and the null page
    hold garbage. `pages` (arena rows less the null page) and `max_pages`
    (table width) default to what kv_lens need, plus 8 spare pages."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    b = len(kv_lens)
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
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn((b, H, D), generator=gen, device=dev).bfloat16()
    k = torch.randn((pages + 1, PAGE, K, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((pages + 1, PAGE, K, D), generator=gen, device=dev).bfloat16()
    return (q, k, v, torch.tensor(kv_lens, dtype=torch.int32, device=dev),
            torch.from_numpy(tab).to(dev))


def _sdpa_ms(q, kc, vc, kv_len):
    """One SDPA call (GQA) on slot-contiguous caches: the yardstick."""
    import torch
    import torch.nn.functional as F
    s = kc.shape[1]
    qs = q[:, :, None]                                   # [B,H,1,D]
    ks, vs = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(s, device=q.device)[None, :] < kv_len[:, None].long()
            )[:, None, None, :]
    return time_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True))


def decode_sig(q, k_pages, page_table):
    """What the decode kernel's launch depends on besides the data."""
    return ("flash_decode_paged", tuple(q.shape), str(q.dtype),
            tuple(k_pages.shape), str(k_pages.dtype), tuple(page_table.shape))


def quantize_sig(x):
    return ("quantize_rows", tuple(x.shape), str(x.dtype))


def decode_kernel_phase(shape: str, kv_lens, int8: bool, seed: int, checked: set,
                        pages=None, max_pages=None):
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_decode_paged_cuda
    from repro_torch.kernels.flash_attention.ref import (flash_decode_paged_ref,
                                                         gather_pages)
    from repro_torch.kernels.quantize.ref import quantize_ref
    q, k, v, kvl, tab = _paged_inputs(kv_lens, seed, pages, max_pages)
    kw = {}
    if int8:
        def quant(x):
            c, s = quantize_ref(x.reshape(-1, D))
            return c.reshape(x.shape), s.reshape(x.shape[:-1])
        k, ks = quant(k)
        v, vs = quant(v)
        kw = {"k_scale": ks, "v_scale": vs}
    out = flash_decode_paged_cuda(q, k, v, kvl, tab, **kw)
    torch.cuda.synchronize()
    plain = flash_decode_paged_ref(q, k, v, kvl, tab, **kw)
    err = (out.float() - plain.float()).abs()
    ulps = (err / bf16_row_ulp(plain)).max().item()
    ok = ulps <= 1.0
    zeros = bool((out[kvl == 0] == 0).all())
    if not (ok and zeros and torch.isfinite(out).all()):
        raise AssertionError(f"decode {shape} int8={int8}: kernel vs plain max "
                             f"|diff| {err.max().item()} ({ulps} row ulps), "
                             f"zeros={zeros}")
    checked.add(decode_sig(q, k, tab))
    kernel_ms = time_ms(lambda: flash_decode_paged_cuda(q, k, v, kvl, tab, **kw))
    plain_ms = time_ms(lambda: flash_decode_paged_ref(q, k, v, kvl, tab, **kw),
                       iters=10, warmup=2)
    # the yardstick sees the same values as slot-contiguous bf16 caches
    kc, vc = gather_pages(k, tab), gather_pages(v, tab)
    if int8:
        kc = (kc.float() * gather_pages(ks, tab)[..., None]).bfloat16()
        vc = (vc.float() * gather_pages(vs, tab)[..., None]).bfloat16()
    library_ms = _sdpa_ms(q, kc, vc, kvl)
    b = len(kv_lens)
    tokens = sum(kv_lens)
    kv_bytes = tokens * K * D * (1 if int8 else 2) * 2
    if int8:
        kv_bytes += tokens * K * 4 * 2
    table_bytes = sum(-(-n // PAGE) for n in kv_lens) * 4 + b * 4
    nbytes = 2 * b * H * D * 2 + kv_bytes + table_bytes
    flops = 4 * H * D * tokens + (2 * K * D * tokens * 2 if int8 else 0)
    bound_ms, bound_by = bound(nbytes, flops)
    row = {"phase": "kernel", "kernel": "flash_decode_paged_" + ("int8" if int8 else "bf16"),
           "shape": shape, "slots": b, "arena_pages": k.shape[0],
           "table_width": tab.shape[1], "kv_len_min": min(kv_lens),
           "kv_len_max": max(kv_lens), "kv_tokens": tokens,
           "max_abs_err": err.max().item(), "max_row_ulps": ulps,
           "tolerance": "1 bf16 ulp of each row's max |plain|",
           "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "library": "F.scaled_dot_product_attention(enable_gqa=True)"}
    emit(row)
    return row


def quantize_kernel_phase(shape: str, rows: int, seed: int, checked: set):
    import torch
    from repro_torch.kernels.quantize.ops import quantize_cuda
    from repro_torch.kernels.quantize.ref import quantize_ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((rows, D), generator=gen, device="cuda")
         * torch.rand((rows, 1), generator=gen, device="cuda") * 4).bfloat16()
    x[0] = 0                                  # an all-zero row: scale 1
    q, s = quantize_cuda(x)
    torch.cuda.synchronize()
    pq, ps = quantize_ref(x)
    if not (torch.equal(q, pq) and torch.equal(s.view(torch.int32), ps.view(torch.int32))):
        raise AssertionError(f"quantize {shape}: codes or scales differ from the "
                             "plain version")
    checked.add(quantize_sig(x))
    kernel_ms = time_ms(lambda: quantize_cuda(x))
    plain_ms = time_ms(lambda: quantize_ref(x), iters=20)
    bound_ms, bound_by = bound(rows * D * 2 + rows * D + rows * 4, rows * D * 5)
    row = {"phase": "kernel", "kernel": "quantize_rows", "shape": shape, "rows": rows,
           "cols": D, "max_abs_err": float((q.float() - pq.float()).abs().max()),
           "tolerance": "bitwise", "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    emit(row)
    return row


def kernel_phases(num_layers: int):
    """Each kernel against its plain version at every shape the served
    trace gives it (the engine's arena and table for decode; each decoded
    token's rows, and the pool's quantize of a prefill cache of 2 and of
    num_layers layers) and at a long-context shape. -> ({kernel: [rows]},
    the launch signatures checked)."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    long_lens = [int(n) for n in rng.integers(2048, 4097, 16)]
    out, checked = {}, set()
    for int8 in (False, True):
        name = "flash_decode_paged_" + ("int8" if int8 else "bf16")
        out[name] = [decode_kernel_phase("engine", [160, 97, 0, 33], int8, 1, checked,
                                         pages=DEVICE_PAGES, max_pages=MAX_LEN // PAGE),
                     decode_kernel_phase("long_context", long_lens, int8, 2, checked)]
    out["quantize_rows"] = [
        quantize_kernel_phase("decode_token", SLOTS * K, 3, checked),
        quantize_kernel_phase("decode_token_long", 16 * K, 4, checked),
        quantize_kernel_phase("prefill", 4 * MAX_LEN * K, 5, checked),
        quantize_kernel_phase("pool_ingest_2_layers", 2 * MAX_LEN * K, 6, checked),
        quantize_kernel_phase(f"pool_ingest_{num_layers}_layers",
                              num_layers * MAX_LEN * K, 7, checked)]
    return out, checked


@contextlib.contextmanager
def launch_signatures():
    """Record the launch signature of every kernel call inside the block.
    The dispatchers the model calls through (`flash_decode_paged`,
    `quantize`) are swapped for recording stand-ins that call them; the
    wrappers below them launch and count as always. -> (signatures seen,
    {kernel: calls recorded}), for the caller to match against the
    wrappers' launch counts."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.quantize import ops as q_ops
    seen, calls = set(), {"flash_decode_paged": 0, "quantize_rows": 0}
    decode, quantize = fa_ops.flash_decode_paged, q_ops.quantize

    def decode_spy(q, k_pages, v_pages, kv_len, page_table, **kw):
        seen.add(decode_sig(q[:, 0] if q.dim() == 4 else q, k_pages, page_table))
        calls["flash_decode_paged"] += 1
        return decode(q, k_pages, v_pages, kv_len, page_table, **kw)

    def quantize_spy(x):
        seen.add(quantize_sig(x))
        calls["quantize_rows"] += 1
        return quantize(x)
    fa_ops.flash_decode_paged, q_ops.quantize = decode_spy, quantize_spy
    try:
        yield seen, calls
    finally:
        fa_ops.flash_decode_paged, q_ops.quantize = decode, quantize


def _serve(model, params, kv_dtype, rows=None, around_run=None):
    """Serve the trace once, inside `around_run` (a context manager) if
    given; -> (engine, requests, finite logits?, seconds of eng.run)."""
    import numpy as np
    from repro_torch.serve import ServeEngine, synth_requests
    eng = ServeEngine(model, slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
                      prefill_chunk=CHUNK, device_pages=DEVICE_PAGES, params=params,
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


def _dense_deviation(model, params, reqs, rows):
    """The engine's logits rows (chunked prefill, then paged decode through
    the kernels, with spills and returns) of the first and last request
    against one dense pass over each one's prompt and generated tokens at
    model width. -> {"worst": max over rows of max |diff| / max |dense|,
    "prefill_row": the same for the prefill rows alone, "argmax_mismatches":
    rows whose argmax differs where the dense top-2 margin exceeds 2**-4 of
    the row's max |logit|}."""
    import numpy as np
    import torch
    worst = first = 0.0
    mismatches = 0
    for req in (reqs[0], reqs[-1]):
        toks = np.concatenate([req.prompt, np.asarray(req.tokens[:-1], np.int32)])
        n = len(toks)
        cache = model.init_cache(1, MAX_LEN, "cuda")
        with torch.no_grad():
            logits, _ = model.prefill_chunk(
                params, cache, {"tokens": torch.from_numpy(toks[None]).cuda()}, 0, n)
        dense = logits[0, len(req.prompt) - 1:].float().cpu().numpy()
        got = np.stack(rows[req.rid])
        assert dense.shape == got.shape, (dense.shape, got.shape)
        for i, (g, w) in enumerate(zip(got, dense)):
            top = float(np.abs(w).max())
            dev = float(np.abs(g - w).max()) / top
            worst = max(worst, dev)
            if i == 0:
                first = max(first, dev)
            srt = np.sort(w)
            if srt[-1] - srt[-2] > 2.0 ** -4 * top and int(np.argmax(g)) != int(np.argmax(w)):
                mismatches += 1
    return {"worst": worst, "prefill_row": first, "argmax_mismatches": mismatches}


def engine_phase(model, params, kv_dtype, line, checked, dense_tol=None):
    """Serve the trace with counts reset just before and read just after;
    check the run, that every launch had a signature the kernel phases
    held against the plain version, and the logits against the dense pass
    (argmax always; the deviation too when dense_tol is given)."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_decode_paged_cuda
    from repro_torch.kernels.quantize.ops import quantize_cuda
    rows = {}
    torch.cuda.reset_peak_memory_stats()
    with launch_signatures() as (seen, calls):
        flash_decode_paged_cuda.launches = 0
        quantize_cuda.launches = 0
        eng, reqs, finite, wall = _serve(model, params, kv_dtype, rows)
        decode_launches = flash_decode_paged_cuda.launches
        quant_launches = quantize_cuda.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    m = eng.metrics()
    cfg = model.cfg
    bad = [(r.rid, r.status, len(r.tokens)) for r in reqs
           if r.status != "ok" or len(r.tokens) != GEN]
    dense = _dense_deviation(model, params, reqs, rows)
    unchecked = sorted(seen - checked)
    checks = {
        "all_ok_32_tokens": not bad,
        "spilled": m["pool_spilled_pages"] > 0,
        "returned": m["pool_fetched_pages"] + m["pool_prefetched_pages"] > 0,
        "decode_launches_eq_layers_x_ticks":
            decode_launches == cfg.num_layers * int(m["ticks"]),
        "quantize_launches": (quant_launches > 0) if kv_dtype == "int8"
                             else quant_launches == 0,
        "every_launch_recorded": calls == {"flash_decode_paged": decode_launches,
                                           "quantize_rows": quant_launches},
        "every_launch_shape_checked": not unchecked,
        "finite_logits": finite,
        "dense_argmax": dense["argmax_mismatches"] == 0,
    }
    if dense_tol is not None:
        checks["dense_within_tol"] = dense["worst"] <= dense_tol
    row = {"phase": "engine", "kv_dtype": kv_dtype, "arch": ARCH,
           "layers": cfg.num_layers, "d_model": cfg.d_model, "requests": len(reqs),
           "prompt": PROMPT, "gen": GEN, "slots": SLOTS, "page_size": PAGE,
           "device_pages": DEVICE_PAGES, "prefill_chunk": CHUNK, "card": line,
           "decode_tok_s": m["decode_tok_s"], "ttft_mean_s": m.get("ttft_mean_s"),
           "ttft_p95_s": m.get("ttft_p95_s"), "tpot_p50_s": m.get("tpot_p50_s"),
           "tpot_p95_s": m.get("tpot_p95_s"), "ticks": m["ticks"],
           "mean_concurrency": m["mean_concurrency"], "run_s": wall,
           "max_memory_allocated_gb": peak_gb,
           "pool_spilled_pages": m["pool_spilled_pages"],
           "pool_fetched_pages": m["pool_fetched_pages"],
           "pool_prefetched_pages": m["pool_prefetched_pages"],
           "decode_launches": decode_launches, "quantize_launches": quant_launches,
           "launch_signatures": sorted(seen), "unchecked_signatures": unchecked,
           "dense": dense, "dense_tol": dense_tol, "checks": checks, "bad": bad}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"engine {kv_dtype} ({cfg.num_layers} layers): failed "
                             f"checks {[k for k, v in checks.items() if not v]}")
    return row, {r.rid: list(r.tokens) for r in reqs}


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


def profile_phase(model, params, line):
    """The model-width trace once more, under torch.profiler. The device
    is busy while at least one kernel, copy or fill the profiler saw on the
    card runs (the union of their intervals, so overlaps count once); its
    busy share is that over the seconds of eng.run, which the profiler's
    own host overhead lengthens, so the share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.monotonic()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    eng, _, _, wall = _serve(model, params, "model", around_run=prof)
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
    m = eng.metrics()
    emit({"phase": "profile", "kv_dtype": "model", "layers": model.cfg.num_layers,
          "card": line, "seconds": time.monotonic() - t0, "run_s": wall, "device_busy_s": busy,
          "device_busy_share": busy / wall,
          "device_summed_s": sum(e - s for s, e in intervals) / 1e9,
          "device_events": len(intervals), "runtime_launch_calls": runtime_launches,
          "ticks": m["ticks"], "decode_tok_s": m["decode_tok_s"],
          "top_device": [{"name": n[:120], "s": t / 1e9, "count": c}
                         for n, (t, c) in top]})


def reference_phase(line, checked):
    """The trace at full width but 2 layers, where bf16 rounding stays
    small, held against the dense pass: 4 bf16 ulps of each row's largest
    |logit| (2**-5 of it) at model width, 2**-4 with int8 KV pages. (At 48 layers, GEMMs of other
    shapes alone — chunked against one-shot prefill, no kernel involved —
    move the logits by several percent, so the full-depth run holds only
    the argmax where the dense margin is wide.)"""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    model = Model(dataclasses.replace(get_config(ARCH), num_layers=2), attn_impl="naive")
    params = model.init(SEED + 1, "cuda")
    engine_phase(model, params, "model", line, checked, dense_tol=2.0 ** -5)
    # int8 codes hold each k/v element to half a step of its row's amax/127
    # (0.4% of the row's largest |value|) on top of the bf16 rounding
    engine_phase(model, params, "int8", line, checked, dense_tol=2.0 ** -4)
    del params
    torch.cuda.empty_cache()


def main() -> int:
    line = device_phase()
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    build_phase()
    kernels, checked = kernel_phases(get_config(ARCH).num_layers)
    reference_phase(line, checked)

    t0 = time.monotonic()
    model = Model(get_config(ARCH), attn_impl="naive")
    params = model.init(SEED, "cuda")
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": ARCH, "seconds": time.monotonic() - t0,
          "params": model.cfg.param_count(),
          "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    model_row, tokens = engine_phase(model, params, "model", line, checked)
    int8_row, _ = engine_phase(model, params, "int8", line, checked)

    eng, reqs, _, _ = _serve(model, params, "model")
    again = {r.rid: list(r.tokens) for r in reqs}
    same = again == tokens
    emit({"phase": "determinism", "identical_tokens": same})
    if not same:
        raise AssertionError("the model-width trace gave other tokens on a rerun")
    del eng
    profile_phase(model, params, line)

    replaces = {
        "flash_decode_paged_bf16": "src/repro/kernels/flash_attention/decode_kernel.py:155",
        "flash_decode_paged_int8": "src/repro/kernels/flash_attention/decode_kernel.py:155",
        "quantize_rows": "src/repro/kernels/quantize/kernel.py:25",
    }
    sources = {
        "flash_decode_paged_bf16": "src/repro_torch/kernels/csrc/flash_decode_paged.cu",
        "flash_decode_paged_int8": "src/repro_torch/kernels/csrc/flash_decode_paged.cu",
        "quantize_rows": "src/repro_torch/kernels/csrc/quantize.cu",
    }
    launches = {"flash_decode_paged_bf16": model_row["decode_launches"],
                "flash_decode_paged_int8": int8_row["decode_launches"],
                "quantize_rows": int8_row["quantize_launches"]}
    out = []
    for name, phase_rows in kernels.items():
        main_row = phase_rows[0]              # the engine's shape
        out.append({"name": name, "route": "cuda", "source": sources[name],
                    "replaces": replaces[name], "launches": launches[name],
                    "max_abs_err": max(r["max_abs_err"] for r in phase_rows),
                    "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
                    "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                    "library_ms": main_row["library_ms"]})
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
