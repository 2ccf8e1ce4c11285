#!/usr/bin/env python3
"""Serving a model beyond the card's memory: qwen2-72b at all 80 layers on
one H100, its params in pinned host memory under the port's serve plan.

    python3 scripts/serve_beyond_card.py      # from the repo root

qwen2-72b's bf16 stack is ~140 GB and its unstacked rest (the f32
embedding table, the bf16 head, the final norm) ~7.5 GB: 1.8x the card's
80 GB, so it needs a host with ~160 GB free (the four-card machine's; it
raises with the numbers on a smaller one). The plan of
`plan(PlanRequest(serve=True, ...))` at the card's memory puts the params on
the host; `train.steps.init_params(plan=)` builds them from a seed a layer
at a time on the card and copies each into one pinned arena. The engine
then serves 4 requests of 128 + 8 tokens on 2 slots, whole-prompt prefill,
every prefill and decode tick streaming the stack a layer at a time (two
in flight) and the rest from the arena; twice, from the same params.

Checked: every logits row finite; the two runs' tokens identical; the
pinned bytes above the card's memory; the params' swap bytes exactly the
sweeps' (each prefill and each tick copies the stack, the final norm and
the head, and the batch's embedding rows); the engine's peak at most 1.10
x the plan's. Reported beside the card's name and power limit: tok/s, the
seconds a tick, and the link bound of a tick (its bytes over the pinned
host-to-device rate measured here, 1 GiB copies). Any failed check raises
and the script exits non-zero; the last line is {"ok": true, ...}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH, SEED = "qwen2-72b", 0
REQUESTS, PROMPT, GEN, SLOTS = 4, 128, 8, 2
PEAK_OVER_PLAN = 1.10
COPY_BYTES, COPY_REPS = 1 << 30, 5
HOST_SLACK = 8 * 10**9          # MemAvailable kept free beyond the arena


def emit(obj) -> None:
    print(json.dumps(obj, default=str), flush=True)


def mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def h2d_gb_s(torch) -> float:
    """Pinned host-to-device copy rate, GB/s: the best of COPY_REPS copies
    of COPY_BYTES timed by CUDA events."""
    host = torch.empty(COPY_BYTES, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(COPY_BYTES, dtype=torch.uint8, device="cuda")
    best = float("inf")
    for _ in range(COPY_REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dev.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return COPY_BYTES / best / 1e9


def sweep_bytes(params, rows: int) -> int:
    """Params bytes a streamed sweep copies in: the stack, the final norm,
    the head and `rows` f32 embedding rows."""
    from repro_torch.core.lms import offload as off
    embed = params["embed"]
    return (off.tree_bytes(params["decoder"]["stack0"]) + off.tree_bytes(params["final_norm"])
            + off.tree_bytes(embed["lm_head"]) + rows * embed["embedding"].shape[1] * 4)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: serve_beyond_card.py runs on the card")
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(line, flush=True)
    from repro_torch.config.base import LMSConfig, MeshSpec, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.core.lms import offload as off
    from repro_torch.core.lms.planner import PlanRequest, plan as plan_lms
    from repro_torch.kernels import _build
    from repro_torch.models.model import Model
    from repro_torch.serve import ServeEngine, synth_requests
    from repro_torch.train import steps
    t0 = time.monotonic()
    _build.extension()
    emit({"phase": "build", "seconds": time.monotonic() - t0})

    cfg = get_config(ARCH)
    card = torch.cuda.get_device_properties(0).total_memory
    max_len = PROMPT + GEN
    plan = plan_lms(PlanRequest(cfg=cfg, shape=ShapeConfig("serve", "decode", max_len, SLOTS),
                                mesh=MeshSpec((1, 1), ("data", "model")), lms=LMSConfig(),
                                serve=True, slots=SLOTS))
    model = Model(cfg, attn_impl="blockwise")
    need = sum(steps._leaf_bytes(d.shape, steps.DTYPES[d.dtype])
               for _, d in steps._def_paths(model.param_defs()))
    avail = mem_available()
    emit({"phase": "plan", "arch": ARCH, "layers": cfg.num_layers, "card": line,
          "card_bytes": card, "params": cfg.param_count(), "arena_bytes": need,
          "mem_available_bytes": avail, "residency": plan.residency,
          "peak_bytes": plan.peak_bytes, "host_bytes": plan.host_bytes,
          "swap_bytes": dict(plan.swap_schedule.swap_bytes) if plan.swap_schedule else {},
          "prefetch_depth": plan.swap_schedule.prefetch_depth if plan.swap_schedule else None,
          "summary": plan.summary()})
    if plan.residency.get("params") != "host":
        raise AssertionError(f"the plan keeps the params on the card: {plan.residency}")
    if need + HOST_SLACK > avail:
        raise SystemExit(f"{ARCH}'s params need {need / 1e9:.1f} GB of pinned host memory, "
                         f"MemAvailable is {avail / 1e9:.1f} GB: run on a larger host")
    gb_s = h2d_gb_s(torch)

    t0 = time.monotonic()
    params = steps.init_params(model, SEED, "cuda", plan)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.monotonic() - t0
    pinned = off.pinned_bytes()
    emit({"phase": "init", "seconds": init_s, "pinned_bytes": pinned, "card": line,
          "memory_allocated_bytes": torch.cuda.memory_allocated()})

    runs = []
    for run in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = off.swap_counters()
        eng = ServeEngine(model, slots=SLOTS, max_len=max_len, plan=plan, prefill_chunk=0,
                          params=params, seed=SEED, device="cuda")
        finite = [True]
        select = eng._select

        def checked(req, row, select=select):
            finite[0] &= bool(np.isfinite(row).all())
            return select(req, row)
        eng._select = checked
        reqs = synth_requests(cfg, REQUESTS, PROMPT, GEN, np.random.default_rng(SEED))
        t0 = time.monotonic()
        toks = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated() - base
        moved = {k: v - before.get(k, 0) for k, v in off.swap_counters().items()}
        m = eng.metrics()
        ticks = int(m["ticks"])
        tick_bytes = sweep_bytes(params, SLOTS)
        predicted = REQUESTS * sweep_bytes(params, PROMPT) + ticks * tick_bytes
        tick_s = m.get("tpot_p50_s")
        row = {"phase": "serve", "run": run, "card": line, "layers": cfg.num_layers,
               "requests": REQUESTS, "prompt": PROMPT, "gen": GEN, "slots": SLOTS,
               "run_s": wall, "ticks": ticks, "decode_tok_s": m["decode_tok_s"],
               "decode_s_per_tick": m["decode_tokens"] / m["decode_tok_s"] / ticks,
               "tpot_p50_s": tick_s, "ttft_mean_s": m.get("ttft_mean_s"),
               "tick_bytes": tick_bytes, "h2d_gb_s": gb_s,
               "tick_link_bound_s": tick_bytes / (gb_s * 1e9),
               "tok_s_link_bound": SLOTS * gb_s * 1e9 / tick_bytes,
               "swap_in_bytes_params": moved.get("lms.swap_in_bytes.params", 0),
               "swap_in_bytes_predicted": predicted, "peak_bytes": peak,
               "plan_peak_bytes": plan.peak_bytes, "finite": finite[0],
               "statuses": sorted({r.status for r in reqs}),
               "tokens": {rid: t.tolist() for rid, t in toks.items()}}
        emit(row)
        runs.append(row)
        del eng._select       # no reference cycle: the engine's pool can go
        del eng
    checks = {
        "finite_logits": all(r["finite"] for r in runs),
        "all_ok": all(r["statuses"] == ["ok"] for r in runs),
        "two_runs_same_tokens": runs[0]["tokens"] == runs[1]["tokens"],
        "pinned_beyond_card": pinned > card,
        "swap_bytes_exact": all(r["swap_in_bytes_params"] == r["swap_in_bytes_predicted"]
                                for r in runs),
        "peak_within_plan": all(r["peak_bytes"] <= PEAK_OVER_PLAN * plan.peak_bytes
                                for r in runs)}
    emit({"phase": "serve_beyond_card", "card": line, "pinned_bytes": pinned,
          "card_bytes": card, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"failed checks {[k for k, v in checks.items() if not v]}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
