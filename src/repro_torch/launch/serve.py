"""Serving entry point: the continuous-batching engine (chunked prefill,
slot-batched paged decode, host-spilling KV pool) on a synthetic request
trace; `--static` runs the whole-batch prefill-then-decode loop instead
(the baseline the engine is parity-tested against). Runs on the card
unless `--device cpu` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \
        --requests 8 --slots 4 --prompt-len 128 --gen 32

`--trace` writes a Chrome trace of the run and `--obs-report` its obs
report; `--profile <report>` plans the engine with a serve plan calibrated
by such a report and prints the plan's summary.

`--mesh 1xM` or `1x1xM` serves on a `model` axis of M devices (tensor
parallelism, the MoE family's experts over it: expert parallelism), one
process a device under torchrun, joined as the training launcher joins
them (NCCL with a card a rank, gloo otherwise); rank 0 prints:

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
        -m repro_torch.launch.serve --arch qwen2.5-14b --smoke --mesh 1x2 --device cpu

A `data` or `pod` axis above 1 raises (serving on a data or pod axis is not
ported).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config.base import ShapeConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.lms.planner import PlanRequest, plan as plan_lms
from repro_torch.launch.mesh import init_process_group, make_mesh, parse_mesh
from repro_torch.models import kvquant
from repro_torch.models import transformer as tr
from repro_torch.models.model import Model
from repro_torch.obs import configure, export_chrome_trace, get_obs, write_obs_report
from repro_torch.serve import (ServeEngine, decode_step_batch, resolve_device,
                               static_batch_from_requests, synth_requests)
from repro_torch.serve.engine import check_serve_mesh
from repro_torch.train.steps import (StepSpec, build_decode_step,
                                    build_prefill_step, init_params)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_static(model, reqs, prompt_len: int, gen: int, params=None,
               device=None, plan=None, mesh=None):
    """Static whole-batch greedy baseline: one prefill over every request's
    prompt into the decode-capacity cache, then `gen-1` lockstep decode
    steps. plan: a serve plan, whose host classes stream (params given
    must be placed as it says: `train.steps.place_params`). mesh: a
    tensor-parallel mesh (params this rank's blocks; every rank gets the
    same tokens from the whole logits). -> (params, tokens [N, gen]
    numpy, timings dict)."""
    check_serve_mesh(mesh)
    device = resolve_device(device)
    cfg = model.cfg
    n = len(reqs)
    total = prompt_len + gen
    prefill_fn, _ = build_prefill_step(
        model, ShapeConfig("serve_prefill", "prefill", prompt_len, n),
        StepSpec(plan=plan, cache_len=total), mesh=mesh)
    decode_fn, _ = build_decode_step(
        model, ShapeConfig("serve", "decode", total, n), StepSpec(plan=plan), mesh=mesh)
    if params is None:
        params = init_params(model, 0, device, plan, mesh)
    batch = static_batch_from_requests(cfg, reqs, device)

    t0 = time.monotonic()
    logits, cache = prefill_fn(params, batch)
    _sync(device)
    t_prefill = time.monotonic() - t0

    toks = torch.argmax(logits, dim=-1)[:, None]
    out_tokens = [toks]
    t0 = time.monotonic()
    for i in range(gen - 1):
        step_batch = decode_step_batch(
            cfg, toks, np.full((n,), prompt_len + i, np.int32))
        logits, cache = decode_fn(params, cache, step_batch, prompt_len + i)
        toks = torch.argmax(logits, dim=-1)[:, None]
        out_tokens.append(toks)
    _sync(device)
    t_decode = time.monotonic() - t0
    gen_toks = torch.cat(out_tokens, dim=1).cpu().numpy().astype(np.int32)
    return params, gen_toks, {
        "prefill_s": t_prefill, "decode_s": t_decode,
        "decode_tok_s": (gen - 1) * n / max(t_decode, 1e-9)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; never falls back)")
    p.add_argument("--requests", type=int, default=8,
                   help="request-trace length")
    p.add_argument("--slots", type=int, default=4,
                   help="concurrent decode slots")
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy; >0 samples")
    p.add_argument("--top-k", type=int, default=0,
                   help="top-k filter for sampling (0 = full vocab)")
    p.add_argument("--page-size", type=int, default=16,
                   help="KV pool page size in tokens")
    p.add_argument("--device-pages", type=int, default=None,
                   help="device page budget (default: every slot at full "
                        "length)")
    p.add_argument("--prefill-chunk", type=int, default=32,
                   help="chunked-prefill width (0 = whole prompt)")
    p.add_argument("--kv-dtype", choices=("model", "int8"), default="model",
                   help="KV page storage width: int8 stores codes + per-row "
                        "scales")
    p.add_argument("--static", action="store_true",
                   help="run the whole-batch baseline loop instead")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", default="1x1",
                   help="device mesh: 1x1, or 1xM / 1x1xM over `model` (one "
                        "process a device under torchrun); a data or pod axis "
                        "above 1 raises")
    p.add_argument("--obs-jsonl", default="",
                   help="stream span events to this JSONL file")
    p.add_argument("--trace", default="",
                   help="write a Chrome trace_event JSON of the run at exit")
    p.add_argument("--obs-report", default="",
                   help="write the overlap/swap obs report JSON at exit")
    p.add_argument("--profile", default="",
                   help="plan the engine with a serve plan calibrated by this "
                        "obs_report.json (a run's --obs-report) and print it")
    args = p.parse_args(argv)
    if args.static and args.profile:
        p.error("--profile plans the engine's paged pool; the --static "
                "baseline loop is unplanned")
    if args.static and (args.temperature > 0 or args.top_k):
        p.error("--temperature/--top-k sample in the engine only; the "
                "--static baseline loop is greedy by construction")
    if args.static and kvquant.validate_kv_dtype(args.kv_dtype) != "model":
        p.error("--kv-dtype applies to the engine's paged pool; the "
                "--static baseline decodes a model-width cache")

    mesh_spec = parse_mesh(args.mesh)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    # what does not serve on a mesh, before any rank starts
    check_serve_mesh(mesh_spec)
    tr._check_kinds(cfg, mesh_spec)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != mesh_spec.num_devices:
        raise ValueError(f"WORLD_SIZE {world} disagrees with --mesh {args.mesh} "
                         f"({mesh_spec.num_devices} devices): run one process per device")
    # the world this launcher joins it leaves once serving is done, every
    # rank together (a rank that exits while its peer still holds the
    # group aborts it)
    joined = world > 1 and not dist.is_initialized()
    if joined:
        init_process_group(args.device, world)
    mesh = make_mesh(mesh_spec)
    rank0 = mesh.rank == 0
    device = resolve_device(args.device)
    # the SSD scan kernel (its plain version on CPU tensors): the prefill of
    # a Mamba-2 stack takes its final state from it
    model = Model(cfg, attn_impl="naive" if args.smoke else "blockwise", ssd_impl="pallas")
    rng = np.random.default_rng(args.seed)
    reqs = synth_requests(cfg, args.requests, args.prompt_len, args.gen, rng)

    if args.static:
        _, gen_toks, t = run_static(model, reqs, args.prompt_len, args.gen,
                                    params=model.init(args.seed, device, mesh=mesh),
                                    device=device, mesh=mesh)
        if joined:
            dist.destroy_process_group()
        if not rank0:
            return 0
        print(f"device {device} | prefill: {t['prefill_s']*1e3:.1f} ms | "
              f"decode: {t['decode_s']*1e3:.1f} ms "
              f"({t['decode_tok_s']:.1f} tok/s)")
        print("generated token ids (first row):", gen_toks[0][:16])
        return 0

    configure(jsonl_path=args.obs_jsonl or None)
    obs = get_obs()
    total = args.prompt_len + args.gen
    slots = min(args.slots, args.requests)
    plan = None
    if args.profile:
        plan = plan_lms(PlanRequest(
            cfg=cfg, shape=ShapeConfig("cli_serve", "decode", total, args.requests),
            mesh=mesh_spec, serve=True, slots=slots, page_size=args.page_size,
            kv_dtype=args.kv_dtype), profile=args.profile)
        if rank0:
            print(plan.summary())
    eng = ServeEngine(model, slots=slots, max_len=total, plan=plan,
                      page_size=args.page_size,
                      device_pages=args.device_pages,
                      prefill_chunk=args.prefill_chunk,
                      temperature=args.temperature, top_k=args.top_k,
                      seed=args.seed, kv_dtype=args.kv_dtype, obs=obs,
                      device=device, mesh=mesh)
    results = eng.run(reqs)
    if joined:
        dist.destroy_process_group()
    if not rank0:
        return 0
    m = eng.metrics()
    returned = int(m["pool_fetched_pages"] + m["pool_prefetched_pages"])
    print(f"device {device} | served {len(results)} requests | decode "
          f"{m['decode_tok_s']:.1f} tok/s | ttft "
          f"{m.get('ttft_mean_s', 0)*1e3:.1f} ms | tpot p50/p95 "
          f"{m.get('tpot_p50_s', 0)*1e3:.1f}/"
          f"{m.get('tpot_p95_s', 0)*1e3:.1f} ms | concurrency "
          f"{m['mean_concurrency']:.2f} | pages spilled/returned "
          f"{int(m['pool_spilled_pages'])}/{returned} "
          f"({int(m['pool_prefetched_pages'])} staged ahead)")
    print("generated token ids (first request):",
          np.asarray(results[reqs[0].rid])[:16])
    if args.trace:
        export_chrome_trace(obs.ring.events(), args.trace)
        print(f"chrome trace: {args.trace}")
    if args.obs_report:
        write_obs_report(args.obs_report, obs=eng.obs)
        print(f"obs report: {args.obs_report}")
    print("-- metrics --")
    for line in eng.obs.registry.summary_lines():
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
