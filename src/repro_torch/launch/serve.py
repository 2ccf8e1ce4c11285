"""Serving entry point: the continuous-batching engine (chunked prefill,
slot-batched paged decode, host-spilling KV pool) on a synthetic request
trace. Runs on the card unless `--device cpu` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \
        --requests 8 --slots 4 --prompt-len 128 --gen 32
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.model import Model
from repro_torch.obs import configure, get_obs
from repro_torch.serve import ServeEngine, resolve_device, synth_requests


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
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--obs-jsonl", default="",
                   help="stream span events to this JSONL file")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, attn_impl="naive" if args.smoke else "blockwise")
    rng = np.random.default_rng(args.seed)
    reqs = synth_requests(cfg, args.requests, args.prompt_len, args.gen, rng)

    configure(jsonl_path=args.obs_jsonl or None)
    obs = get_obs()
    eng = ServeEngine(model, slots=min(args.slots, args.requests),
                      max_len=args.prompt_len + args.gen,
                      page_size=args.page_size,
                      device_pages=args.device_pages,
                      prefill_chunk=args.prefill_chunk,
                      temperature=args.temperature, top_k=args.top_k,
                      seed=args.seed, kv_dtype=args.kv_dtype, obs=obs,
                      device=device)
    results = eng.run(reqs)
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
    print("-- metrics --")
    for line in eng.obs.registry.summary_lines():
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
