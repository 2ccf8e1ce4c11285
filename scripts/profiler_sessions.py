#!/usr/bin/env python3
"""How often a torch.profiler session on the card records fewer device
operations than were launched, with CUPTI torn down after each session
(PyTorch's default) and kept up (TEARDOWN_CUPTI=0).

    python3 scripts/profiler_sessions.py [--sessions 400] [--iters 20]

Each setting runs in a fresh process: `--sessions` sessions alternating
two yardsticks chip_smoke.py times the same way (SDPA on a long-context
decode batch, 4 device operations a call, and F.rms_norm at the train
step's 4096 x 5120 rows, 1), `--iters` calls a session. A session that
misses operations is printed with where its missing launches fall among
the session's runtime launches (by correlation id). Last line: one JSON
object {setting: {"sessions", "short_sessions", "recorded_share"}}.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = {"teardown": {}, "kept": {"TEARDOWN_CUPTI": "0"}}


def child(sessions: int, iters: int) -> dict:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    torch.cuda.init()
    lens = [int(n) for n in np.random.default_rng(0).integers(2048, 4097, 16)]
    q, k, v, kvl, _ = cs._decode_inputs(lens, 63, False, smax=4096, heads=36, kv_heads=4)
    x = torch.randn(4096, 5120, device="cuda").to(torch.bfloat16)
    w = torch.randn(5120, device="cuda")
    fns = {"sdpa": cs._sdpa(q, k, v, kvl),
           "rms_norm": lambda: F.rms_norm(x, (5120,), w.to(x.dtype), 1e-6)}
    want, short, seen = {}, 0, 0
    for name, fn in fns.items():   # operations a call, from a session of one call
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        want[name] = sum(ev.device_type() == DeviceType.CUDA
                         for ev in prof.profiler.kineto_results.events())
    for i in range(sessions):
        name = ("sdpa", "rms_norm")[i % 2]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fns[name]()
            torch.cuda.synchronize()
        evs = list(prof.profiler.kineto_results.events())
        dev = [ev for ev in evs if ev.device_type() == DeviceType.CUDA]
        seen += len(dev)
        if len(dev) != want[name] * iters:
            short += 1
            got = ({ev.correlation_id() for ev in dev}
                   | {ev.linked_correlation_id() for ev in dev})
            launches = sorted(ev.correlation_id() for ev in evs
                              if ev.device_type() == DeviceType.CPU
                              and ev.name().startswith("cuda") and ev.correlation_id())
            missing = [j for j, c in enumerate(launches) if c not in got]
            print(json.dumps({"session": i, "fn": name, "want": want[name] * iters,
                              "recorded": len(dev), "runtime_launches": len(launches),
                              "missing_at": missing}), flush=True)
    total = sessions // 2 * iters * (want["sdpa"] + want["rms_norm"])
    return {"sessions": sessions, "short_sessions": short, "recorded_share": seen / total,
            "ops_a_call": want}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=400)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.sessions, args.iters)), flush=True)
        return 0
    out = {}
    for setting, env in SETTINGS.items():
        run = subprocess.run([sys.executable, __file__, "--child", "--sessions",
                              str(args.sessions), "--iters", str(args.iters)],
                             env={**os.environ, **env}, capture_output=True, text=True,
                             timeout=1200)
        lines = run.stdout.strip().splitlines()
        print(f"# {setting}", *lines[:-1], sep="\n", flush=True)
        if run.returncode:
            print(run.stderr[-3000:], file=sys.stderr)
            return run.returncode
        out[setting] = json.loads(lines[-1])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
