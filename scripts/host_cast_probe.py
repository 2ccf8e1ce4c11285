#!/usr/bin/env python3
"""Where a blocking device-to-host copy with a dtype change converts.

    python3 scripts/host_cast_probe.py        # on a machine with a card

zero1 under an LMS plan keeps the stack's bf16 params in pinned host
memory and writes each all-gathered f32 leaf back into them
(`train/steps.py::_zero1_params_from`). This times that write for one
leaf of qwen2.5-14b's MLP stacked over 12 layers (12 x 13824 x 5120
elements, an f32 tensor on the card into a bf16 view of a pinned
`offload.PinnedArena`), two ways, in turns: `host.copy_(dev)` (torch
converts the dtype of a blocking copy to the host on the CPU) and
`host.copy_(dev.to(bfloat16))` (the cast on the card, then a bf16 copy),
checking the two give the same bits. Prints the card's nvidia-smi line,
then one JSON row: seconds and GB/s of the f32 source each way, the
ratio. Raises without a card.
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

SHAPE = (12, 13824, 5120)
REPS = 3


def main() -> int:
    import torch
    from repro_torch.core.lms import offload as off
    if not torch.cuda.is_available():
        raise SystemExit("host_cast_probe.py needs a card")
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(line, flush=True)
    n = 1
    for d in SHAPE:
        n *= d
    arena = off.PinnedArena(off.PinnedArena.padded(2 * n), "cuda")
    host = arena.take(SHAPE, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.randn(SHAPE, generator=gen, device="cuda")
    ways = {"cast_on_cpu": lambda: host.copy_(dev),
            "cast_on_card": lambda: host.copy_(dev.to(torch.bfloat16))}
    times = {k: [] for k in ways}
    bits = {}
    for _ in range(REPS):
        for name, fn in ways.items():
            torch.cuda.synchronize()
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            times[name].append(time.monotonic() - t0)
            bits[name] = host.view(torch.int16).clone()
    same = torch.equal(bits["cast_on_cpu"], bits["cast_on_card"])
    best = {k: min(v) for k, v in times.items()}
    print(json.dumps({"phase": "host_cast", "card": line, "shape": list(SHAPE), "elements": n,
                      "f32_bytes": 4 * n, "seconds": times, "best_s": best,
                      "f32_gb_s": {k: 4 * n / v / 1e9 for k, v in best.items()},
                      "ratio": best["cast_on_cpu"] / best["cast_on_card"],
                      "same_bits": same, "nproc": os.cpu_count(),
                      "torch_threads": torch.get_num_threads()}), flush=True)
    arena.release()
    if not same:
        raise AssertionError("the two casts gave different bits")
    return 0


if __name__ == "__main__":
    sys.exit(main())
