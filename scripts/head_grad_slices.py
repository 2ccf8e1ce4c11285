#!/usr/bin/env python3
"""Whether the LM head's grad formed a block of rows at a time is bitwise
the grad autograd forms whole, on the GEMMs of the device it runs on.

    python3 scripts/head_grad_slices.py                 # on the card
    python3 scripts/head_grad_slices.py --device cpu --d 256 --vocab 1000 --tokens 64

The head is `logits = x @ W` (x [B, S, d] bf16, W [d, V] bf16). Autograd's
backward forms dW = x^T . dlogits [d, V] and dx = dlogits . W^T in one GEMM
each. `models/rest.py` forms dW a block of `HEAD_ROWS` rows at a time
(`HeadGrad`), so the whole [d, V] grad never stands: rows lo:hi are
x[:, lo:hi]^T . dlogits, one GEMM with another M. This script holds both
against autograd on random inputs from a seed, for each token count: every
block of the module's row size, blocks of other sizes aligned to it, and
`HeadGrad`'s own flat ranges (the pieces zero1 reduces), and times the
whole GEMM against the blocks. It prints one JSON row per token count and,
on the card, the `nvidia-smi --query-gpu=name,power.limit` line; it exits
non-zero unless every block is bitwise.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _timed(fn, device, reps: int = 5) -> float:
    """Median milliseconds of fn() over `reps` calls after one warm call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def probe(d: int, vocab: int, tokens: int, device, seed: int) -> dict:
    import torch
    from repro_torch.models import rest
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(1, tokens, d, generator=gen).to(torch.bfloat16).to(device)
    w = (0.02 * torch.randn(d, vocab, generator=gen)).to(torch.bfloat16).to(device)
    g = torch.randn(1, tokens, vocab, generator=gen).to(torch.bfloat16).to(device)
    # autograd's grads of the head's product
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    (xa @ wa).backward(g)
    want_w, want_x = wa.grad, xa.grad
    del xa, wa
    got = rest.HeadGrad(tuple(w.shape), x, g)
    R = rest.HEAD_ROWS
    sizes = sorted({R, 2 * R, 4 * R, min(d, 1 << 10)})
    blocks = {}
    for size in sizes:
        ok = True
        for lo in range(0, d, size):
            hi = min(lo + size, d)
            ok &= torch.equal(got.rows(lo, hi), want_w[lo:hi])
        blocks[size] = ok
    # zero1's pieces: flat ranges of POD_SLICE-like lengths, any offset
    flat = want_w.reshape(-1)
    n = flat.numel()
    step = max(n // 7, 1)
    ranges = [(a, min(a + step + 13, n)) for a in range(5, n, step)]
    ranges_ok = all(torch.equal(got.flat_range(a, b), flat[a:b]) for a, b in ranges)
    dense_ok = torch.equal(got.dense(), want_w)
    dx = rest.head_input_grad(g, w)
    dx_ok = torch.equal(dx, want_x)
    diff = max(float((got.rows(lo, min(lo + R, d)).float()
                      - want_w[lo:lo + R].float()).abs().max()) for lo in range(0, d, R))
    whole_ms = _timed(lambda: got.dense(), device)
    blocks_ms = _timed(lambda: [got.rows(lo, min(lo + R, d)) for lo in range(0, d, R)],
                       device)
    return {"d": d, "vocab": vocab, "tokens": tokens, "head_rows": R,
            "blocks_bitwise": {str(k): v for k, v in blocks.items()},
            "flat_ranges_bitwise": ranges_ok, "dense_bitwise": dense_ok,
            "input_grad_bitwise": dx_ok, "max_abs_diff": diff,
            "whole_ms": whole_ms, "blocks_ms": blocks_ms,
            "ok": all(blocks.values()) and ranges_ok and dense_ok and dx_ok}


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--d", type=int, default=5120)            # qwen2.5-14b
    p.add_argument("--vocab", type=int, default=152064)
    p.add_argument("--tokens", type=int, nargs="+", default=[2048, 4096])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no card: pass --device cpu for a small run")
        print(_card_line(), flush=True)
    rows = [probe(args.d, args.vocab, t, device, args.seed + t) for t in args.tokens]
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
