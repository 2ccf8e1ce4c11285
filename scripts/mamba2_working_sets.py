#!/usr/bin/env python3
"""The device memory a Mamba-2 layer holds at once, the numbers the port's
planner prices where the JAX package's planner prices none
(`core/lms/planner.py` `SSD_SCAN_CHUNK_TERMS`, `PREFILL_LAYER_CLASSES`).

    python3 scripts/mamba2_working_sets.py          # on the card

At mamba2-1.3b's full width, random weights from a seed, one layer:

* training: the layer's forward recomputed under a checkpoint and its
  backward, the scan's plain version (the kernel has no backward), at
  2 x 2048, 1 x 2048 and 2 x 1024 tokens: the peak above what stood
  before, and that peak in [b, nc, h, q, q] f32 chunk terms;
* the head and the loss (logits, cross-entropy, backward) at the same
  token counts, which no plan prices for any family;
* the serve engine's whole-prompt prefill of one request (B = 1), the
  scan kernel with its final state, without grads, at 700 and 1136
  tokens: the peak above what stood before, and that peak in the plan's
  largest activation class (`ssd_xz`, [tokens, 2 d_inner] bf16).

Peaks are `torch.cuda.max_memory_allocated()` above `memory_allocated()`
before the call. Prints the `nvidia-smi --query-gpu=name,power.limit`
line, then one JSON row; exits non-zero without a card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _peak(torch, fn):
    """-> (fn(), bytes above what stood before at fn's peak)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no card: this script measures device memory on the card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.layers import cross_entropy
    from repro_torch.models.model import Model
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0])
    cfg = dataclasses.replace(get_config("mamba2-1.3b"), num_layers=1)
    params = Model(cfg).init(0, "cuda")
    p = {k: (v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in v.items()})
         for k, v in params["decoder"]["stack0"]["ssd_0"]["ssm"].items()}
    train_p = {k: (v.detach().requires_grad_(True) if isinstance(v, torch.Tensor) else v)
               for k, v in p.items()}
    head = params["embed"]["lm_head"].detach().requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    h, q = cfg.ssm_nheads, cfg.ssm_chunk
    row = {"arch": "mamba2-1.3b", "train": {}, "head_and_loss": {}, "prefill": {}}
    for b, s in ((2, 2048), (1, 2048), (2, 1024)):
        term = b * -(-s // q) * h * q * q * 4
        x = (torch.randn((b, s, cfg.d_model), generator=gen, device="cuda") * 0.5).to(
            torch.bfloat16).requires_grad_(True)

        def layer():
            y = torch.utils.checkpoint.checkpoint(
                lambda t: ssm.apply_ssm(cfg, train_p, t)[0], x, use_reentrant=False)
            y.backward(torch.ones_like(y))
        _, peak = _peak(torch, layer)
        row["train"][f"{b}x{s}"] = {"peak_bytes": peak, "chunk_term_bytes": term,
                                    "chunk_terms": peak / term}
        for v in train_p.values():
            if isinstance(v, torch.Tensor):
                v.grad = None
        labels = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
        xh = x.detach().requires_grad_(True)

        def loss():
            cross_entropy(xh @ head, labels).backward()
        _, peak = _peak(torch, loss)
        row["head_and_loss"][f"{b}x{s}"] = {"peak_bytes": peak,
                                            "logits_bytes": b * s * cfg.vocab_size * 2}
        head.grad = None
        del x, xh, labels
    with torch.no_grad():
        for n in (700, 1136):
            x = (torch.randn((1, n, cfg.d_model), generator=gen, device="cuda") * 0.5).to(
                torch.bfloat16)
            out, peak = _peak(torch, lambda: ssm.apply_ssm(cfg, p, x, ssd_impl="pallas",
                                                          cache=True))
            largest = n * 2 * cfg.d_inner * 2
            row["prefill"][str(n)] = {"peak_bytes": peak, "largest_class_bytes": largest,
                                      "classes": peak / largest}
            del out, x
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
