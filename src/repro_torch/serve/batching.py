"""Serve-batch synthesis: which input tensors the prefill and decode steps
take, for the token-input families the port serves."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.serve.scheduler import Request


def request_prompt_len(cfg, req) -> int:
    return int(len(req.prompt))


def request_prefill_batch(cfg, req, device, lo: int = 0,
                          hi: Optional[int] = None,
                          pad_to: Optional[int] = None) -> Dict:
    """B=1 prefill inputs for one request's prompt slice [lo, hi), right-
    padded to `pad_to` (chunked prefill needs a fixed chunk shape; the pad
    rows are masked or overwritten downstream)."""
    hi = request_prompt_len(cfg, req) if hi is None else hi
    toks = np.asarray(req.prompt[lo:hi], np.int32)
    if pad_to and pad_to > len(toks):
        toks = np.pad(toks, (0, pad_to - len(toks)))
    return {"tokens": torch.from_numpy(toks[None]).to(device)}


def synth_requests(cfg, n: int, prompt_len: int, max_new: int,
                   rng: np.random.Generator, *,
                   temperature: Optional[float] = None,
                   top_k: Optional[int] = None) -> List[Request]:
    """n synthetic requests with random prompts — the same trace as the JAX
    package's `synth_requests` for the same rng."""
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (prompt_len,),
                                               dtype=np.int32),
                    max_new=max_new, temperature=temperature, top_k=top_k)
            for i in range(n)]
