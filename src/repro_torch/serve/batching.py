"""Serve-batch synthesis: which input tensors the prefill and decode steps
take, for the token-input families the port serves (the vlm and audio
families' embeds are not ported yet)."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.serve.scheduler import Request


def _check_text(cfg) -> None:
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.family} serve batches are not ported yet")


def synth_prompt_batch(cfg, batch_size: int, prompt_len: int,
                       rng: np.random.Generator, device) -> Dict:
    """Synthetic whole-batch prompt inputs for `Model.prefill` (the static
    serving loop) — the JAX package's draw for the same rng."""
    _check_text(cfg)
    toks = rng.integers(0, cfg.vocab_size, (batch_size, prompt_len))
    return {"tokens": torch.from_numpy(toks.astype(np.int32)).to(device)}


def host_batch(toks: np.ndarray, device) -> Dict:
    """{"tokens": toks on `device`, "host_tokens": the same ids on the
    host}: a model whose embedding lies in host memory gathers its rows
    there without reading the ids back from the card (`models/rest.py`)."""
    host = torch.from_numpy(toks)
    return {"tokens": host.to(device), "host_tokens": host}


def decode_step_batch(cfg, toks, positions) -> Dict:
    """One-token decode-step inputs: toks [B,1] int tensor; positions [B]
    per-slot positions (a whole-batch loop passes a constant vector; token
    inputs do not read them)."""
    _check_text(cfg)
    return {"tokens": toks}


def static_batch_from_requests(cfg, reqs, device) -> Dict:
    """Whole-batch prefill inputs covering the same prompts as a request
    list: the static side of the engine-vs-static parity checks."""
    _check_text(cfg)
    toks = np.stack([np.asarray(r.prompt, np.int32) for r in reqs])
    return host_batch(toks, device)


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
    return host_batch(toks[None], device)


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
