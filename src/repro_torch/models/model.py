"""Public model API: `Model(cfg)` with init, forward and loss (dense and
Mamba-2 stacks), and for dense stacks the serve path's init_cache,
prefill, prefill_chunk, decode_step and decode_slots, over a nested dict
of tensors. `attn_impl` picks the whole-sequence attention: "naive",
"blockwise", or "pallas" — the flash-attention kernel (its plain version
on the CPU), the name the JAX package gives its Pallas kernel path.
`ssd_impl` picks Mamba-2's chunked scan: "ref" (the plain version, the
default as in the JAX package) or "pallas" — the SSD scan kernel (its
plain version on the CPU)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models import transformer as tr
from repro_torch.tree import tree_map
from repro_torch.models.layers import (apply_norm, cross_entropy,
                                       embed_defs, embed_tokens, lm_logits,
                                       norm_defs, tree_init, DTYPES)


class Model:
    def __init__(self, cfg: ModelConfig, *, attn_impl: str = "blockwise",
                 attn_chunk: int = 512, ssd_impl: str = "ref"):
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.attn_chunk = attn_chunk
        self.ssd_impl = ssd_impl

    # ---- params ----------------------------------------------------------
    def param_defs(self):
        cfg = self.cfg
        return {"embed": embed_defs(cfg),
                "decoder": tr.decoder_defs(cfg),
                "final_norm": norm_defs(cfg, cfg.d_model)}

    def init(self, seed: int, device):
        """Random params from a seeded torch Generator on `device` (torch and
        jax.random draw different numbers from one seed; tests copy params
        across with `repro_torch.convert.params_from_jax`)."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return tree_init(self.param_defs(), gen, device)

    def init_cache(self, batch: int, cache_len: int, device):
        return tree_map(
            lambda d: torch.zeros(d.shape, dtype=DTYPES[d.dtype], device=device),
            tr.cache_defs(self.cfg, batch, cache_len))

    # ---- context ---------------------------------------------------------
    def _ctx(self, seq: int, device, offset: int = 0):
        return {"attn_impl": self.attn_impl, "attn_chunk": self.attn_chunk,
                "ssd_impl": self.ssd_impl,
                "positions": torch.arange(seq, device=device)[None, :] + offset}

    # ---- train forward ----------------------------------------------------
    def forward(self, params, batch, *, policy=None, no_remat=False,
                grad_hooks=None, stream=None, stack_grads=None):
        """batch {"tokens" [B,S]} -> (logits [B,S,V], aux_loss f32 scalar).
        Each decoder layer is recomputed in the backward unless no_remat
        (`transformer.apply_decoder`). LMS: `policy`, an activation policy
        (`core/lms/policies.py`), and `stream`, a SwapSchedule whose params
        stream from pinned host memory (params["decoder"]["stack0"] then
        lies there), run the stack through the LMS executor, which writes
        the stack's grads into `stack_grads`. grad_hooks: per-stack-group
        DDL reduce-as-you-go hooks (the overlapped backward,
        `core/ddl/overlap.py`)."""
        cfg = self.cfg
        x = embed_tokens(cfg, params["embed"], batch["tokens"])
        ctx = self._ctx(x.shape[1], x.device)
        x, aux = tr.apply_decoder(cfg, params["decoder"], x, ctx,
                                  policy=policy, no_remat=no_remat,
                                  grad_hooks=grad_hooks, stream=stream,
                                  stack_grads=stack_grads)
        x = apply_norm(cfg, params["final_norm"], x)
        return lm_logits(cfg, params["embed"], x), aux

    def loss(self, params, batch, *, policy=None, no_remat=False,
             aux_weight: float = 0.01, grad_hooks=None, stream=None,
             stack_grads=None):
        """batch {"tokens", "labels" [B,S]}, label -1 ignored -> (mean token
        cross-entropy + aux_weight * aux, {"ce", "aux"})."""
        logits, aux = self.forward(params, batch, policy=policy,
                                   no_remat=no_remat, grad_hooks=grad_hooks,
                                   stream=stream, stack_grads=stack_grads)
        ce = cross_entropy(logits, batch["labels"])
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}

    # ---- serving ----------------------------------------------------------
    def prefill(self, params, batch, cache_len: Optional[int] = None):
        """-> (last-token logits [B,V], cache)."""
        cfg = self.cfg
        x = embed_tokens(cfg, params["embed"], batch["tokens"])
        seq = x.shape[1]
        ctx = self._ctx(seq, x.device)
        x, cache = tr.apply_decoder_prefill(cfg, params["decoder"], x, ctx,
                                            cache_len or seq)
        x = apply_norm(cfg, params["final_norm"], x)
        return lm_logits(cfg, params["embed"], x[:, -1:])[:, 0], cache

    def prefill_chunk(self, params, cache, batch, start: int, length: int):
        """One chunked-prefill step: the C-token chunk in `batch` at absolute
        positions [start, start+C) against the already populated cache,
        which is updated in place. `length` is the valid prompt tokens after
        this chunk. -> (chunk logits [B,C,V], cache)."""
        cfg = self.cfg
        x = embed_tokens(cfg, params["embed"], batch["tokens"])
        ctx = self._ctx(x.shape[1], x.device, offset=start)
        x, cache = tr.apply_decoder_prefill_chunk(
            cfg, params["decoder"], cache, x, start, length, ctx)
        x = apply_norm(cfg, params["final_norm"], x)
        return lm_logits(cfg, params["embed"], x), cache

    def decode_step(self, params, cache: Dict, batch, pos: int):
        """Whole-batch decode: batch {"tokens" [B,1]}, every row at position
        `pos`. The cache's k/v are updated in place and the same dict is
        returned. -> (logits [B,V], cache)."""
        cfg = self.cfg
        x = embed_tokens(cfg, params["embed"], batch["tokens"])
        ctx = {"positions": torch.full((1, 1), pos, device=x.device)}
        x, cache = tr.apply_decoder_decode(cfg, params["decoder"], cache, x,
                                           pos, ctx)
        x = apply_norm(cfg, params["final_norm"], x)
        return lm_logits(cfg, params["embed"], x)[:, 0], cache

    def decode_slots(self, params, cache: Dict, batch, positions, active,
                     page_size: Optional[int] = None):
        """Slot-batched decode: each batch row is an independent request.
        positions [B] int32, active [B] bool. With a top-level "page_table"
        leaf the cache is the page arena (and `page_size` its page length);
        without one it is slot-contiguous. The caches are updated in place
        and the same dict is returned. -> (logits [B,V], cache)."""
        cfg = self.cfg
        table = cache.get("page_table")
        if table is not None and page_size is None:
            raise ValueError("a paged cache needs page_size")
        x = embed_tokens(cfg, params["embed"], batch["tokens"])
        ctx = {"positions": positions[:, None], "page_table": table,
               "page_size": page_size}
        layers = {k: v for k, v in cache.items() if k != "page_table"}
        x, _ = tr.apply_decoder_decode_slots(cfg, params["decoder"], layers, x,
                                             positions, active, ctx)
        x = apply_norm(cfg, params["final_norm"], x)
        return lm_logits(cfg, params["embed"], x)[:, 0], cache
