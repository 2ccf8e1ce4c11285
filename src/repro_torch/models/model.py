"""Public model API: `Model(cfg)` with init, forward and loss, and the
serve path's init_cache, prefill, decode_step and decode_slots (dense and
Mamba-2 stacks; prefill_chunk for dense ones), over a nested dict of
tensors. `attn_impl` picks the whole-sequence attention: "naive",
"blockwise", or "pallas" — the flash-attention kernel (its plain version
on the CPU), the name the JAX package gives its Pallas kernel path.
`ssd_impl` picks Mamba-2's chunked scan: "ref" (the plain version, the
default as in the JAX package) or "pallas" — the SSD scan kernel (its
plain version on the CPU).

Every pass takes `stream=`, the SwapSchedule of a plan: where it streams
params, the stack and the unstacked rest lie in pinned host memory, the
stack comes in a layer at a time and the rest as `models/rest.py` reads
it; the static loop's decode also streams a host-resident KV cache.

Every serve pass takes `mesh=` too: on a tensor-parallel mesh the params
and the cache are this rank's blocks (`init(mesh=)`, `init_cache(mesh=)`),
the embedding is the vocab-parallel lookup, and the logits leave the pass
whole, [B, V] (or [B, C, V]) bitwise the same on every rank, this rank's
vocab columns all-gathered over `model` (`sharding.gather_from_model`),
as the JAX package's serve steps hand them out replicated."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models import rest
from repro_torch.models import sharding as shd
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

    def param_specs(self, mesh=None):
        """Each leaf's spec on `mesh` (`models/sharding.py`), a tree like
        `param_defs()`."""
        return shd.spec_tree(self.param_defs(), mesh)

    def local_param_defs(self, mesh=None):
        """`param_defs()` with this rank's block shapes on a
        tensor-parallel `mesh` (the global ones without one)."""
        return shd.local_defs(self.param_defs(), mesh)

    def init(self, seed: int, device, mesh=None):
        """Random params from a seeded torch Generator on `device` (torch and
        jax.random draw different numbers from one seed; tests copy params
        across with `repro_torch.convert.params_from_jax`). On a
        tensor-parallel `mesh` this rank's blocks of the one-device draws."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return tree_init(self.param_defs(), gen, device, mesh)

    def init_cache(self, batch: int, cache_len: int, device, mesh=None):
        """A zero serve cache; this rank's `kv_heads` block on a
        tensor-parallel `mesh`."""
        return tree_map(
            lambda d: torch.zeros(d.shape, dtype=DTYPES[d.dtype], device=device),
            tr.cache_defs(self.cfg, batch, cache_len, mesh))

    # ---- context ---------------------------------------------------------
    def _ctx(self, seq: int, device, offset: int = 0, mesh=None):
        return {"attn_impl": self.attn_impl, "attn_chunk": self.attn_chunk,
                "ssd_impl": self.ssd_impl, "mesh": shd.tp(mesh),
                "positions": torch.arange(seq, device=device)[None, :] + offset}

    # ---- the unstacked rest ----------------------------------------------
    def _embed(self, params, batch, stream, sink=None, mesh=None):
        """The batch's token embeddings; with the table on the host its
        rows are gathered at batch["host_tokens"] where the batch carries
        the ids on the host too (`serve/batching.py`)."""
        if rest.on_host(stream):
            return rest.embed(self.cfg, params["embed"], batch["tokens"], sink,
                              batch.get("host_tokens"), mesh=mesh)
        return embed_tokens(self.cfg, params["embed"], batch["tokens"], mesh)

    def _final_norm(self, params, x, stream, sink=None):
        if rest.on_host(stream):
            return rest.final_norm(self.cfg, params["final_norm"], x, sink)
        return apply_norm(self.cfg, params["final_norm"], x)

    def _logits(self, params, x, stream, sink=None, mesh=None):
        if rest.on_host(stream):
            return rest.logits(self.cfg, params["embed"], x,
                               rest.window(self.cfg, stream), sink, mesh=mesh)
        return lm_logits(self.cfg, params["embed"], x, mesh)

    # ---- train forward ----------------------------------------------------
    def forward(self, params, batch, *, policy=None, no_remat=False,
                grad_hooks=None, stream=None, stack_grads=None, rest_sink=None,
                mesh=None):
        """batch {"tokens" [B,S]} -> (logits [B,S,V], aux_loss f32 scalar).
        Each decoder layer is recomputed in the backward unless no_remat
        (`transformer.apply_decoder`). LMS: `policy`, an activation policy
        (`core/lms/policies.py`), and `stream`, a SwapSchedule whose params
        stream from pinned host memory (params["decoder"]["stack0"] then
        lies there), run the stack through the LMS executor, which writes
        the stack's grads into `stack_grads`. grad_hooks: per-stack-group
        DDL reduce-as-you-go hooks (the overlapped backward,
        `core/ddl/overlap.py`). With the rest in host memory (a stream
        that streams params) its grads are not autograd's: the backward
        hands each leaf's to `rest_sink(path, grad)` (`models/rest.py`).
        mesh: with a `model` axis above 1, tensor parallelism: `params` are
        this rank's blocks (`init(mesh=)`, `convert.params_from_jax(mesh=)`)
        and the logits this rank's vocab columns [B,S,V/|model|]."""
        cfg = self.cfg
        mesh = shd.tp(mesh)
        x = self._embed(params, batch, stream, rest_sink, mesh)
        ctx = self._ctx(x.shape[1], x.device, mesh=mesh)
        x, aux = tr.apply_decoder(cfg, params["decoder"], x, ctx,
                                  policy=policy, no_remat=no_remat,
                                  grad_hooks=grad_hooks, stream=stream,
                                  stack_grads=stack_grads)
        x = self._final_norm(params, x, stream, rest_sink)
        return self._logits(params, x, stream, rest_sink, mesh), aux

    def loss(self, params, batch, *, policy=None, no_remat=False,
             aux_weight: float = 0.01, grad_hooks=None, stream=None,
             stack_grads=None, rest_sink=None, mesh=None):
        """batch {"tokens", "labels" [B,S]}, label -1 ignored -> (mean token
        cross-entropy + aux_weight * aux, {"ce", "aux"}); on a
        tensor-parallel `mesh` the cross-entropy over the whole vocabulary
        from this rank's columns (`layers.cross_entropy`), the same on
        every `model` rank."""
        logits, aux = self.forward(params, batch, policy=policy,
                                   no_remat=no_remat, grad_hooks=grad_hooks,
                                   stream=stream, stack_grads=stack_grads,
                                   rest_sink=rest_sink, mesh=mesh)
        ce = cross_entropy(logits, batch["labels"], mesh=shd.tp(mesh))
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}

    # ---- serving ----------------------------------------------------------
    def _serve_logits(self, params, x, stream, mesh):
        """The logits a serve pass hands out: whole on every rank."""
        return shd.gather_from_model(self._logits(params, x, stream, mesh=mesh), mesh)

    def prefill(self, params, batch, cache_len: Optional[int] = None, stream=None,
                out=None, swap_out: bool = False, mesh=None):
        """-> (last-token logits [B,V], cache). out: the cache tree to write
        into, a layer at a time (swap_out: a plan's host cache, each layer
        copied out as a kvcache swap); see `transformer.apply_decoder_prefill`."""
        cfg = self.cfg
        mesh = shd.tp(mesh)
        x = self._embed(params, batch, stream, mesh=mesh)
        seq = x.shape[1]
        ctx = self._ctx(seq, x.device, mesh=mesh)
        x, cache = tr.apply_decoder_prefill(cfg, params["decoder"], x, ctx,
                                            cache_len or seq, stream=stream, out=out,
                                            swap_out=swap_out)
        x = self._final_norm(params, x, stream)
        return self._serve_logits(params, x[:, -1:], stream, mesh)[:, 0], cache

    def prefill_chunk(self, params, cache, batch, start: int, length: int,
                      stream=None, mesh=None):
        """One chunked-prefill step: the C-token chunk in `batch` at absolute
        positions [start, start+C) against the already populated cache,
        which is updated in place. `length` is the valid prompt tokens after
        this chunk. -> (chunk logits [B,C,V], cache)."""
        cfg = self.cfg
        mesh = shd.tp(mesh)
        x = self._embed(params, batch, stream, mesh=mesh)
        ctx = self._ctx(x.shape[1], x.device, offset=start, mesh=mesh)
        x, cache = tr.apply_decoder_prefill_chunk(
            cfg, params["decoder"], cache, x, start, length, ctx, stream=stream)
        x = self._final_norm(params, x, stream)
        return self._serve_logits(params, x, stream, mesh), cache

    def decode_step(self, params, cache: Dict, batch, pos: int, stream=None, mesh=None):
        """Whole-batch decode: batch {"tokens" [B,1]}, every row at position
        `pos`. The cache's k/v are updated in place and the same dict is
        returned. -> (logits [B,V], cache)."""
        cfg = self.cfg
        mesh = shd.tp(mesh)
        x = self._embed(params, batch, stream, mesh=mesh)
        ctx = {"positions": torch.full((1, 1), pos, device=x.device), "mesh": mesh}
        x, cache = tr.apply_decoder_decode(cfg, params["decoder"], cache, x,
                                           pos, ctx, stream=stream)
        x = self._final_norm(params, x, stream)
        return self._serve_logits(params, x, stream, mesh)[:, 0], cache

    def decode_slots(self, params, cache: Dict, batch, positions, active,
                     page_size: Optional[int] = None, stream=None, mesh=None):
        """Slot-batched decode: each batch row is an independent request.
        positions [B] int32, active [B] bool. With a top-level "page_table"
        leaf the cache is the page arena (and `page_size` its page length);
        without one it is slot-contiguous. The caches are updated in place
        and the same dict is returned. -> (logits [B,V], cache)."""
        cfg = self.cfg
        table = cache.get("page_table")
        if table is not None and page_size is None:
            raise ValueError("a paged cache needs page_size")
        mesh = shd.tp(mesh)
        x = self._embed(params, batch, stream, mesh=mesh)
        ctx = {"positions": positions[:, None], "page_table": table,
               "page_size": page_size, "mesh": mesh}
        layers = {k: v for k, v in cache.items() if k != "page_table"}
        x, _ = tr.apply_decoder_decode_slots(cfg, params["decoder"], layers, x,
                                             positions, active, ctx, stream=stream)
        x = self._final_norm(params, x, stream)
        return self._serve_logits(params, x, stream, mesh)[:, 0], cache

