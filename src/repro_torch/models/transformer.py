"""Decoder stack for the "attn" (dense decoder) and "ssd" (Mamba-2) layer
kinds: stacked [L, ...] params and caches, with the JAX package's
`lax.scan` over layers as a Python loop over the leading axis. The
forward pass (train / loss) for both kinds; for "attn" also prefill,
chunked prefill, the whole-batch decode of the static loop, and the slot
decode of the serve engine (through the page arena, or over
slot-contiguous caches).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import paging
from repro_torch.core.lms.policies import tag, tagged
from repro_torch.models.attention import (attention_defs, decode_attention,
                                          out_proj, project_qkv)
from repro_torch.models.layers import (ParamDef, apply_mlp, apply_norm,
                                       apply_rope, mlp_defs, norm_defs)
from repro_torch.models.ssm import apply_ssm, ssm_defs
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# ---------------------------------------------------------------------------
# Stack layout
# ---------------------------------------------------------------------------

def _check_kinds(cfg: ModelConfig) -> str:
    """-> the stack's one layer kind, "attn" or "ssd"."""
    kinds = set(cfg.layer_kinds())
    if (kinds not in ({"attn"}, {"ssd"}) or cfg.num_experts
            or cfg.mrope_sections or cfg.frontend):
        raise NotImplementedError(
            f"{cfg.name}: only dense 'attn' and Mamba-2 'ssd' stacks are "
            f"ported yet (layer kinds {sorted(kinds)})")
    return kinds.pop()


def _check_serve(cfg: ModelConfig) -> None:
    """The serve paths run 'attn' stacks only: the caches (which every
    decode and chunked-prefill step takes) and the whole-prompt prefill
    check it."""
    if _check_kinds(cfg) != "attn":
        raise NotImplementedError(
            f"{cfg.name}: serving Mamba-2 ('ssd' layers: prefill with the "
            f"final states, decode_ssm, the SSM state caches) is not ported "
            f"yet; Model.forward and Model.loss are")


def _stack(defs, n: int):
    """Add a leading ("layers", n) axis to every ParamDef in a tree."""
    return tree_map(
        lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes,
                           init=d.init, scale=d.scale, dtype=d.dtype), defs)


def layer_defs(cfg: ModelConfig, kind: str):
    if kind == "attn":
        return {"ln1": norm_defs(cfg, cfg.d_model),
                "attn": attention_defs(cfg),
                "ln2": norm_defs(cfg, cfg.d_model),
                "ffn": mlp_defs(cfg)}
    if kind == "ssd":
        return {"ln1": norm_defs(cfg, cfg.d_model), "ssm": ssm_defs(cfg)}
    raise NotImplementedError(f"layer kind {kind!r} is not ported yet")


def decoder_defs(cfg: ModelConfig):
    kind = _check_kinds(cfg)
    return {"stack0": _stack({f"{kind}_0": layer_defs(cfg, kind)},
                             cfg.num_layers)}


def cache_defs(cfg: ModelConfig, batch: int, cache_len: int):
    _check_serve(cfg)
    kd = ParamDef((batch, cache_len, cfg.num_kv_heads, cfg.head_dim),
                  ("batch", "kv_seq", "kv_heads", None), init="zeros")
    return {"stack0": _stack({"attn_0": {"k": kd, "v": kd}}, cfg.num_layers)}


def _layer(tree, i: int):
    """Layer i of a stacked tree: views into the [L, ...] tensors, so an
    in-place write to a layer's cache lands in the stacked cache."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def dynamic_update_slice_(dst, src, starts):
    """In-place `jax.lax.dynamic_update_slice`: each start index is clamped
    to [0, dst_dim - src_dim] so the update always fits, as JAX clamps it
    (a torch slice assignment does not clamp)."""
    idx = []
    for s, n, m in zip(starts, src.shape, dst.shape):
        s = min(max(int(s), 0), m - n)
        idx.append(slice(s, s + n))
    dst[tuple(idx)] = src
    return dst


# ---------------------------------------------------------------------------
# Layer pieces
# ---------------------------------------------------------------------------

def _rope_qk(cfg, q, k, ctx):
    return (apply_rope(q, ctx["positions"], cfg.rope_theta),
            apply_rope(k, ctx["positions"], cfg.rope_theta))


def _ffn(cfg, p, x):
    h = tagged("mlp_norm", apply_norm, cfg, p["ln2"], x)
    return x + apply_mlp(cfg, p["ffn"], h)


def _attn_block(cfg, p, x, ctx):
    """A whole-sequence causal "attn" layer: -> (x, k, v). The forward
    pass and the prefill share it, so they run the same ops. The tags
    (`core/lms/policies.py`) are the JAX package's; outside an LMS layer
    frame they are the identity."""
    x = tag(x, "resid")
    h = tagged("attn_norm", apply_norm, cfg, p["ln1"], x)
    q, k, v = project_qkv(cfg, p["attn"], h)
    q, k = _rope_qk(cfg, q, k, ctx)
    o = tagged("attn_out", attn_mod.attention, q, k, v, causal=True,
               impl=ctx["attn_impl"], chunk=ctx["attn_chunk"])
    return _ffn(cfg, p, x + out_proj(cfg, p["attn"], o)), k, v


# ---------------------------------------------------------------------------
# Forward (train / loss)
# ---------------------------------------------------------------------------

def apply_layer(cfg, kind, p, x, ctx):
    """-> (x, aux_loss). ctx carries attn_impl / attn_chunk / positions for
    "attn" and ssd_impl for "ssd"."""
    if kind == "attn":
        return _attn_block(cfg, p, x, ctx)[0], 0.0
    if kind == "ssd":
        h = apply_norm(cfg, p["ln1"], x)
        y, _ = apply_ssm(cfg, p["ssm"], h, ssd_impl=ctx["ssd_impl"])
        return x + y, 0.0
    raise NotImplementedError(f"layer kind {kind!r} is not ported yet")


def _stream_depth(stream, n_iter: int) -> int:
    """Layers in flight for a stack: the schedule's prefetch depth, at most
    the layer count. (The JAX package's scan groups `depth` layers an
    iteration, so it falls back to 1 where the depth does not divide the
    layer count; the port's loop has no such grouping.)"""
    return min(max(int(getattr(stream, "prefetch_depth", 1)), 1), max(n_iter, 1))


class _LayerParams(torch.autograd.Function):
    """A layer's param leaves as its forward takes them (the device copy of
    a streamed layer, or views of the resident stack), with autograd
    attached: the backward hands each leaf's grad to `sink(i, grads)`,
    which writes it into the preallocated grads tree, so the stacked
    tensors themselves are never differentiated (autograd's select
    backward would fill a zero [L, ...] tensor per layer, on the host for
    a host-resident stack). `anchor`, the layer input, only ties the node
    into the graph; it gets no grad from here."""

    @staticmethod
    def forward(ctx, anchor, leaves, sink, i):
        ctx.sink, ctx.i = sink, i
        return tuple(t.detach() for t in leaves)

    @staticmethod
    def backward(ctx, *grads):
        ctx.sink(ctx.i, grads)
        return None, None, None, None


class _Boundary(torch.autograd.Function):
    """Identity on the residual stream at the input of layer i (i == L: the
    output of the last layer). Its backward runs when layer i's backward is
    done and before layer i-1's begins: `on_backward(i)` frees layer i's
    buffers and issues the copies of the next layers' params and offloaded
    activations, which then overlap layer i-1's backward."""

    @staticmethod
    def forward(ctx, x, on_backward, i):
        ctx.on_backward, ctx.i = on_backward, i
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.on_backward(ctx.i)
        return g, None, None


def _apply_decoder_lms(cfg, kind, stack, x, ctx, *, policy, stream, no_remat,
                       stack_grads):
    """The LMS executor of one stack (JAX `_scan_streamed` and the remat of
    its scan body under a plan's policy).

    stream: a SwapSchedule that streams params. The stacked params lie in
    pinned host memory; the forward copies layer i in (up to
    `prefetch_depth` layers ahead, so layer i+1's copy is in flight while
    layer i computes), and each layer's copy is freed after its forward:
    it is never a saved tensor (a saved param is a handle, and the layer's
    recompute boundary is fed the copy made again for the backward). The
    backward visits the layers in reverse, and the `_Boundary` at each
    layer's input issues the copies of the layers below it.

    policy: the activation policy (`core/lms/policies.py`), applied by a
    `LayerFrame` per layer; with a stream and no policy every activation is
    recomputed, as JAX's `jax.checkpoint(policy=None)`. no_remat: no
    recompute boundary (the policy is ignored, as in the JAX package).

    stack_grads: the stack's grads tree on the device, into which each
    layer's param grads are written in the backward."""
    from repro_torch.core.lms import offload as off
    from repro_torch.core.lms.policies import LayerFrame, Policy
    n = cfg.num_layers
    device = x.device
    key = f"{kind}_0"
    struct = _layer(stack, 0)
    grad_on = torch.is_grad_enabled()
    depth = _stream_depth(stream, n) if stream is not None else 1
    if stream is not None and policy is None:
        policy = Policy()
    frame_on = grad_on and not no_remat and policy is not None and not policy.everything
    resident = (set() if stream is not None else
                {t.untyped_storage().data_ptr() for t in tree_leaves(stack)})
    fwd, bwd, frames = {}, {}, {}

    def leaves_of(i):
        return tree_leaves(_layer(stack, i))

    def params_of(leaves):
        return tree_unflatten(struct, leaves)[key]

    def sink(i, grads):
        if stack_grads is None:
            raise ValueError("the backward of a stack under LMS writes its grads "
                             "into stack_grads: pass one")
        for dst, g in zip(tree_leaves(_layer(stack_grads, i)), grads):
            if g is not None:
                dst.copy_(g)

    def issue_bwd(j):
        if j < 0 or j in bwd:
            return
        if j in frames:
            frames[j].prefetch()
        bwd[j] = (off.stream_layer_to_device(_layer(stack, j), device, cls="params")
                  if stream is not None else None)

    def backward_leaves(i):
        issue_bwd(i)
        return tree_leaves(bwd[i].wait()) if stream is not None else leaves_of(i)

    def on_backward(i):
        if i < n:
            frame = frames.pop(i, None)
            if frame is not None:
                frame.release()
            bwd.pop(i, None)
        for j in range(i - 1, i - 1 - depth, -1):
            issue_bwd(j)

    aux = torch.zeros((), dtype=torch.float32, device=device)
    for i in range(n):
        if grad_on:
            x = _Boundary.apply(x, on_backward, i)
        if stream is not None:
            for j in range(i, min(i + depth, n)):
                if j not in fwd:
                    fwd[j] = off.stream_layer_to_device(_layer(stack, j), device,
                                                        cls="params")
            leaves = tree_leaves(fwd.pop(i).wait())
        else:
            leaves = leaves_of(i)
        if grad_on:
            leaves = _LayerParams.apply(x, leaves, sink, i)
        if not frame_on:
            x, da = apply_layer(cfg, kind, params_of(leaves), x, ctx)
        else:
            frame = LayerFrame(
                policy, device,
                replay=lambda h, lv: apply_layer(cfg, kind, params_of(lv), h, ctx),
                device_params=lambda i=i: backward_leaves(i),
                params_streamed=stream is not None)
            p = params_of(leaves)
            x, da = frame.forward(lambda h: apply_layer(cfg, kind, p, h, ctx), x,
                                  leaves, resident)
            frames[i] = frame
        aux = aux + da
    if grad_on:
        x = _Boundary.apply(x, on_backward, n)
    return x, aux


def apply_decoder(cfg, params, x, ctx, *, policy=None, no_remat=False,
                  grad_hooks=None, stream=None, stack_grads=None):
    """-> (x, aux_loss f32 scalar): every layer of the stack in order, their
    aux losses summed (0 for the dense and SSM layers).

    grad_hooks: {stack group name -> reduce-as-you-go hook}, the DDL
    overlapped backward (`core/ddl/overlap.py`): each layer's slice of the
    group's params goes through the hook before the layer runs, outside its
    checkpoint, so its grads are reduced once, as soon as the backward has
    them, and the recompute reruns no collective.

    Without a policy or a stream, each layer runs under
    `torch.utils.checkpoint` (non-reentrant) unless no_remat: its
    activations are dropped after the forward and recomputed in the
    backward, as the JAX package's `jax.checkpoint(body, policy=None)` of
    its layer scan does. The layers draw no random numbers, so no RNG
    state is kept for the recompute.

    policy (an LMS activation policy, `core/lms/policies.py`) and stream
    (a SwapSchedule that streams params from pinned host memory) run the
    stack through the LMS executor (`_apply_decoder_lms`), which writes
    the stack's param grads into `stack_grads` (a tree like
    params["stack0"] on the device) in the backward. LMS with grad_hooks
    (LMS + DDL) and the Mamba-2 stack under a policy or stream are not
    ported yet."""
    kind = _check_kinds(cfg)
    stack = params["stack0"]
    hook = (grad_hooks or {}).get("stack0")
    if policy is not None or stream is not None:
        if hook is not None:
            raise NotImplementedError(
                "LMS with the DDL overlapped backward (LMS + DDL) is not ported yet")
        if kind != "attn":
            raise NotImplementedError(
                f"the {kind!r} stack under an LMS policy or stream is not ported yet")
        return _apply_decoder_lms(cfg, kind, stack, x, ctx, policy=policy,
                                  stream=stream, no_remat=no_remat,
                                  stack_grads=stack_grads)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        lp = _layer(stack, i)
        if hook is not None:
            lp = hook(lp)
        p = lp[f"{kind}_0"]
        if no_remat:
            x, da = apply_layer(cfg, kind, p, x, ctx)
        else:
            x, da = checkpoint(apply_layer, cfg, kind, p, x, ctx,
                               use_reentrant=False, preserve_rng_state=False)
        aux = aux + da
    return x, aux


# ---------------------------------------------------------------------------
# Prefill (whole prompt)
# ---------------------------------------------------------------------------

def apply_layer_prefill(cfg, kind, p, x, ctx, cache_len: int):
    """-> (x, layer cache {"k","v"} [B, cache_len, K, D])."""
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    x2, k, v = _attn_block(cfg, p, x, ctx)
    b, s = x.shape[:2]
    n = min(s, cache_len)
    ck = torch.zeros((b, cache_len, cfg.num_kv_heads, cfg.head_dim),
                     dtype=k.dtype, device=k.device)
    cv = torch.zeros_like(ck)
    dynamic_update_slice_(ck, k[:, :n], (0, 0, 0, 0))
    dynamic_update_slice_(cv, v[:, :n], (0, 0, 0, 0))
    return x2, {"k": ck, "v": cv}


def apply_decoder_prefill(cfg, params, x, ctx, cache_len: int):
    """-> (x, stacked cache)."""
    _check_serve(cfg)
    stack = params["stack0"]
    layers = []
    for i in range(cfg.num_layers):
        x, c = apply_layer_prefill(cfg, "attn", _layer(stack, i)["attn_0"],
                                   x, ctx, cache_len)
        layers.append(c)
    cache = {"attn_0": {key: torch.stack([c[key] for c in layers])
                        for key in ("k", "v")}}
    return x, {"stack0": cache}


# ---------------------------------------------------------------------------
# Chunked prefill (serve engine: prompt processed in fixed-size chunks)
# ---------------------------------------------------------------------------

def apply_layer_prefill_chunk(cfg, kind, p, x, cache, start: int, length: int,
                              ctx):
    """One prompt chunk against an already partially populated cache.

    x [B,C,d] holds tokens [start, start+C) (tail rows may be padding);
    `length` is the valid token count after this chunk. The chunk's keys
    land in the cache (IN PLACE) at their absolute positions, then the chunk
    queries attend over the cache with the causal + kv_len masks — per
    valid query row exactly the whole-prompt softmax."""
    if kind != "attn":
        raise ValueError(
            f"chunked prefill supports 'attn' layers only, got {kind!r}")
    h = apply_norm(cfg, p["ln1"], x)
    q, k, v = project_qkv(cfg, p["attn"], h)
    q, k = _rope_qk(cfg, q, k, ctx)
    ck = dynamic_update_slice_(cache["k"], k, (0, start, 0, 0))
    cv = dynamic_update_slice_(cache["v"], v, (0, start, 0, 0))
    o = attn_mod.naive_attention(q, ck, cv, causal=True, q_offset=start,
                                 kv_len=length)
    x2 = _ffn(cfg, p, x + out_proj(cfg, p["attn"], o))
    return x2, {"k": ck, "v": cv}


def apply_decoder_prefill_chunk(cfg, params, caches, x, start: int,
                                length: int, ctx):
    """-> (x, caches): one chunk through every layer; each layer reads the
    earlier chunks' keys and appends its own to the stacked cache in place."""
    stack, cstack = params["stack0"], caches["stack0"]
    for i in range(cfg.num_layers):
        x, _ = apply_layer_prefill_chunk(
            cfg, "attn", _layer(stack, i)["attn_0"], x,
            _layer(cstack, i)["attn_0"], start, length, ctx)
    return x, caches


# ---------------------------------------------------------------------------
# Whole-batch decode (static loop: every row at the same position)
# ---------------------------------------------------------------------------

def apply_layer_decode(cfg, kind, p, x, cache, pos: int, ctx):
    """x [B,1,d], pos the position every row decodes at. The new token's
    k/v row is written into the cache IN PLACE at min(pos, Smax - 1), as
    JAX's dynamic_update_slice clamps it; -> (x, cache)."""
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    h = apply_norm(cfg, p["ln1"], x)
    q, k, v = project_qkv(cfg, p["attn"], h)
    q, k = _rope_qk(cfg, q, k, ctx)
    smax = cache["k"].shape[1]
    slot = min(pos, smax - 1)
    ck = dynamic_update_slice_(cache["k"], k, (0, slot, 0, 0))
    cv = dynamic_update_slice_(cache["v"], v, (0, slot, 0, 0))
    o = decode_attention(q, ck, cv, min(pos + 1, smax))
    x = _ffn(cfg, p, x + out_proj(cfg, p["attn"], o))
    return x, {"k": ck, "v": cv}


def apply_decoder_decode(cfg, params, caches, x, pos: int, ctx):
    """Whole-batch decode sweep: -> (x, caches), caches updated in place."""
    stack, cstack = params["stack0"], caches["stack0"]
    for i in range(cfg.num_layers):
        x, _ = apply_layer_decode(cfg, "attn", _layer(stack, i)["attn_0"], x,
                                  _layer(cstack, i)["attn_0"], pos, ctx)
    return x, caches


# ---------------------------------------------------------------------------
# Slot-batched decode (serve engine)
# ---------------------------------------------------------------------------

def _slot_write(cache_t, new_t, slots, active):
    """Per-slot cache write, IN PLACE: cache [B,S,...], new [B,1,...], slots
    [B] write positions, active [B] bool. Inactive rows keep their current
    value, so a freed slot's cache region stays byte-stable until its next
    occupant's pages are attached."""
    b = cache_t.shape[0]
    bidx = torch.arange(b, device=cache_t.device)
    slots = slots.long()
    cur = cache_t[bidx, slots]
    val = torch.where(active.reshape((b,) + (1,) * (cur.dim() - 1)),
                      new_t[:, 0].to(cache_t.dtype), cur)
    cache_t[bidx, slots] = val
    return cache_t


def apply_layer_decode_slots(cfg, kind, p, x, cache, positions, active, ctx):
    """Slot-batched decode of one layer: every batch row is an independent
    request at its own position. positions [B] int32, active [B] bool.

    With a page table in ctx the caches are the shared page arena and the
    new token's k/v row (int8 codes + scales under kv_dtype="int8") is
    written through the table; without one they are slot-contiguous
    [B,Smax,...] and the row lands at min(pos, Smax - 1) of its slot.
    Either write is IN PLACE, and inactive rows attend to nothing (kv_len
    0). Attention math is row-independent, so an active row's output is
    the whole-batch decode's at that row's position."""
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    table = ctx.get("page_table")
    h = apply_norm(cfg, p["ln1"], x)
    q, k, v = project_qkv(cfg, p["attn"], h)
    q, k = _rope_qk(cfg, q, k, ctx)
    if table is not None:
        ps = ctx["page_size"]
        cap = table.shape[1] * ps
    else:
        cap = cache["k"].shape[1]
    kv_len = torch.where(active, torch.clamp(positions + 1, max=cap),
                         torch.zeros_like(positions)).to(torch.int32)
    scales = {}
    if "k_scale" in cache:
        # int8 codes and scales quantized and written in one call (one
        # launch on the card), through the table or at min(pos, Smax - 1)
        scales = {"k_scale": cache["k_scale"], "v_scale": cache["v_scale"]}
        q_ops.quantize_kv_write(k, v, cache["k"], cache["v"], scales["k_scale"],
                                scales["v_scale"], table, positions, active)
    elif table is not None:
        paging.paged_write(cache["k"], k, table, positions, active, ps)
        paging.paged_write(cache["v"], v, table, positions, active, ps)
    else:
        slots = torch.clamp(positions, max=cap - 1)
        _slot_write(cache["k"], k, slots, active)
        _slot_write(cache["v"], v, slots, active)
    ck, cv = cache["k"], cache["v"]
    o = decode_attention(q.contiguous(), ck, cv, kv_len,
                         k_scale=scales.get("k_scale"),
                         v_scale=scales.get("v_scale"), page_table=table)
    x = _ffn(cfg, p, x + out_proj(cfg, p["attn"], o))
    return x, {"k": ck, "v": cv, **scales}


def apply_decoder_decode_slots(cfg, params, caches, x, positions, active, ctx):
    """Slot-batched decode sweep: -> (x, caches), caches updated in place."""
    stack, cstack = params["stack0"], caches["stack0"]
    for i in range(cfg.num_layers):
        x, _ = apply_layer_decode_slots(
            cfg, "attn", _layer(stack, i)["attn_0"], x,
            _layer(cstack, i)["attn_0"], positions, active, ctx)
    return x, caches
