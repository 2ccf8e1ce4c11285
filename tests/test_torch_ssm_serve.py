"""Mamba-2 serving on the port against the JAX package on the CPU, at the
smoke config of mamba2-1.3b (2 layers, d_model 64, 8 SSM heads of 16,
state 16, a convolution of 4, chunks of 16): the decode step, the
prefill's cache, Model.prefill and decode_step, the slot decode, the pool
with state leaves, the serve engine (resident, under a serve plan, through
a preemption) and the training step under an LMS plan.

Tolerances. In f32 (params and inputs, one layer at a time, so the
comparison is of the algorithm): 1e-5 of the largest |value| (matrix
products and the scan sum in other orders in XLA and torch), bitwise for
values that are only moved (the cached convolution inputs a decode step
shifts along).
In bf16 (the model's own dtype, through the whole model): random weights
at smoke width have near ties, so the port is fed the JAX run's tokens
(teacher forcing) and each logits row is held to 2**-5 of its largest
|logit| (4 bf16 ulps), and where the JAX row's top-1 / top-2 margin
exceeds twice that the port's own argmax must be JAX's token. The port's
runs against each other (streamed against resident, preempted against
undisturbed, the slot decode against the whole-batch decode): bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_ref import (jax_pricing, jax_ref,  # noqa: F401 (fixtures)
                                  jax_ref_scope, random_params)

from repro_torch import hw as thw
from repro_torch.config import base as tb
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.lms import offload as off, planner as tp
from repro_torch.kernels.ssd_scan.ref import ssd_decode_step_ref
from repro_torch.launch.serve import run_static
from repro_torch.models import ssm
from repro_torch.models import transformer as tr
from repro_torch.models.model import Model
from repro_torch.runtime.inject import FaultEvent, FaultInjector, FaultPlan
from repro_torch.serve import PagedKVPool, ServeEngine, synth_requests
from repro_torch.train import steps as tsteps
from repro_torch.tree import tree_leaves, tree_map

ARCH = "mamba2-1.3b"
# the served trace: prompts of 2 (under K - 1 = 3), 3, 16 (one chunk), 21
# and 40 (ragged chunks) tokens, 6 greedy tokens each, on 2 slots, so
# three requests wait on the host
PROMPTS, GEN, SLOTS, MAX_LEN = (2, 3, 16, 21, 40), 6, 2, 48
MESH = ((1, 1), ("data", "model"))
# a serve plan's budget that puts the params and the waiting requests'
# state on the host at smoke width
SERVE_BUDGET = 60_000


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def within_max(got, want, tol, what=""):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


def conv(obj, cls):
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})


@pytest.fixture(scope="module")
def ref():
    return jax_ref()


@pytest.fixture(scope="module")
def jm(ref):
    from repro import hw as jhw
    from repro.config import base as jbase
    from repro.core.lms import planner as jplan
    from repro.kernels.ssd_scan import ref as jsref
    from repro.models import ssm as jssm, transformer as jtr
    from repro.runtime import inject as jinject
    from repro.serve.kvpool import PagedKVPool as JPool
    return dict(hw=jhw, base=jbase, plan=jplan, sref=jsref, ssm=jssm, tr=jtr,
                inject=jinject, pool=JPool)


@pytest.fixture(scope="module")
def params(ref):
    cfg = get_smoke_config(ARCH)
    jparams, nparams = random_params(ref, ref.get_smoke_config(ARCH), seed=0)
    return cfg, jparams, nparams, params_from_jax(nparams, "cpu")


def _layer0_f32(nparams, conv_fn):
    """The first layer's params of the numpy tree, f32, through conv_fn."""
    def first(tree):
        return {k: first(v) if isinstance(v, dict) else conv_fn(f32(v)[0])
                for k, v in tree.items()}
    return first(nparams["decoder"]["stack0"]["ssd_0"])


# ---------------------------------------------------------------------------
# the decode step
# ---------------------------------------------------------------------------

def test_decode_step_ref_matches_jax_f32(jm):
    rng = np.random.default_rng(3)
    b, h, p, n, g = 3, 8, 16, 16, 2
    ins = (rng.standard_normal((b, h, p, n)), rng.standard_normal((b, h, p)),
           np.abs(rng.standard_normal((b, h))) * 0.3, -np.exp(rng.standard_normal(h)),
           rng.standard_normal((b, g, n)), rng.standard_normal((b, g, n)))
    ins = [a.astype(np.float32) for a in ins]
    y, hn = ssd_decode_step_ref(*map(torch.from_numpy, ins))
    jy, jh = jm["sref"].ssd_decode_step_ref(*ins)
    assert y.dtype == torch.float32 and hn.shape == (b, h, p, n)
    within_max(y, jy, 1e-5, "y")
    within_max(hn, jh, 1e-6, "h_new")


def test_decode_ssm_matches_jax_f32(ref, jm, params):
    """decode_ssm of one layer in f32 from a random cache: the output, the
    new state and the new row of convolution inputs within 1e-5, the rows
    shifted along bitwise; the cache given is not written. init_ssm_cache
    gives the JAX package's zero cache, a layer of Model.init_cache's."""
    cfg, _, nparams, _ = params
    jcfg = ref.get_smoke_config(ARCH)
    tp_ = _layer0_f32(nparams, torch.from_numpy)["ssm"]
    jp = _layer0_f32(nparams, ref.jnp.asarray)["ssm"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    hs, cs = ssm._cache_shapes(cfg, 3)
    cache = {"h": rng.standard_normal(hs).astype(np.float32),
             "conv": rng.standard_normal(cs).astype(np.float32)}
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    out, new = ssm.decode_ssm(cfg, tp_, torch.from_numpy(x), tcache)
    jout, jnew = jm["ssm"].decode_ssm(jcfg, jp, ref.jnp.asarray(x),
                                      {k: ref.jnp.asarray(v) for k, v in cache.items()})
    within_max(out, jout, 1e-5, "out")
    within_max(new["h"], jnew["h"], 1e-5, "h")
    within_max(new["conv"], jnew["conv"], 1e-5, "conv")
    assert np.array_equal(f32(new["conv"][:, :-1]), cache["conv"][:, 1:])
    assert all(np.array_equal(tcache[k].numpy(), cache[k]) for k in cache)
    # a zero cache: the JAX package's init_ssm_cache, and a layer of Model.init_cache
    zero, jzero = ssm.init_ssm_cache(cfg, 3, "cpu"), jm["ssm"].init_ssm_cache(jcfg, 3)
    layer = {k: v[0] for k, v in Model(cfg).init_cache(3, MAX_LEN, "cpu")["stack0"][
        "ssd_0"].items()}
    for k in ("h", "conv"):
        assert tuple(zero[k].shape) == tuple(jzero[k].shape) == tuple(layer[k].shape)
        assert str(zero[k].dtype).split(".")[-1] == str(jzero[k].dtype) == str(
            layer[k].dtype).split(".")[-1]
        assert not zero[k].any() and not layer[k].any()


# ---------------------------------------------------------------------------
# the prefill's cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [2, 3, 16, 40])
@pytest.mark.parametrize("ssd_impl", ["ref", "pallas"])
def test_prefill_cache_matches_jax_f32(ref, jm, params, length, ssd_impl):
    """One "ssd" layer's prefill in f32 against the JAX package's
    apply_layer_prefill: a prompt shorter than K - 1 = 3 (its convolution
    inputs zero-padded on the left), exactly K - 1, one whole chunk and
    two whole chunks and a ragged one. The layer output, the final state
    and the convolution inputs within 1e-5. ssd_impl="pallas"
    takes the scan's dispatch with the final state (its plain version on
    the CPU); the JAX prefill always takes the plain scan."""
    cfg, _, nparams, _ = params
    jcfg = ref.get_smoke_config(ARCH)
    x = np.random.default_rng(length).standard_normal((2, length, cfg.d_model)).astype(
        np.float32)
    tlp = _layer0_f32(nparams, torch.from_numpy)
    jlp = _layer0_f32(nparams, ref.jnp.asarray)
    got, cache = tr.apply_layer_prefill(cfg, "ssd", tlp, torch.from_numpy(x),
                                        {"ssd_impl": ssd_impl}, MAX_LEN)
    want, jcache, _ = jm["tr"].apply_layer_prefill(jcfg, "ssd", jlp, ref.jnp.asarray(x), {},
                                                   MAX_LEN)
    within_max(got, want, 1e-5, "x")
    within_max(cache["h"], jcache["h"], 1e-5, "h")
    assert cache["conv"].shape == (2, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
    within_max(cache["conv"], jcache["conv"], 1e-5, "conv")
    if length < cfg.ssm_conv - 1:
        assert not cache["conv"][:, :cfg.ssm_conv - 1 - length].any()


def test_prefill_writes_into_the_cache_it_is_given(params):
    """Model.prefill(out=) writes each layer's cache into the tree given
    (a static loop's host cache) and returns it: the same values
    as the cache it makes itself, bitwise."""
    cfg, _, _, tparams = params
    model = Model(cfg, ssd_impl="pallas")
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 21)))
    logits, cache = model.prefill(tparams, {"tokens": toks})
    out = model.init_cache(2, MAX_LEN, "cpu")
    logits2, cache2 = model.prefill(tparams, {"tokens": toks}, out=out)
    assert cache2 is out and torch.equal(logits, logits2)
    for a, b in zip(tree_leaves(cache), tree_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the model: prefill, decode steps, slot decode
# ---------------------------------------------------------------------------

def _jax_greedy(ref, jparams, toks, steps):
    """The JAX model's prefill then `steps` greedy decode steps. -> (tokens
    [B, steps + 1], logits rows [steps + 1, B, V])."""
    jm_ = ref.Model(ref.get_smoke_config(ARCH))
    logits, cache = jm_.prefill(jparams, {"tokens": ref.jnp.asarray(toks)})
    rows, out = [np.asarray(logits, np.float32)], [np.argmax(np.asarray(logits), -1)]
    for i in range(steps):
        batch = {"tokens": ref.jnp.asarray(out[-1][:, None].astype(np.int32))}
        logits, cache = jm_.decode_step(jparams, cache, batch, toks.shape[1] + i)
        rows.append(np.asarray(logits, np.float32))
        out.append(np.argmax(rows[-1], -1))
    return np.stack(out, 1), rows


def _forced_rows_ok(rows, want_rows):
    """Each row within 2**-5 of its largest |logit|; the argmax JAX's where
    its margin is wide. -> the count of wide rows."""
    wide = 0
    for got, want in zip(rows, want_rows):
        for g, w in zip(f32(got), want):
            tol = 2.0 ** -5 * np.abs(w).max()
            assert np.abs(g - w).max() <= tol
            top = np.sort(w)
            if top[-1] - top[-2] > 2 * tol:
                assert np.argmax(g) == np.argmax(w)
                wide += 1
    return wide


@pytest.mark.parametrize("length", [2, 21])
def test_prefill_and_decode_steps_match_jax(ref, params, length):
    """Model.prefill then 5 decode_steps (ssd_impl="pallas", the kernel's
    dispatch) teacher-forced with the JAX model's greedy tokens: every
    logits row within 2**-5 of its largest |logit|, the argmax JAX's where
    its margin is wide."""
    cfg, jparams, _, tparams = params
    toks = np.random.default_rng(length).integers(0, cfg.vocab_size, (3, length)).astype(
        np.int32)
    jtoks, jrows = _jax_greedy(ref, jparams, toks, 5)
    model = Model(cfg, ssd_impl="pallas")
    logits, cache = model.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    rows = [logits]
    for i in range(5):
        batch = {"tokens": torch.from_numpy(jtoks[:, i:i + 1])}
        logits, cache = model.decode_step(tparams, cache, batch, length + i)
        rows.append(logits)
    assert _forced_rows_ok(rows, jrows) > 0


def test_decode_slots_keeps_inactive_rows_state(ref, params):
    """decode_slots over 4 slots with rows 1 and 3 inactive: the active
    rows' logits and new state bitwise the whole-batch decode_step's over
    the same rows, the inactive rows' state bitwise as it was, their
    logits finite; the JAX package's decode_slots gives the active rows'
    logits within 2**-5 and keeps its inactive rows' state too."""
    cfg, jparams, _, tparams = params
    model = Model(cfg, ssd_impl="pallas")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (4, 21)).astype(np.int32)
    _, cache = model.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    before = tree_map(torch.clone, cache)
    step = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)
    pos = torch.full((4,), 21, dtype=torch.int32)
    active = torch.tensor([True, False, True, False])
    logits, got = model.decode_slots(tparams, cache, {"tokens": torch.from_numpy(step)},
                                     pos, active)
    assert got is cache and bool(torch.isfinite(logits).all())
    whole = tree_map(torch.clone, before)
    wlogits, whole = model.decode_step(tparams, whole, {"tokens": torch.from_numpy(step)}, 21)
    rows = active.nonzero()[:, 0]
    assert torch.equal(logits[rows], wlogits[rows])
    for a, b, w in zip(tree_leaves(cache), tree_leaves(before), tree_leaves(whole)):
        assert torch.equal(a[:, rows], w[:, rows])
        assert torch.equal(a[:, ~active], b[:, ~active])
    jmodel = ref.Model(ref.get_smoke_config(ARCH))
    _, jcache = jmodel.prefill(jparams, {"tokens": ref.jnp.asarray(toks)})
    jlogits, jnew = jmodel.decode_slots(jparams, jcache, {"tokens": ref.jnp.asarray(step)},
                                        ref.jnp.asarray(pos.numpy()),
                                        ref.jnp.asarray(active.numpy()))
    jl = np.asarray(jlogits, np.float32)
    for r in rows.tolist():
        assert np.abs(f32(logits[r]) - jl[r]).max() <= 2.0 ** -5 * np.abs(jl[r]).max()
    for k in ("h", "conv"):
        new, old = (np.asarray(t["stack0"]["ssd_0"][k], np.float32) for t in (jnew, jcache))
        assert np.array_equal(new[:, 1], old[:, 1]) and np.array_equal(new[:, 3], old[:, 3])


# ---------------------------------------------------------------------------
# the pool with state leaves
# ---------------------------------------------------------------------------

def _request_cache(cfg, seed):
    """A B = 1 request cache of random values, as a prefill makes it."""
    rng = np.random.default_rng(seed)
    defs = tr.cache_defs(cfg, 1, MAX_LEN)
    return tree_map(lambda d: torch.from_numpy(
        rng.standard_normal(d.shape).astype(np.float32)).to(
            torch.float32 if d.dtype == "float32" else torch.bfloat16), defs)


def _slot(pool, slot):
    return {k: v[:, slot] for k, v in pool.cache["stack0"]["ssd_0"].items()}


def _same(slot_state, req):
    return all(torch.equal(slot_state[k], req["stack0"]["ssd_0"][k][:, 0])
               for k in ("h", "conv"))


def test_pool_moves_state_leaves_whole(ref, jm, params):
    """PagedKVPool over a Mamba-2 stack: no page table, no pages; every
    request's state moves whole a slot at a time. spill -> prefetch ->
    attach, attach_fresh, preempt -> attach (no prefetch) and release:
    each slot's state bitwise the request's; a request of state alone is
    never staged (prefetch is a no-op: the device's room for state is the
    slots'; the JAX pool stages it, which moves no stat); `_swap_bytes`
    and the stats equal the JAX pool's for the same moves."""
    cfg, _, _, _ = params
    model = Model(cfg)
    pool = PagedKVPool(model, slots=2, max_len=MAX_LEN, page_size=4, device_pages=0,
                       host_pages=0, host_slots=3, device="cpu")
    jpool = jm["pool"](ref.Model(ref.get_smoke_config(ARCH)), slots=2, max_len=MAX_LEN,
                       page_size=4, device_pages=0, host_pages=0, host_slots=3)
    assert "page_table" not in pool.cache and not pool.has_paged
    assert pool.pages_needed(MAX_LEN) == jpool.pages_needed(MAX_LEN) == 0
    for n in (0, 3):
        for st in (True, False):
            assert pool._swap_bytes(n, st) == jpool._swap_bytes(n, st)
    reqs = [_request_cache(cfg, s) for s in range(4)]

    def jmoves(*moves):
        for name, *args in moves:
            getattr(jpool, name)(*args)

    pool.spill(0, reqs[0], 10, 0)
    assert not pool.prefetch(0) and pool.status(0) == "host"
    pool.attach(0, 1)
    assert _same(_slot(pool, 1), reqs[0])
    pool.attach_fresh(1, 0, reqs[1], 12, 0)
    assert _same(_slot(pool, 0), reqs[1])
    assert pool.preempt(1, 15) and pool.status(1) == "host"
    pool.attach(1, 0)
    assert _same(_slot(pool, 0), reqs[1])
    pool.release(0)
    pool.attach_fresh(2, 1, reqs[2], 9, 0)
    assert _same(_slot(pool, 1), reqs[2])
    pool.spill(3, reqs[3], 9, 0)
    pool.release(2)
    pool.attach(3, 1)
    assert _same(_slot(pool, 1), reqs[3])
    pool.release(1)
    pool.release(3)
    jreqs = [tree_map(lambda t: ref.jnp.asarray(t.float().numpy()).astype(
        ref.jnp.bfloat16 if t.dtype == torch.bfloat16 else ref.jnp.float32), r) for r in reqs]
    jmoves(("spill", 0, jreqs[0], 10, 0), ("prefetch", 0), ("attach", 0, 1),
           ("attach_fresh", 1, 0, jreqs[1], 12, 0), ("preempt", 1, 15), ("attach", 1, 0),
           ("release", 0), ("attach_fresh", 2, 1, jreqs[2], 9, 0), ("spill", 3, jreqs[3], 9, 0),
           ("release", 2), ("attach", 3, 1), ("release", 1), ("release", 3))
    assert pool.stats == jpool.stats
    assert pool._table == {} and sorted(pool._free_host_slots) == [0, 1, 2]


# ---------------------------------------------------------------------------
# the serve engine
# ---------------------------------------------------------------------------

def _requests(cfg, synth):
    rng = np.random.default_rng(1)
    reqs = []
    for i, plen in enumerate(PROMPTS):
        req = synth(cfg, 1, plen, GEN, rng)[0]
        req.rid = i
        reqs.append(req)
    return reqs


def plans(jm, ref, budget=SERVE_BUDGET):
    """(JAX plan, port plan) of the trace's serve shape on the port's H100
    spec, the same field by field."""
    jb = jm["base"]
    kw = dict(serve=True, slots=SLOTS, backlog_slots=len(PROMPTS), page_size=4)
    jp = jm["plan"].plan(jm["plan"].PlanRequest(
        cfg=ref.get_smoke_config(ARCH), shape=jb.ShapeConfig("serve", "decode", MAX_LEN, SLOTS),
        mesh=jb.MeshSpec(*MESH), lms=jb.LMSConfig(hbm_budget=budget),
        hw=conv(thw.H100_SXM, jm["hw"].HardwareSpec), **kw))
    tpl = tp.plan(tp.PlanRequest(
        cfg=get_smoke_config(ARCH), shape=tb.ShapeConfig("serve", "decode", MAX_LEN, SLOTS),
        mesh=tb.MeshSpec(*MESH), lms=tb.LMSConfig(hbm_budget=budget), hw=thw.H100_SXM, **kw))
    assert tpl.summary() == jp.summary()
    assert dataclasses.asdict(tpl.kv_paging) == dataclasses.asdict(jp.kv_paging)
    return jp, tpl


def _events(mod, events):
    return mod.FaultInjector(mod.FaultPlan([mod.FaultEvent(*e[:1], at=e[1], kind=e[2])
                                            for e in events]))


def _run_jax(ref, jm, jparams, plan=None, events=()):
    jcfg = ref.get_smoke_config(ARCH)
    inj = _events(jm["inject"], events) if events else None
    eng = ref.ServeEngine(ref.Model(jcfg), ref.mesh(), slots=SLOTS, max_len=MAX_LEN, plan=plan,
                          params=jparams, injector=inj)
    rows = {}
    select = eng._select

    def record(req, row):
        rows.setdefault(req.rid, []).append(np.array(row, np.float32))
        return select(req, row)
    eng._select = record
    toks = eng.run(_requests(jcfg, ref.synth_requests))
    return toks, rows, eng.metrics()


def _run_port(params, plan=None, events=(), forced=None):
    """The port's engine (ssd_impl="pallas"); forced: {rid: tokens} to
    feed. -> (tokens, rows, metrics, params swap bytes, requests)."""
    cfg = get_smoke_config(ARCH)
    inj = (FaultInjector(FaultPlan([FaultEvent(e[0], at=e[1], kind=e[2]) for e in events]))
           if events else None)
    eng = ServeEngine(Model(cfg, ssd_impl="pallas"), slots=SLOTS, max_len=MAX_LEN, plan=plan,
                      params=params, injector=inj, device="cpu")
    rows = {}
    select = eng._select

    def record(req, row):
        rows.setdefault(req.rid, []).append(row.copy())
        if forced is not None:
            return int(forced[req.rid][len(req.tokens)])
        return select(req, row)
    eng._select = record
    before = off.swap_counters()
    reqs = _requests(cfg, synth_requests)
    toks = eng.run(reqs)
    moved = off.swap_counters().get("lms.swap_in_bytes.params", 0) - before.get(
        "lms.swap_in_bytes.params", 0)
    assert all(r.status == "ok" for r in reqs)
    pool = eng.pool
    assert pool._table == {} and len(pool._free_host_slots) == pool_host_slots(eng)
    return toks, rows, eng.metrics(), moved, reqs


def pool_host_slots(eng):
    return eng.pool._host["stack0", "ssd_0", "h"].shape[0]


CASES = {"resident": (False, ()), "plan": (True, ()),
         "preempt": (False, [("engine.tick", 3, "preempt")])}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax_engine(jax_pricing, ref, jm, params, case):
    """The port's engine on the trace (prompts under K - 1, of one chunk
    and of ragged chunks; 2 slots, so three requests are prefilled into
    host slots and wait), teacher-forced with the JAX engine's tokens in
    the same case: every logits row within 2**-5, the argmax JAX's where
    the margin is wide, the pool's counts equal. Cases: resident; under
    the serve plan of SERVE_BUDGET (params and the waiting state on the
    host; the engine's geometry the JAX engine's); a forced preemption at
    tick 3 (the youngest slot's state spilled whole and requeued).
    Free-running, the port's run equals its resident run bitwise: tokens
    and rows (the plan streams the params, the preemption moves the state,
    neither changes the arithmetic), and under the plan the params' swap
    bytes are one sweep a prefill and a tick."""
    cfg, jparams, _, tparams = params
    planned, events = CASES[case]
    jp, tpl = plans(jm, ref) if planned else (None, None)
    if planned:
        assert tpl.residency == {"params": "host", "kvcache": "host"}
    jtoks, jrows, jmet = _run_jax(ref, jm, jparams, jp, events)
    placed = tsteps.place_params(tparams, tpl, "cpu") if planned else tparams
    toks, rows, met, _, _ = _run_port(placed, tpl, events, forced=jtoks)
    assert {k: v.tolist() for k, v in toks.items()} == {k: v.tolist() for k, v in jtoks.items()}
    wide = 0
    for rid, want in jrows.items():
        assert len(rows[rid]) == len(want) == GEN
        wide += _forced_rows_ok([r[None] for r in rows[rid]], [w[None] for w in want])
    assert wide > 0
    for key in ("ticks", "decode_tokens", "pool_spilled_requests", "pool_preempted_requests",
                "pool_spilled_pages", "pool_direct_pages"):
        assert met[key] == jmet[key], key
    assert met["pool_spilled_requests"] >= 3
    if events:
        assert met["pool_preempted_requests"] == 1
    own, own_rows, own_met, moved, reqs = _run_port(
        tsteps.place_params(tparams, tpl, "cpu") if planned else tparams, tpl, events)
    res, res_rows, _, res_moved, _ = _run_port(tparams)
    assert {k: v.tolist() for k, v in own.items()} == {k: v.tolist() for k, v in res.items()}
    assert all(np.array_equal(a, b) for rid in res_rows
               for a, b in zip(own_rows[rid], res_rows[rid]))
    assert res_moved == 0
    if planned:
        stack = off.tree_bytes(tparams["decoder"]["stack0"])
        rest = (off.tree_bytes(tparams["final_norm"])
                + off.tree_bytes(tparams["embed"]["lm_head"]))
        row = tparams["embed"]["embedding"].shape[1] * 4
        want = sum(stack + rest + row * r.prompt.size for r in reqs) + int(
            own_met["ticks"]) * (stack + rest + row * SLOTS)
        assert moved == want


def test_engine_geometry_under_the_serve_plan(jax_pricing, ref, jm, params):
    """The engine's geometry under the serve plan equals the JAX engine's:
    no pages, the plan's backlog of host slots, one request staged ahead."""
    cfg, jparams, _, tparams = params
    jp, tpl = plans(jm, ref)
    jeng = ref.ServeEngine(ref.Model(ref.get_smoke_config(ARCH)), ref.mesh(), slots=SLOTS,
                           max_len=MAX_LEN, plan=jp, params=jparams)
    teng = ServeEngine(Model(cfg), slots=SLOTS, max_len=MAX_LEN, plan=tpl,
                       params=tsteps.place_params(tparams, tpl, "cpu"), device="cpu")

    def geometry(eng, host_slots):
        pool = eng.pool
        return (pool.page_size, pool.device_pages, len(pool._free_host_pages), host_slots,
                eng._stage_depth, eng._chunk)
    assert geometry(teng, pool_host_slots(teng)) == geometry(
        jeng, jeng.pool._host["stack0", "ssd_0", "h"].shape[0])
    assert teng.pool.device_pages == 0 and pool_host_slots(teng) == len(PROMPTS)


def test_run_static_under_a_serve_plan_is_bitwise_resident(jax_pricing, jm, ref, params):
    """`run_static` (whole-batch prefill, then lockstep decode) on 4 prompts
    of 21 tokens: under the serve plan (params streamed, the cache emitted
    to the host a layer at a time by the prefill and streamed a layer at a
    time by each decode step) bitwise the resident loop's tokens; both
    equal the engine's greedy tokens for the same prompts (whole-prompt
    prefill and the slot decode take the same ops row by row)."""
    cfg, _, _, tparams = params
    _, tpl = plans(jm, ref)
    model = Model(cfg, ssd_impl="pallas")
    reqs = synth_requests(cfg, 4, 21, GEN, np.random.default_rng(2))
    _, want, _ = run_static(model, reqs, 21, GEN, params=tparams, device="cpu")
    before = off.swap_counters()
    _, got, _ = run_static(model, reqs, 21, GEN, params=tsteps.place_params(tparams, tpl, "cpu"),
                           device="cpu", plan=tpl)
    moved = {k: v - before.get(k, 0) for k, v in off.swap_counters().items()}
    assert np.array_equal(got, want)
    cache = off.tree_bytes(model.init_cache(4, 21 + GEN, "cpu"))
    assert moved["lms.swap_out_bytes.kvcache"] == GEN * cache
    assert moved["lms.swap_in_bytes.kvcache"] == (GEN - 1) * cache
    eng = ServeEngine(model, slots=4, max_len=21 + GEN, params=tparams, device="cpu")
    out = eng.run(synth_requests(cfg, 4, 21, GEN, np.random.default_rng(2)))
    assert np.array_equal(np.stack([out[i] for i in range(4)]), want)


# ---------------------------------------------------------------------------
# training under an LMS plan
# ---------------------------------------------------------------------------

def _tcfg(layers=2):
    cfg = dataclasses.replace(get_smoke_config(ARCH), num_layers=layers)
    return tb.TrainConfig(model=cfg, shape=tb.ShapeConfig("t", "train", 32, 2),
                          mesh=tb.MeshSpec(*MESH), lms=tb.LMSConfig(hbm_budget=300_000),
                          warmup_steps=1, learning_rate=1e-2, total_steps=10,
                          checkpoint_dir=None)


def test_lms_plan_and_step_of_the_mamba2_stack(jax_pricing, ref, jm):
    """The planner's plan for the Mamba-2 stack at 2 x 32 tokens under a
    300 kB budget equals the JAX package's field by field (params and the
    AdamW state on the host, `ssd_xz` and `ssd_state` among its classes);
    3 train steps under it (the stack streamed a layer at a time, the
    plan's policy in each layer's frame) equal the resident steps bitwise:
    every metric and every leaf of the state (params, mu, nu, masters);
    the params' swap bytes are what the sweeps copy."""
    from repro_torch.data import SyntheticTokens
    tcfg = _tcfg(layers=4)
    jb = jm["base"]
    jcfg = dataclasses.replace(ref.get_smoke_config(ARCH), num_layers=4)
    jreq = jm["plan"].PlanRequest(cfg=jcfg, shape=jb.ShapeConfig("t", "train", 32, 2),
                                  mesh=jb.MeshSpec(*MESH),
                                  lms=jb.LMSConfig(hbm_budget=300_000),
                                  hw=conv(thw.H100_SXM, jm["hw"].HardwareSpec))
    jp = jm["plan"].plan(jreq)
    plan = tp.plan(tp.PlanRequest(cfg=tcfg.model, shape=tcfg.shape, mesh=tcfg.mesh,
                                  lms=tcfg.lms, hw=thw.H100_SXM))
    assert plan.summary() == jp.summary()
    assert dict(plan.assignment) == dict(jp.assignment)
    assert plan.residency == jp.residency and plan.peak_bytes == jp.peak_bytes
    assert plan.residency["params"] == "host" and plan.residency["optimizer"] == "host"
    assert {"ssd_xz", "ssd_state"} <= set(plan.assignment)
    data = SyntheticTokens(tcfg.model.vocab_size, seed=3)
    batches = [{k: torch.from_numpy(v) for k, v in data.batch(i, 0, 1, 2, 32).items()}
               for i in range(3)]

    def run(p):
        model = Model(tcfg.model)
        state = tsteps.init_train_state(model, tcfg, 5, "cpu", plan=p)
        step = tsteps.build_train_step(model, tcfg, spec=tsteps.StepSpec(plan=p))
        before = off.swap_counters()
        mets = []
        for b in batches:
            state, m = step(state, b)
            mets.append({k: v.item() for k, v in m.items()})
        moved = off.swap_counters().get("lms.swap_in_bytes.params", 0) - before.get(
            "lms.swap_in_bytes.params", 0)
        o = state.opt
        leaves = [state.step, o.step] + [t for tree in (state.params, o.mu, o.nu, o.master)
                                         for t in tree_leaves(tree)]
        return mets, leaves, moved, state
    base, base_leaves, base_moved, _ = run(None)
    mets, leaves, moved, state = run(plan)
    assert mets == base
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(base_leaves, leaves))
    assert base_moved == 0
    # the stack twice a step (the forward and the backward's re-stream)
    assert moved >= 2 * 3 * off.tree_bytes(state.params["decoder"]["stack0"])


# ---------------------------------------------------------------------------
# the working sets the port's planner prices on top of the JAX package's
# ---------------------------------------------------------------------------

def _jax_priced(monkeypatch, req):
    with monkeypatch.context() as m:
        m.setattr(tp, "ssd_scan_work_bytes", lambda *a, **k: 0)
        m.setattr(tp, "whole_prefill_bytes", lambda *a, **k: 0)
        m.setattr(tp, "loss_work_bytes", lambda *a, **k: 0)
        return tp.plan(req)


def test_plan_prices_the_plain_scans_working_set(monkeypatch):
    """A Mamba-2 train plan (mamba2-1.3b, 4 layers, 2 x 2048 tokens, the
    plan of 2e9) prices SSD_SCAN_CHUNK_TERMS [b, nc, h, q, q] f32 chunk
    terms in place of 4 x its largest activation class: the same
    placement as without them, the peak larger by the difference; a stack
    without "ssd" layers prices none."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(ARCH), num_layers=4)
    shape, mesh = tb.ShapeConfig("t", "train", 2048, 2), tb.MeshSpec(*MESH)
    work = tp.ssd_scan_work_bytes(cfg, shape, mesh)
    assert work == tp.SSD_SCAN_CHUNK_TERMS * 2 * 8 * 64 * 256 * 256 * 4
    req = tp.PlanRequest(cfg=cfg, shape=shape, mesh=mesh, lms=tb.LMSConfig(hbm_budget=2 * 10**9),
                         hw=thw.H100_SXM)
    got, base = tp.plan(req), _jax_priced(monkeypatch, req)
    largest = max(a.bytes_dev for a in tp.activation_classes(cfg, shape, mesh))
    assert (got.assignment, got.residency) == (base.assignment, base.residency)
    assert got.residency["params"] == "host" and got.residency["optimizer"] == "host"
    assert got.peak_bytes - base.peak_bytes == work - 4 * largest > 0
    assert tp.ssd_scan_work_bytes(get_config("qwen2.5-14b"), shape, mesh) == 0


def test_serve_plan_prices_a_whole_prompt_prefill(monkeypatch):
    """A serve plan of a stack that is not all attention (mamba2-1.3b, 4
    slots of 1136 tokens, the plan of 1e9) prices two requests' B = 1
    caches and PREFILL_LAYER_CLASSES x the largest activation class of a
    1136-token prompt beside its slots: the peak larger by that less the
    decode tick's transient, the placement as without it; an all-attention
    stack prices none."""
    from repro_torch.configs import get_config
    cfg, mesh = get_config(ARCH), tb.MeshSpec(*MESH)
    shape = tb.ShapeConfig("serve", "decode", 1136, 4)
    one = dataclasses.replace(shape, global_batch=1)
    cache = off.tree_bytes(Model(cfg).init_cache(1, 1136, "meta"))
    largest = max(a.bytes_dev for a in tp.activation_classes(cfg, one, mesh))
    prefill = tp.whole_prefill_bytes(cfg, shape, mesh)
    assert prefill == 2 * cache + tp.PREFILL_LAYER_CLASSES * largest
    req = tp.PlanRequest(cfg=cfg, shape=shape, mesh=mesh, lms=tb.LMSConfig(hbm_budget=10**9),
                         hw=thw.H100_SXM, serve=True, slots=4, backlog_slots=8, page_size=16)
    got, base = tp.plan(req), _jax_priced(monkeypatch, req)
    tick = 3 * max(a.bytes_dev for a in tp.activation_classes(
        cfg, dataclasses.replace(shape, seq_len=1), mesh))
    assert got.residency == base.residency == {"params": "host", "kvcache": "host"}
    assert got.peak_bytes - base.peak_bytes == prefill - tick > 0
    assert tp.whole_prefill_bytes(get_config("qwen2.5-14b"), shape, mesh) == 0
