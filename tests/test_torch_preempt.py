"""Spill-and-requeue preemption and the fault injector in the port's serve
engine, against the JAX engine on the CPU: the chaos drills of the JAX
package's tests/test_fault_inject.py (transient pool exhaustion, the
injected mid-decode preemption, a tick fault, seeded chaos) and a
deadline-risk preemption, each run on both sides from one converted set
of params (olmo-1b's smoke config, 5 requests of 8 + 8 tokens, 2 slots,
page size 4, chunk 4) under one fault plan.

Each drill holds the port to the JAX engine's statuses and pool counters
exactly and, teacher-forced with the JAX engine's tokens, every logits
row to test_torch_serve.py's bound (2**-5 of the row's largest |logit|);
and the port's own greedy tokens under the faults to its undisturbed
run's, bitwise, for every request that ends "ok" (a preempted request
resumes bitwise).
"""

import numpy as np
import pytest

from tests.test_torch_ref import (jax_ref, jax_ref_scope,  # noqa: F401 (autouse fixture)
                                  random_params)

from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.runtime import inject as tinject
from repro_torch.serve import ServeEngine, synth_requests

ARCH = "olmo-1b"
N_REQ, PROMPT, GEN = 5, 8, 8
TOTAL = PROMPT + GEN
SLOTS, PAGE, CHUNK = 2, 4, 4
POOL_KEYS = ("spilled_pages", "fetched_pages", "prefetched_pages", "direct_pages",
             "preempted_requests", "preempted_pages", "injected_exhaustions",
             "peak_resident_pages")


@pytest.fixture(scope="module")
def setup():
    ref = jax_ref()
    from repro.runtime import inject as jinject
    jparams, nparams = random_params(ref, ref.get_smoke_config(ARCH), seed=0)
    return ref, jinject, jparams, params_from_jax(nparams, "cpu")


def _requests(cfg, synth):
    return synth(cfg, N_REQ, PROMPT, GEN, np.random.default_rng(7))


def _plan(mod, events):
    return mod.FaultInjector(mod.FaultPlan([mod.FaultEvent(*e[:2], **e[2]) for e in events]))


def _jax_run(setup, events=(), plan=None, edit=None, **kw):
    ref, jinject, jparams, _ = setup
    cfg = ref.get_smoke_config(ARCH)
    inj = jinject.FaultInjector(plan) if plan is not None else _plan(jinject, events)
    eng = ref.ServeEngine(ref.Model(cfg, attn_impl="naive"), ref.mesh(), slots=SLOTS,
                          max_len=TOTAL, page_size=PAGE, prefill_chunk=CHUNK, params=jparams,
                          injector=inj, **kw)
    rows = {}
    select = eng._select

    def record(req, row):
        rows.setdefault(req.rid, []).append(np.array(row, np.float32))
        return select(req, row)
    eng._select = record
    reqs = _requests(cfg, ref.synth_requests)
    if edit is not None:
        edit(eng, reqs)
    toks = eng.run(reqs)
    return toks, rows, eng


def _port_run(setup, events=(), plan=None, forced=None, edit=None, **kw):
    tparams = setup[3]
    cfg = get_smoke_config(ARCH)
    inj = tinject.FaultInjector(plan) if plan is not None else _plan(tinject, events)
    eng = ServeEngine(Model(cfg, attn_impl="naive"), slots=SLOTS, max_len=TOTAL,
                      page_size=PAGE, prefill_chunk=CHUNK, params=tparams, injector=inj,
                      device="cpu", **kw)
    rows = {}
    select = eng._select

    def record(req, row):
        rows.setdefault(req.rid, []).append(row.copy())
        if forced is not None:
            return int(forced[req.rid][len(req.tokens)])
        return select(req, row)
    eng._select = record
    reqs = _requests(cfg, synth_requests)
    if edit is not None:
        edit(eng, reqs)
    toks = eng.run(reqs)
    return toks, rows, eng


def _statuses(eng):
    return {r.rid: r.status for r in eng._last_run}


def _drill(setup, events=(), plan=None, edit=None, **kw):
    """Both sides under one fault plan: -> (JAX engine, port engine of the
    free-running port run, its tokens, the undisturbed port run's
    tokens), after holding statuses, pool counters and metrics to JAX's,
    the teacher-forced rows to the bound, and the ok requests' tokens to
    the undisturbed run's."""
    jtoks, jrows, jeng = _jax_run(setup, events, plan, edit, **kw)
    ftoks, frows, feng = _port_run(setup, events, plan, forced=jtoks, edit=edit, **kw)
    assert _statuses(feng) == _statuses(jeng)
    assert {k: v.tolist() for k, v in ftoks.items()} == {k: v.tolist() for k, v in jtoks.items()}
    for rid, want_rows in jrows.items():
        assert len(frows.get(rid, [])) == len(want_rows)
        for got, want in zip(frows[rid], want_rows):
            assert np.abs(got - want).max() <= 2.0 ** -5 * np.abs(want).max()
    for key in POOL_KEYS:
        assert feng.pool.stats[key] == jeng.pool.stats[key], key
    fm, jm = feng.metrics(), jeng.metrics()
    for key in ("ok", "failed", "rejected", "preempted", "ticks", "decode_tokens"):
        assert fm[key] == jm[key], key
    toks, _, eng = _port_run(setup, events, plan, edit=edit, **kw)
    base, _, _ = _port_run(setup)
    for r in eng._last_run:
        if r.status == "ok":
            assert np.array_equal(toks[r.rid], base[r.rid]), r.rid
    return jeng, eng


def test_transient_pool_exhaustion_survives(setup):
    """An "exhaust" at pool.reserve for three admission checks: the engine
    retries, nobody fails, the trace serves as undisturbed."""
    jeng, eng = _drill(setup, [("pool.reserve", 0, dict(kind="exhaust", times=3))])
    assert eng.pool.stats["injected_exhaustions"] >= 3
    assert eng.metrics()["ok"] == N_REQ


def test_injected_preemption_token_parity(setup):
    """A forced preemption at the third tick: the youngest slot's pages
    spill to the host arena, it re-queues with its tokens and resumes
    bitwise; the page accounting holds across the round trip."""
    jeng, eng = _drill(setup, [("engine.tick", 2, dict(kind="preempt"))])
    m = eng.metrics()
    assert m["preempted"] >= 1 and eng.pool.stats["preempted_requests"] >= 1
    assert m["ok"] == N_REQ
    preempted = [r for r in eng._last_run if r.preemptions > 0]
    assert preempted and all(r.status == "ok" for r in preempted)
    st = eng.pool.stats
    assert st["fetched_pages"] + st["prefetched_pages"] == st["spilled_pages"]


def test_tick_fault_fails_active_batch_only(setup):
    """A tick crash fails exactly the requests in the batch (their partial
    tokens kept); run() does not raise and the queue serves."""
    jeng, eng = _drill(setup, [("engine.tick", 1, {})])
    st = _statuses(eng)
    failed = [rid for rid, s in st.items() if s == "failed"]
    assert len(failed) == SLOTS
    assert all(len(r.tokens) < GEN for r in eng._last_run if r.rid in failed)
    m = eng.metrics()
    assert m["failed"] == SLOTS and m["ok"] == N_REQ - SLOTS


@pytest.mark.parametrize("seed", [1234, 7, 99])
def test_seeded_chaos_keeps_engine_invariants(setup, seed):
    """A sampled plan over the tick and pool sites (one seed samples the
    same plan in both packages): every request terminal, non-ok ones with
    a reason, the pool leaks nothing, and both engines agree."""
    plan = tinject.FaultPlan.sample(seed, sites=("engine.tick", "pool.reserve", "pool.spill"),
                                    n=4, horizon=8)
    jplan = setup[1].FaultPlan.sample(seed, sites=("engine.tick", "pool.reserve", "pool.spill"),
                                      n=4, horizon=8)
    assert [(e.site, e.at, e.kind, e.times) for e in plan.events] == \
        [(e.site, e.at, e.kind, e.times) for e in jplan.events]
    _, eng = _drill(setup, plan=plan, stall_rounds=16)
    assert len(eng._last_run) == N_REQ
    for r in eng._last_run:
        assert r.terminal
        if r.status != "ok":
            assert r.error
    pool = eng.pool
    assert pool._table == {} and pool._resident == 0
    assert len(pool._free_dev) == pool.device_pages
    assert eng.scheduler.served_total == N_REQ


def test_deadline_risk_preemption_picks_jax_victim(setup):
    """A request with a deadline at the head of the queue while both slots
    are busy, with `_est_remaining` stubbed on both sides to say it is at
    risk (and `_shed_doomed` off, so it is not shed instead): the engine
    preempts the youngest active slot, the same request as the JAX
    engine, which resumes bitwise."""
    victims = {}

    def edit(eng, reqs):
        side = "jax" if not hasattr(eng, "device") else "port"
        reqs[2].deadline_s = 1e6
        eng._est_remaining = lambda req: 1e9 if req.deadline_s is not None else None
        eng._shed_doomed = lambda now: None
        preempt = eng._preempt_slot

        def spy(slot):
            victims.setdefault(side, []).append(eng.scheduler.active[slot].rid)
            return preempt(slot)
        eng._preempt_slot = spy
    victims.clear()
    jeng, eng = _drill(setup, edit=edit)
    assert victims["jax"] and victims["port"][:len(victims["jax"])] == victims["jax"]
    assert eng.metrics()["preempted"] == jeng.metrics()["preempted"] >= 1
    assert eng.metrics()["ok"] == N_REQ
