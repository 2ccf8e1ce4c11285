"""The port's serve engine against the JAX engine on the CPU: the same
converted params and request trace (4 requests, 2 slots, page size 4,
chunk 4, a device page budget that makes two requests spill), for both KV
widths.

Random-init logits at smoke width have near ties in bf16, so the
comparison is teacher-forced: the port is fed the JAX engine's tokens, and
each step's logits row is held to 4 bf16 ulps of the row's largest |logit|
(2**-5 of it; see tests/test_torch_model.py for why). Where JAX's top-1 /
top-2 margin exceeds twice that tolerance — so no pair of errors within it
can swap them — the port's own argmax must agree.

The pool tests pin its page movement: a spilled request's pages come back
bitwise, through scrambled arena rows.
"""
import numpy as np
import pytest
import torch

from tests.test_torch_ref import (jax_ref, jax_ref_scope,  # noqa: F401 (autouse fixture)
                                  random_params, smoke_cfg)

from repro_torch.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serve import PagedKVPool, ServeEngine, synth_requests

SLOTS, MAX_LEN, PAGE, CHUNK = 2, 16, 4, 4
N_REQ, PROMPT, GEN = 4, 8, 8


@pytest.fixture(scope="module")
def params():
    ref = jax_ref()
    jparams, nparams = random_params(ref, ref.get_smoke_config("qwen2.5-14b"), seed=0)
    return ref, jparams, params_from_jax(nparams, "cpu")


def _run_jax(ref, jparams, kv_dtype):
    jcfg = ref.get_smoke_config("qwen2.5-14b")
    eng = ref.ServeEngine(ref.Model(jcfg, attn_impl="naive"), ref.mesh(),
                          slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
                          prefill_chunk=CHUNK, params=jparams, kv_dtype=kv_dtype)
    rows = {}
    select = eng._select

    def record(req, row):
        rows.setdefault(req.rid, []).append(np.array(row, np.float32))
        return select(req, row)
    eng._select = record
    toks = eng.run(ref.synth_requests(jcfg, N_REQ, PROMPT, GEN,
                                      np.random.default_rng(1)))
    return toks, rows, eng.metrics()


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_engine_matches_jax_engine_teacher_forced(params, kv_dtype):
    ref, jparams, tparams = params
    jtoks, jrows, jmetrics = _run_jax(ref, jparams, kv_dtype)
    cfg = smoke_cfg()
    eng = ServeEngine(Model(cfg, attn_impl="naive"), slots=SLOTS, max_len=MAX_LEN,
                      page_size=PAGE, prefill_chunk=CHUNK, params=tparams,
                      kv_dtype=kv_dtype, device="cpu")
    rows, own = {}, {}

    def forced(req, row):
        rows.setdefault(req.rid, []).append(row.copy())
        own.setdefault(req.rid, []).append(int(np.argmax(row)))
        return int(jtoks[req.rid][len(req.tokens)])
    eng._select = forced
    reqs = synth_requests(cfg, N_REQ, PROMPT, GEN, np.random.default_rng(1))
    out = eng.run(reqs)

    assert all(r.status == "ok" for r in reqs)
    assert {rid: t.tolist() for rid, t in out.items()} == \
        {rid: t.tolist() for rid, t in jtoks.items()}
    checked = 0
    for rid, want_rows in jrows.items():
        assert len(rows[rid]) == len(want_rows) == GEN
        for step, (got, want) in enumerate(zip(rows[rid], want_rows)):
            tol = 2.0 ** -5 * np.abs(want).max()
            err = np.abs(got - want).max()
            assert err <= tol, (rid, step, err, tol)
            top = np.sort(want)
            if top[-1] - top[-2] > 2 * tol:
                assert own[rid][step] == int(np.argmax(want)), (rid, step)
                checked += 1
    assert checked > 0
    m = eng.metrics()
    assert set(m) == set(jmetrics)
    assert m["pool_spilled_pages"] > 0
    assert m["pool_fetched_pages"] + m["pool_prefetched_pages"] == m["pool_spilled_pages"]
    for key in ("ticks", "decode_tokens", "pool_spilled_pages", "pool_prefetched_pages",
                "pool_fetched_pages", "pool_direct_pages", "pool_peak_resident_pages"):
        assert m[key] == jmetrics[key], key


def test_engine_greedy_is_deterministic_and_rejects_unservable(params):
    _, _, tparams = params
    cfg = smoke_cfg()

    def run():
        eng = ServeEngine(Model(cfg, attn_impl="naive"), slots=SLOTS,
                          max_len=MAX_LEN, page_size=PAGE, prefill_chunk=CHUNK,
                          params=tparams, device="cpu")
        reqs = synth_requests(cfg, N_REQ, PROMPT, GEN, np.random.default_rng(2))
        too_long = synth_requests(cfg, 1, PROMPT + GEN, 1, np.random.default_rng(3))[0]
        too_long.rid = 99
        too_long.max_new = GEN
        out = eng.run(reqs + [too_long])
        assert too_long.status == "rejected"
        return {rid: t.tolist() for rid, t in out.items() if rid != 99}
    assert run() == run()


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_pool_spill_prefetch_attach_round_trip(kv_dtype):
    """spill -> prefetch -> attach puts the request's pages in the arena rows
    its table row names, bitwise (int8: the codes and scales the pool
    quantized at its boundary); release frees them."""
    cfg = smoke_cfg()
    model = Model(cfg)
    pool = PagedKVPool(model, slots=2, max_len=MAX_LEN, page_size=PAGE,
                       device_pages=6, host_pages=8, device="cpu",
                       kv_dtype=kv_dtype)
    gen = torch.Generator().manual_seed(0)
    req = model.init_cache(1, MAX_LEN, "cpu")
    for leaf in req["stack0"]["attn_0"].values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    want = pool._ingest(req)["stack0"]["attn_0"]
    # scramble the free list first: a fresh request then a release
    pool.attach_fresh(7, 0, req, length=5, reserve_pages=3)
    pool.release(7)
    pool.spill(1, req, length=6, reserve_pages=4)      # 2 content pages
    assert pool.status(1) == "host" and pool.stats["spilled_pages"] == 2
    assert pool.prefetch(1) and pool.status(1) == "staged"
    pool.attach(1, 1)
    assert pool.status(1) == "dev"
    table = pool.cache["page_table"]
    ids = table[1].tolist()
    # the whole reservation is mapped; the other slot stays on the null page
    assert len(set(ids)) == 4 and pool.null_page not in ids
    assert table[0].tolist() == [pool.null_page] * 4
    arena = pool.cache["stack0"]["attn_0"]
    for key, w in want.items():
        got = torch.cat([arena[key][:, p] for p in ids[:2]], dim=1)
        assert torch.equal(got, w[:, 0, :2 * PAGE]), key
    pool.release(1)
    assert sorted(pool._free_dev) == list(range(6))
    assert pool.stats["prefetched_pages"] == 2 and pool.stats["fetched_pages"] == 0


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_launch_serve_on_cpu(capsys, kv_dtype):
    from repro_torch.launch import serve as launch
    argv = ["--arch", "qwen2.5-14b", "--smoke", "--device", "cpu", "--requests", "4",
            "--slots", "2", "--prompt-len", "8", "--gen", "8", "--page-size", "4",
            "--prefill-chunk", "4", "--kv-dtype", kv_dtype]
    assert launch.main(argv) == 0
    out = capsys.readouterr().out
    assert "served 4 requests" in out and "pages spilled/returned 4/4" in out
