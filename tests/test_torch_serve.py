"""The port's serve engine against the JAX engine on the CPU: the same
converted params and request trace (4 requests, 2 slots, page size 4,
chunk 4, a device page budget that makes two requests spill), for both KV
widths, on the smoke config of each dense decoder ported (qwen2.5-14b;
olmo-1b: MHA, LayerNorm without params, tied embeddings; starcoder2-7b:
LayerNorm with a bias, GELU with biases, G = 2; qwen2-72b: G = 4 at head
dim 8).

Random-init logits at smoke width have near ties in bf16, so the
comparison is teacher-forced: the port is fed the JAX engine's tokens, and
each step's logits row is held to 4 bf16 ulps of the row's largest |logit|
(2**-5 of it; see tests/test_torch_model.py for why). Where JAX's top-1 /
top-2 margin exceeds twice that tolerance — so no pair of errors within it
can swap them — the port's own argmax must agree.

The pool tests pin its page movement: a spilled request's pages come back
bitwise, through scrambled arena rows.

The static whole-batch loop (`run_static`: one prefill, then lockstep
decode over slot-contiguous caches) is greedy end to end, so it is held
token by token: against the JAX package's `run_static` on the same params
and prompts, and against the port's own engine (chunked prefill, paged
decode) — the engine-vs-static parity the JAX package tests. Two greedy
runs may part only where the JAX package's dense logits for their shared
context have a top-1 / top-2 margin within twice the logits tolerance (a
near tie either side may break); from there each follows its own context.
"""
import numpy as np
import pytest
import torch

from tests.test_torch_ref import (jax_ref, jax_ref_scope,  # noqa: F401 (autouse fixture)
                                  random_params, smoke_cfg)

from repro_torch.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.launch.serve import run_static
from repro_torch.serve import (PagedKVPool, ServeEngine, decode_step_batch,
                               static_batch_from_requests, synth_prompt_batch,
                               synth_requests)

SLOTS, MAX_LEN, PAGE, CHUNK = 2, 16, 4, 4
N_REQ, PROMPT, GEN = 4, 8, 8
DENSE_ARCHS = ("qwen2.5-14b", "olmo-1b", "starcoder2-7b", "qwen2-72b")


def _params(arch):
    ref = jax_ref()
    jparams, nparams = random_params(ref, ref.get_smoke_config(arch), seed=0)
    return ref, jparams, params_from_jax(nparams, "cpu")


@pytest.fixture(scope="module")
def params():
    return _params("qwen2.5-14b")


@pytest.fixture(scope="module")
def arch_params():
    """arch -> `params` of that dense smoke config, each made once."""
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = _params(arch)
        return made[arch]
    return get


def _arch_cases(values):
    """(arch, value) cases: qwen2.5-14b's under the value's own id, the
    other dense configs' as "<arch>-<value>"."""
    return ([pytest.param(DENSE_ARCHS[0], v, id=v) for v in values]
            + [pytest.param(a, v, id=f"{a}-{v}") for a in DENSE_ARCHS[1:] for v in values])


def _run_jax(ref, jparams, kv_dtype, arch):
    jcfg = ref.get_smoke_config(arch)
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


@pytest.mark.parametrize("arch,kv_dtype", _arch_cases(["model", "int8"]))
def test_engine_matches_jax_engine_teacher_forced(arch_params, arch, kv_dtype):
    from repro_torch.configs import get_smoke_config
    ref, jparams, tparams = arch_params(arch)
    jtoks, jrows, jmetrics = _run_jax(ref, jparams, kv_dtype, arch)
    cfg = get_smoke_config(arch)
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


@pytest.mark.parametrize("arch,kv_dtype", [pytest.param("qwen2.5-14b", "model", id="model"),
                                           pytest.param("qwen2.5-14b", "int8", id="int8"),
                                           pytest.param("olmo-1b", "int8", id="olmo-1b-int8"),
                                           pytest.param("starcoder2-7b", "int8",
                                                        id="starcoder2-7b-int8"),
                                           pytest.param("qwen2-72b", "model",
                                                        id="qwen2-72b-model")])
def test_launch_serve_on_cpu(capsys, arch, kv_dtype):
    from repro_torch.launch import serve as launch
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "4",
            "--slots", "2", "--prompt-len", "8", "--gen", "8", "--page-size", "4",
            "--prefill-chunk", "4", "--kv-dtype", kv_dtype]
    assert launch.main(argv) == 0
    out = capsys.readouterr().out
    assert "served 4 requests" in out and "pages spilled/returned 4/4" in out


def _parted_at_near_tie(ref, jparams, prompt, toks, step, arch="qwen2.5-14b"):
    """The JAX dense logits scoring token `step` of a greedy run (context:
    prompt + toks[:step]) have a top-2 margin within 2 * 2**-5 of their
    largest |logit|."""
    jm = ref.Model(ref.get_smoke_config(arch), attn_impl="naive")
    seq = np.concatenate([prompt, toks[:step]]).astype(np.int32)[None]
    jlog, _ = ref.jax.jit(jm.prefill)(jparams, {"tokens": ref.jnp.asarray(seq)})
    w = np.asarray(jlog, np.float32)[0]
    top = np.sort(w)
    return top[-1] - top[-2] <= 2 * 2.0 ** -5 * np.abs(w).max()


@pytest.mark.parametrize("arch,attn_impl", _arch_cases(["naive", "pallas"]))
def test_run_static_matches_jax_and_engine(arch_params, arch, attn_impl):
    """The port's run_static against the JAX run_static (same params and
    prompts, the JAX prefill with the same attn_impl, its Pallas path on
    the CPU taking its plain reference) and against the port's engine on
    the same requests: greedy tokens identical, or parted at a near tie."""
    from repro_torch.configs import get_smoke_config
    ref, jparams, tparams = arch_params(arch)
    jcfg = ref.get_smoke_config(arch)
    _, jtoks, _ = ref.launch_serve.run_static(
        ref.Model(jcfg, attn_impl=attn_impl), ref.mesh(),
        ref.synth_requests(jcfg, N_REQ, PROMPT, GEN, np.random.default_rng(4)),
        PROMPT, GEN, params=jparams)
    cfg = get_smoke_config(arch)
    reqs = synth_requests(cfg, N_REQ, PROMPT, GEN, np.random.default_rng(4))
    got_params, toks, t = run_static(Model(cfg, attn_impl=attn_impl), reqs, PROMPT, GEN,
                                     params=tparams, device="cpu")
    assert got_params is tparams
    assert toks.shape == (N_REQ, GEN) and toks.dtype == np.int32
    assert set(t) == {"prefill_s", "decode_s", "decode_tok_s"}
    eng = ServeEngine(Model(cfg, attn_impl="naive"), slots=SLOTS, max_len=MAX_LEN,
                      page_size=PAGE, prefill_chunk=CHUNK, params=tparams, device="cpu")
    out = eng.run(reqs)
    identical = 0
    for i, r in enumerate(reqs):
        for other in (np.asarray(jtoks)[i], out[r.rid]):
            parted = np.flatnonzero(toks[i] != np.asarray(other))
            if parted.size == 0:
                identical += 1
            else:
                assert _parted_at_near_tie(ref, jparams, r.prompt, toks[i], parted[0], arch), \
                    (i, parted[0], toks[i], other)
    assert identical >= N_REQ       # half the comparisons token for token


def test_static_batches_match_jax(params):
    """The static loop's batch helpers draw and stack as the JAX package's
    do; the vlm and audio families' embeds are not ported yet."""
    import dataclasses
    ref = params[0]
    from repro.serve import batching as jbatching
    jcfg = ref.get_smoke_config("qwen2.5-14b")
    cfg = smoke_cfg()
    got = synth_prompt_batch(cfg, 3, 5, np.random.default_rng(7), "cpu")["tokens"]
    want = jbatching.synth_prompt_batch(jcfg, 3, 5, np.random.default_rng(7))["tokens"]
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))
    reqs = synth_requests(cfg, 3, 5, 2, np.random.default_rng(8))
    jreqs = ref.synth_requests(jcfg, 3, 5, 2, np.random.default_rng(8))
    assert np.array_equal(static_batch_from_requests(cfg, reqs, "cpu")["tokens"].numpy(),
                          np.asarray(jbatching.static_batch_from_requests(jcfg, jreqs)["tokens"]))
    toks = torch.tensor([[1], [2], [3]])
    assert decode_step_batch(cfg, toks, np.full((3,), 5, np.int32))["tokens"] is toks
    for family in ("vlm", "audio"):
        other = dataclasses.replace(cfg, family=family)
        with pytest.raises(NotImplementedError, match="not ported yet"):
            synth_prompt_batch(other, 3, 5, np.random.default_rng(7), "cpu")
        with pytest.raises(NotImplementedError, match="not ported yet"):
            static_batch_from_requests(other, reqs, "cpu")
        with pytest.raises(NotImplementedError, match="not ported yet"):
            decode_step_batch(other, toks, None)


def test_launch_serve_static_on_cpu(capsys):
    from repro_torch.launch import serve as launch
    argv = ["--arch", "qwen2.5-14b", "--smoke", "--device", "cpu", "--requests", "3",
            "--prompt-len", "8", "--gen", "6", "--static"]
    assert launch.main(argv) == 0
    out = capsys.readouterr().out
    assert "prefill:" in out and "decode:" in out and "tok/s" in out
    assert "generated token ids (first row)" in out


@pytest.mark.parametrize("flag", [["--temperature", "0.7"], ["--top-k", "5"],
                                  ["--kv-dtype", "int8"]])
def test_launch_serve_static_rejects_engine_flags(capsys, flag):
    from repro_torch.launch import serve as launch
    with pytest.raises(SystemExit) as e:
        launch.main(["--arch", "qwen2.5-14b", "--smoke", "--device", "cpu", "--static"] + flag)
    assert e.value.code == 2
    assert "--static" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the int8 decode step's cache write: one fused call a layer
# ---------------------------------------------------------------------------

def _kv_write_case(paged: bool, seed: int = 7):
    """Rows of k and v (bf16, a NaN in one), int8 caches with arbitrary
    contents, a scrambled table, positions (4 starts page 1, 11 ends page 2;
    11 and 9 lie past Smax = 6 of the slot-contiguous caches) and an
    inactive slot."""
    rng = np.random.default_rng(seed)
    b, kh, d = 4, 2, 16
    ps, max_pages = (4, 3) if paged else (6, 1)
    pages = b * max_pages + 1 if paged else b
    k, v = (torch.from_numpy(rng.standard_normal((b, 1, kh, d)).astype(np.float32)).bfloat16()
            for _ in range(2))
    k[0, 0, 1, 3] = float("nan")
    caches = [torch.from_numpy(rng.integers(-127, 128, (pages, ps, kh, d)).astype(np.int8))
              for _ in range(2)]
    caches += [torch.from_numpy(rng.uniform(0, 1, (pages, ps, kh)).astype(np.float32))
               for _ in range(2)]
    table = (torch.from_numpy(rng.permutation(pages - 1)[:b * max_pages]
                              .reshape(b, max_pages).astype(np.int32)) if paged else None)
    positions = torch.tensor([4, 11, 0, 9], dtype=torch.int32)
    active = torch.tensor([True, True, False, True])
    return k, v, caches, table, positions, active


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_quantize_kv_write_plain_matches_jax(paged):
    """The fused write's plain version against the JAX decode step's
    composition, jitted: `quantize_kv_leaf` of k and v, then the four
    writes of codes and scales through `paging.paged_write` (arena) or
    `transformer._slot_write` at min(pos, Smax - 1) (slot-contiguous, with
    positions past Smax). Bitwise: codes and scales, every cache byte,
    inactive slots included, and a row holding a NaN."""
    ref = jax_ref()
    jax, jnp = ref.jax, ref.jnp
    from repro.models import transformer as jtr
    k, v, caches, table, positions, active = _kv_write_case(paged)
    ps = caches[0].shape[1]

    def jax_write(k, v, kc, vc, ks, vs, table, positions, active):
        kq, kss = ref.kvquant.quantize_kv_leaf(k)
        vq, vss = ref.kvquant.quantize_kv_leaf(v)
        if paged:
            def write(cache, new):
                return ref.paging.paged_write(cache, new, table, positions, active, ps)
        else:
            slots = jnp.minimum(positions, ps - 1)

            def write(cache, new):
                return jtr._slot_write(cache, new, slots, active)
        return write(kc, kq), write(vc, vq), write(ks, kss), write(vs, vss)
    want = jax.jit(jax_write)(
        jnp.asarray(k.float().numpy(), jnp.bfloat16), jnp.asarray(v.float().numpy(), jnp.bfloat16),
        *(jnp.asarray(c.numpy()) for c in caches),
        None if table is None else jnp.asarray(table.numpy()),
        jnp.asarray(positions.numpy()), jnp.asarray(active.numpy()))
    got = [c.clone() for c in caches]
    from repro_torch.kernels.quantize import quantize_kv_write_ref
    quantize_kv_write_ref(k, v, *got, table, positions, active)
    for g, w, c in zip(got, want, caches):
        w = np.asarray(w)
        assert g.dtype == c.dtype and g.shape == c.shape
        assert np.array_equal(g.numpy().view(np.uint8), w.view(np.uint8))
    assert not torch.equal(got[0], caches[0])


def _quantize_routes(monkeypatch):
    """Route the int8 entries of CPU tensors as on the card, through the
    plain versions standing in for the kernels; launch counts reset."""
    from tests.test_torch_kernels import _QuantizeExtension
    from repro_torch.kernels import _build
    from repro_torch.kernels.quantize import ops as q_ops
    ext = _QuantizeExtension()
    monkeypatch.setattr(_build, "extension", lambda: ext)
    monkeypatch.setattr(q_ops, "on_cpu", lambda *tensors: False)
    for launcher in (q_ops.quantize_cuda, q_ops.quantize_kv_write_cuda,
                     q_ops.dequantize_cuda, q_ops.dequantize_sum_rows_cuda):
        monkeypatch.setattr(launcher, "launches", 0)
    return ext, q_ops


def test_int8_engine_writes_each_layer_tick_in_one_launch(params, monkeypatch):
    """The int8 engine with its quantize entries routed as on the card: the
    decode step makes one `quantize_kv_write` launch a layer a tick and no
    `quantize_rows` launch; `quantize_rows` runs only at the pool's boundary,
    once for k and once for v of each request's prefill cache. The tokens
    are the plain run's."""
    _, _, tparams = params
    cfg = smoke_cfg()

    def run():
        eng = ServeEngine(Model(cfg, attn_impl="naive"), slots=SLOTS, max_len=MAX_LEN,
                          page_size=PAGE, prefill_chunk=CHUNK, params=tparams,
                          kv_dtype="int8", device="cpu")
        out = eng.run(synth_requests(cfg, N_REQ, PROMPT, GEN, np.random.default_rng(1)))
        return {rid: t.tolist() for rid, t in out.items()}, eng.metrics()
    plain, _ = run()
    ext, q_ops = _quantize_routes(monkeypatch)
    routed, m = run()
    assert routed == plain
    layer_ticks = cfg.num_layers * int(m["ticks"])
    assert q_ops.quantize_kv_write_cuda.launches == layer_ticks > 0
    assert q_ops.quantize_cuda.launches == 2 * N_REQ
    assert [e[0] for e in ext.launches].count("quantize_kv_write") == layer_ticks
    assert q_ops.dequantize_cuda.launches == q_ops.dequantize_sum_rows_cuda.launches == 0


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_int8_slot_decode_step_makes_one_write_call_a_layer(params, monkeypatch, paged):
    """`Model.decode_slots` on int8 caches, paged and slot-contiguous: one
    `quantize_kv_write` call a layer and no `quantize_rows` call, leaving the
    caches and logits of the plain step bitwise."""
    _, _, tparams = params
    cfg = smoke_cfg()
    kh, d = cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(4)
    b, ps, max_pages = 3, PAGE, MAX_LEN // PAGE
    pages = b * max_pages + 1 if paged else b
    seq = ps if paged else MAX_LEN
    kv = {key: torch.from_numpy(rng.standard_normal((cfg.num_layers, pages, seq, kh, d))
                                .astype(np.float32)).bfloat16() for key in ("k", "v")}
    from repro_torch.models import kvquant
    layer = kvquant.quantize_cache_tree(kv)
    positions = torch.tensor([5, 0, MAX_LEN - 1], dtype=torch.int32)
    active = torch.tensor([True, False, True])
    toks = {"tokens": torch.tensor([[3], [0], [200]])}

    def step():
        cache = {"stack0": {"attn_0": {key: t.clone() for key, t in layer.items()}}}
        if paged:
            cache["page_table"] = torch.from_numpy(
                np.random.default_rng(5).permutation(pages - 1)[:b * max_pages]
                .reshape(b, max_pages).astype(np.int32))
        logits, _ = Model(cfg).decode_slots(tparams, cache, toks, positions, active,
                                            page_size=ps if paged else None)
        return logits, cache["stack0"]["attn_0"]
    want_logits, want = step()
    ext, q_ops = _quantize_routes(monkeypatch)
    got_logits, got = step()
    assert [e[0] for e in ext.launches] == ["quantize_kv_write"] * cfg.num_layers
    assert q_ops.quantize_kv_write_cuda.launches == cfg.num_layers
    assert q_ops.quantize_cuda.launches == 0
    assert torch.equal(got_logits, want_logits)
    assert all(torch.equal(got[key], want[key]) for key in want)
    assert not torch.equal(got["k"], layer["k"])
