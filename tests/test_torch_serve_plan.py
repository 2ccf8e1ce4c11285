"""Serving under an LMS serve plan on the CPU, the port against the JAX
package: the same serve plan on both sides (`plan(PlanRequest(serve=True,
...))` on the port's H100 spec, which the JAX planner takes field by
field), the same converted params and request trace as
tests/test_torch_serve.py (4 requests of 8 + 8 tokens, 2 slots, page
size 4, chunk 4).

Plans at smoke width (qwen2.5-14b), by HBM budget: "params" (100 kB) puts
the params and the KV backlog on the host, so every prefill chunk and
decode tick streams the stack and the rest in; "kv" (260 kB) keeps the
params on the device and pages the KV backlog; "calibrated" is "kv"
priced from tests/fixtures/obs_report.json.

Tolerances: the engine's geometry equals the JAX engine's exactly; the
teacher-forced logits rows are held to test_torch_serve.py's bound (2**-5
of the row's largest |logit|, 4 bf16 ulps); the port's streamed runs
equal its resident runs bitwise (streaming copies the params, it does not
change the arithmetic), and the params' swap bytes equal the count of
what a sweep moves exactly.
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from tests.test_torch_ref import (jax_ref, jax_ref_scope,  # noqa: F401 (autouse fixture)
                                  random_params)

from repro_torch import hw as thw
from repro_torch.config import base as tb
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, serve_params_from_jax
from repro_torch.core.lms import offload as off
from repro_torch.core.lms import planner as tp
from repro_torch.launch.serve import run_static
from repro_torch.models.model import Model
from repro_torch.serve import ServeEngine, synth_requests
from repro_torch.train import steps as tsteps
from repro_torch.tree import tree_leaves

ARCH = "qwen2.5-14b"
SLOTS, MAX_LEN, PAGE, CHUNK = 2, 16, 4, 4
N_REQ, PROMPT, GEN = 4, 8, 8
BACKLOG = 6
MESH = ((1, 1), ("data", "model"))
REPORT = str(pathlib.Path(__file__).parent / "fixtures" / "obs_report.json")
CASES = {"params": (100_000, None), "kv": (260_000, None), "calibrated": (260_000, REPORT)}


def conv(obj, cls):
    """A frozen dataclass as the other package's class of the same fields."""
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})


@pytest.fixture(scope="module")
def ref():
    return jax_ref()


@pytest.fixture(scope="module")
def jm(ref):
    from repro import hw as jhw
    from repro.config import base as jbase
    from repro.core.lms import planner as jplan
    from repro.runtime import inject as jinject
    return dict(hw=jhw, base=jbase, plan=jplan, inject=jinject)


@pytest.fixture(scope="module")
def params(ref):
    jparams, nparams = random_params(ref, ref.get_smoke_config(ARCH), seed=0)
    return jparams, nparams, params_from_jax(nparams, "cpu")


def plans(jm, ref, case, kv_dtype, arch=ARCH):
    """(JAX plan, port plan) of one case, on the port's H100 spec."""
    budget, profile = CASES[case]
    jb = jm["base"]
    kw = dict(serve=True, slots=SLOTS, backlog_slots=BACKLOG, page_size=PAGE, kv_dtype=kv_dtype)
    jp = jm["plan"].plan(jm["plan"].PlanRequest(
        cfg=ref.get_smoke_config(arch), shape=jb.ShapeConfig("serve", "decode", MAX_LEN, SLOTS),
        mesh=jb.MeshSpec(*MESH), lms=jb.LMSConfig(hbm_budget=budget),
        hw=conv(thw.H100_SXM, jm["hw"].HardwareSpec), **kw), profile=profile)
    tpl = tp.plan(tp.PlanRequest(
        cfg=get_smoke_config(arch), shape=tb.ShapeConfig("serve", "decode", MAX_LEN, SLOTS),
        mesh=tb.MeshSpec(*MESH), lms=tb.LMSConfig(hbm_budget=budget), hw=thw.H100_SXM, **kw),
        profile=profile)
    assert tpl.summary() == jp.summary()
    return jp, tpl


def _geometry(eng):
    pool = eng.pool
    return (pool.page_size, pool.device_pages, len(pool._free_host_pages),
            len(pool._free_host_slots), eng._stage_depth)


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("case", list(CASES))
def test_engine_geometry_matches_jax_under_a_serve_plan(jm, ref, params, case, kv_dtype):
    """page_size, device_pages, host_pages, host_slots and the staging depth
    the engine takes from the plan equal the JAX engine's; the KV width
    resolves from the plan when no kv_dtype is given."""
    jparams, _, tparams = params
    jp, tpl = plans(jm, ref, case, kv_dtype)
    assert tpl.residency == jp.residency and tpl.kv_paging is not None
    assert tpl.residency["params"] == ("host" if case == "params" else "device")
    assert tpl.calibrated == (case == "calibrated")
    jeng = ref.ServeEngine(ref.Model(ref.get_smoke_config(ARCH), attn_impl="naive"), ref.mesh(),
                           slots=SLOTS, max_len=MAX_LEN, plan=jp, prefill_chunk=CHUNK,
                           params=jparams)
    teng = ServeEngine(Model(get_smoke_config(ARCH), attn_impl="naive"), slots=SLOTS,
                       max_len=MAX_LEN, plan=tpl, prefill_chunk=CHUNK,
                       params=tsteps.place_params(tparams, tpl, "cpu"), device="cpu")
    assert _geometry(teng) == _geometry(jeng)
    assert teng.kv_dtype == jeng.kv_dtype == kv_dtype


def test_serve_plan_requires_paging_executor():
    """JAX tests/test_serve_engine.py::test_serve_plan_requires_paging_executor
    on the port's planner (olmo-1b, 4096 x 16 slots under 4 GiB, the
    port's H100 spec): the KV backlog goes to the host with the paged pool
    declared; the same residency without the pool is refused."""
    from repro_torch.configs import get_config
    cfg = get_config("olmo-1b")
    shape = tb.ShapeConfig("serve", "decode", 4096, 16)
    plan = tp.plan_serve_memory(cfg, shape, tb.MeshSpec(*MESH),
                                tb.LMSConfig(hbm_budget=4 * 1024 ** 3), thw.H100_SXM,
                                slots=16, backlog_slots=32)
    assert plan.residency["kvcache"] == "host"
    assert plan.kv_paging is not None and plan.kv_paging.device_pages > 0
    assert plan.swap_schedule is not None and plan.swap_schedule.streams_kvcache
    assert plan.swap_schedule.bytes_for("kvcache") > 0
    with pytest.raises(AssertionError, match="paged-pool executor"):
        tp.check_schedule_invariant(plan.residency, plan.swap_schedule, serve=True,
                                    kv_paging=None)
    tp.check_schedule_invariant(plan.residency, plan.swap_schedule, serve=True,
                                kv_paging=plan.kv_paging)
    tp.check_schedule_invariant(plan.residency, plan.swap_schedule)


def _requests(cfg):
    return synth_requests(cfg, N_REQ, PROMPT, GEN, np.random.default_rng(1))


def _run_jax(ref, jparams, plan):
    jcfg = ref.get_smoke_config(ARCH)
    eng = ref.ServeEngine(ref.Model(jcfg, attn_impl="naive"), ref.mesh(), slots=SLOTS,
                          max_len=MAX_LEN, plan=plan, prefill_chunk=CHUNK, params=jparams)
    rows = {}
    select = eng._select

    def record(req, row):
        rows.setdefault(req.rid, []).append(np.array(row, np.float32))
        return select(req, row)
    eng._select = record
    toks = eng.run(ref.synth_requests(jcfg, N_REQ, PROMPT, GEN, np.random.default_rng(1)))
    return toks, rows, eng.metrics()


def _run_port(plan, params, forced=None, prefill_chunk=CHUNK):
    """The port's engine under `plan`; forced: {rid: tokens} to feed
    (teacher forcing). -> (tokens, rows, metrics, params swap bytes)."""
    cfg = get_smoke_config(ARCH)
    eng = ServeEngine(Model(cfg, attn_impl="naive"), slots=SLOTS, max_len=MAX_LEN, plan=plan,
                      prefill_chunk=prefill_chunk, params=params, device="cpu")
    rows = {}
    select = eng._select

    def record(req, row):
        rows.setdefault(req.rid, []).append(row.copy())
        if forced is not None:
            return int(forced[req.rid][len(req.tokens)])
        return select(req, row)
    eng._select = record
    before = off.swap_counters()
    reqs = _requests(cfg)
    toks = eng.run(reqs)
    moved = {k: v - before.get(k, 0) for k, v in off.swap_counters().items()}
    assert all(r.status == "ok" for r in reqs)
    return toks, rows, eng.metrics(), moved


def _sweep_bytes(params, tokens: int) -> int:
    """Params bytes one streamed sweep moves: the stack, the final norm,
    the head, and `tokens` embedding rows (f32)."""
    embed = params["embed"]
    return (off.tree_bytes(params["decoder"]["stack0"]) + off.tree_bytes(params["final_norm"])
            + off.tree_bytes(embed["lm_head"]) + tokens * embed["embedding"].shape[1] * 4)


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("case", ["params", "kv"])
def test_engine_under_serve_plan_matches_jax_and_resident(jm, ref, params, case, kv_dtype):
    """The engine under a serve plan, teacher-forced with the JAX engine's
    tokens under the same plan: every logits row within 2**-5 of the row's
    largest |logit|, the pool's counters equal. Free-running, the port's
    streamed engine equals its resident twin (the same plan with nothing
    streamed, params on the device) bitwise, tokens and rows, and under the
    params plan the params' swap bytes are (chunks + ticks) sweeps of
    `_sweep_bytes`."""
    jparams, _, tparams = params
    jp, tpl = plans(jm, ref, case, kv_dtype)
    jtoks, jrows, jmet = _run_jax(ref, jparams, jp)
    placed = tsteps.place_params(tparams, tpl, "cpu")
    toks, rows, met, moved = _run_port(tpl, placed, forced=jtoks)
    assert {k: v.tolist() for k, v in toks.items()} == {k: v.tolist() for k, v in jtoks.items()}
    for rid, want_rows in jrows.items():
        assert len(rows[rid]) == len(want_rows) == GEN
        for got, want in zip(rows[rid], want_rows):
            assert np.abs(got - want).max() <= 2.0 ** -5 * np.abs(want).max()
    for key in ("ticks", "decode_tokens", "pool_spilled_pages", "pool_prefetched_pages",
                "pool_fetched_pages", "pool_direct_pages", "pool_peak_resident_pages"):
        assert met[key] == jmet[key], key
    assert met["pool_spilled_pages"] > 0
    assert met["pool_fetched_pages"] + met["pool_prefetched_pages"] == met["pool_spilled_pages"]

    own, own_rows, own_met, moved = _run_port(tpl, tsteps.place_params(tparams, tpl, "cpu"))
    twin = dataclasses.replace(tpl, swap_schedule=None)
    res, res_rows, _, res_moved = _run_port(twin, tparams)
    assert {k: v.tolist() for k, v in own.items()} == {k: v.tolist() for k, v in res.items()}
    for rid in res_rows:
        for got, want in zip(own_rows[rid], res_rows[rid]):
            assert np.array_equal(got, want)
    assert res_moved.get("lms.swap_in_bytes.params", 0) == 0
    if case == "params":
        chunks = N_REQ * PROMPT // CHUNK
        ticks = int(own_met["ticks"])
        want = (chunks * _sweep_bytes(tparams, CHUNK) + ticks * _sweep_bytes(tparams, SLOTS))
        assert moved["lms.swap_in_bytes.params"] == want
    else:
        assert moved.get("lms.swap_in_bytes.params", 0) == 0


def test_whole_prompt_prefill_under_serve_plan_is_bitwise_resident(jm, ref, params):
    """Whole-prompt prefill (prefill_chunk=0, as scripts/serve_beyond_card.py
    serves) under the params plan: tokens and rows bitwise the resident
    twin's; each prompt one sweep of its 8 rows, each tick one of SLOTS."""
    _, _, tparams = params
    _, tpl = plans(jm, ref, "params", "model")
    own, own_rows, met, moved = _run_port(tpl, tsteps.place_params(tparams, tpl, "cpu"),
                                          prefill_chunk=0)
    res, res_rows, _, _ = _run_port(dataclasses.replace(tpl, swap_schedule=None), tparams,
                                    prefill_chunk=0)
    assert {k: v.tolist() for k, v in own.items()} == {k: v.tolist() for k, v in res.items()}
    assert all(np.array_equal(a, b) for rid in res_rows
               for a, b in zip(own_rows[rid], res_rows[rid]))
    assert moved["lms.swap_in_bytes.params"] == (N_REQ * _sweep_bytes(tparams, PROMPT)
                                                 + int(met["ticks"]) * _sweep_bytes(tparams, SLOTS))


def test_head_in_vocab_slices_when_larger_than_the_window():
    """A head larger than the window the plan prices for streamed params
    (8 layers at smoke width with a 4096-token vocab: the plan's device
    params are 2 layers' share of the whole model, less than the head)
    comes in a vocab slice at a time without grads: the static loop under
    the plan gives the resident loop's tokens bitwise and the logits the
    whole head gives within 1e-6 of the row's largest |logit|, and the
    slices add up to the head's bytes."""
    from repro_torch.models import rest
    cfg = dataclasses.replace(get_smoke_config(ARCH), num_layers=8, vocab_size=4096)
    plan = tp.plan(tp.PlanRequest(
        cfg=cfg, shape=tb.ShapeConfig("serve", "decode", MAX_LEN, SLOTS),
        mesh=tb.MeshSpec(*MESH), lms=tb.LMSConfig(hbm_budget=100_000), hw=thw.H100_SXM,
        serve=True, slots=SLOTS, page_size=PAGE))
    model = Model(cfg, attn_impl="naive")
    params = model.init(0, "cpu")
    head = params["embed"]["lm_head"]
    room = rest.window(cfg, plan.swap_schedule)
    assert plan.residency["params"] == "host" and room < head.numel() * head.element_size()
    x = torch.randn((2, 3, cfg.d_model), generator=torch.Generator().manual_seed(0)).bfloat16()
    with torch.no_grad():
        got = rest.logits(cfg, params["embed"], x, room)
    want = x @ head
    assert (got.float() - want.float()).abs().max() <= 1e-6 * want.float().abs().max()
    reqs = _requests(cfg)
    _, resident, _ = run_static(model, reqs, PROMPT, GEN, params=params, device="cpu")
    before = off.swap_counters()
    _, streamed, _ = run_static(model, reqs, PROMPT, GEN, device="cpu", plan=plan,
                                params=tsteps.place_params(params, plan, "cpu"))
    moved = {k: v - before.get(k, 0) for k, v in off.swap_counters().items()}
    assert np.array_equal(streamed, resident)
    rows = N_REQ * PROMPT + (GEN - 1) * N_REQ
    assert moved["lms.swap_in_bytes.params"] == GEN * _sweep_bytes(params, 0) \
        + rows * cfg.d_model * 4


@pytest.mark.parametrize("tied", [False, True])
def test_head_in_vocab_slices_is_the_resident_head_bitwise(tied):
    """Without grads a head wider than `layers.head_block` is taken a block
    at a time, resident or streamed: the vocab slices a window takes are
    whole blocks, and their logits equal the resident head's bitwise
    (untied head and tied table); with grads the resident head is one
    product, as before."""
    from repro_torch.models import layers, rest
    cfg = dataclasses.replace(get_smoke_config(ARCH), num_layers=8, vocab_size=4096,
                              tie_embeddings=tied)
    block = layers.head_block(cfg)
    params = Model(cfg, attn_impl="naive").init(0, "cpu")["embed"]
    w = params["embedding"] if tied else params["lm_head"]
    nbytes = w.numel() * w.element_size()
    assert 128 <= block < cfg.vocab_size and block % 128 == 0
    room = nbytes * block // cfg.vocab_size        # one block a slice
    parts = rest._slices(cfg.vocab_size, nbytes, room, block)
    assert len(parts) > 1 and all(a % block == 0 for a, _ in parts)
    assert parts[-1][1] == cfg.vocab_size
    x = torch.randn((2, 3, cfg.d_model), generator=torch.Generator().manual_seed(0)).bfloat16()
    with torch.no_grad():
        want = layers.lm_logits(cfg, params, x)
        got = rest.logits(cfg, params, x, room)
    assert got.dtype == want.dtype and torch.equal(got, want)
    whole = (x @ params["embedding"].bfloat16().T) if tied else x @ w
    with torch.enable_grad():
        assert torch.equal(layers.lm_logits(cfg, params, x), whole)


def test_placed_serve_params_are_the_init_and_the_converted(jm, ref, params):
    """`init_params(plan=)` builds `model.init`'s values bitwise, every leaf
    (the rest too) in the pinned arena's one buffer; `place_params` and
    `convert.serve_params_from_jax` place given values the same way."""
    _, nparams, tparams = params
    _, tpl = plans(jm, ref, "params", "model")
    model = Model(get_smoke_config(ARCH))
    placed = tsteps.init_params(model, 3, "cpu", tpl)
    want = model.init(3, "cpu")
    arena = off._ARENAS[-1]
    lo = arena.buffer.data_ptr()
    for got, w in zip(tree_leaves(placed), tree_leaves(want)):
        assert torch.equal(got, w)
        assert lo <= got.data_ptr() < lo + arena.buffer.numel()
    assert arena.offset == sum(tsteps._leaf_bytes(t.shape, t.dtype)
                               for t in tree_leaves(want))
    conv_placed = serve_params_from_jax(nparams, tpl, "cpu")
    for got, w in zip(tree_leaves(conv_placed), tree_leaves(tparams)):
        assert torch.equal(got, w)
    assert tsteps.init_params(model, 3, "cpu", None)["embed"]["embedding"].equal(
        want["embed"]["embedding"])


@pytest.mark.parametrize("case", ["params", "kv"])
def test_static_loop_under_serve_plan_is_bitwise_resident(jm, ref, params, case):
    """`run_static(plan=)`: the params streamed a layer at a time (and under
    the params plan the KV cache too: emitted into host memory by the
    prefill, streamed per layer by each decode step) give the resident
    loop's tokens bitwise; the streamed bytes are counted."""
    _, _, tparams = params
    _, tpl = plans(jm, ref, case, "model")
    model = Model(get_smoke_config(ARCH), attn_impl="naive")
    reqs = _requests(model.cfg)
    _, want, _ = run_static(model, reqs, PROMPT, GEN, params=tparams, device="cpu")
    before = off.swap_counters()
    _, got, _ = run_static(model, reqs, PROMPT, GEN, device="cpu", plan=tpl,
                           params=tsteps.place_params(tparams, tpl, "cpu"))
    moved = {k: v - before.get(k, 0) for k, v in off.swap_counters().items()}
    assert np.array_equal(got, want)
    streams = tpl.swap_schedule.streams_params
    assert (moved.get("lms.swap_in_bytes.params", 0) > 0) == streams
    if tpl.swap_schedule.streams_kvcache:
        cfg = model.cfg
        # k and v, bf16 [L, N, prompt + gen, K, D]: in and out once a decode
        # step, and out once more from the prefill
        cache = 2 * cfg.num_layers * N_REQ * (PROMPT + GEN) * cfg.num_kv_heads * cfg.head_dim * 2
        assert moved["lms.swap_in_bytes.kvcache"] == (GEN - 1) * cache
        assert moved["lms.swap_out_bytes.kvcache"] == GEN * cache


def _cli(argv, capsys):
    from repro_torch.launch import serve as launch
    assert launch.main(argv) == 0
    return capsys.readouterr().out


SMOKE_ARGV = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "4", "--slots", "2",
              "--prompt-len", "8", "--gen", "8", "--page-size", "4", "--prefill-chunk", "4"]


def test_launch_serve_trace_report_and_profile(jm, ref, capsys, tmp_path):
    """`--trace` and `--obs-report` write their files; a second run with
    `--profile <that report>` prints the summary of the JAX planner's
    serve plan on the same report and request (the port's H100 spec),
    and serves; `--mesh 1x1` runs."""
    import json
    trace, report = tmp_path / "trace.json", tmp_path / "report.json"
    out = _cli(SMOKE_ARGV + ["--mesh", "1x1", "--trace", str(trace),
                             "--obs-report", str(report)], capsys)
    assert "served 4 requests" in out
    assert any(e.get("ph") == "X" for e in json.loads(trace.read_text())["traceEvents"])
    assert json.loads(report.read_text())["schema"]
    out = _cli(SMOKE_ARGV + ["--profile", str(report)], capsys)
    jb = jm["base"]
    jp = jm["plan"].plan(jm["plan"].PlanRequest(
        cfg=ref.get_smoke_config(ARCH), shape=jb.ShapeConfig("cli_serve", "decode", 16, 4),
        mesh=jb.MeshSpec(*MESH), hw=conv(thw.H100_SXM, jm["hw"].HardwareSpec), serve=True,
        slots=2, page_size=4, kv_dtype="model"), profile=str(report))
    assert jp.summary() in out
    assert "served 4 requests" in out


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "2x1"], "not ported yet"),
    (["--mesh", "2x1x1"], "not ported yet"),
])
def test_launch_serve_mesh_above_1x1_raises(argv, match):
    """A data or pod axis above 1 still raises (serving on a `model` axis
    runs: tests/test_torch_tp_serve.py)."""
    from repro_torch.launch import serve as launch
    with pytest.raises(NotImplementedError, match=match):
        launch.main(SMOKE_ARGV + argv)


def test_launch_serve_static_rejects_profile(capsys):
    from repro_torch.launch import serve as launch
    with pytest.raises(SystemExit):
        launch.main(SMOKE_ARGV + ["--static", "--profile", REPORT])
    assert "--profile plans the engine" in capsys.readouterr().err
