"""Serving on a `model` axis in the port against the JAX package, on the
CPU: 2 gloo ranks of a 1x1x2 ("pod", "data", "model") mesh against the JAX
package on a (1, 1, 2) mesh of emulated devices (GSPMD), from one set of
random params (`random_params`, converted by `params_from_jax(mesh=)`):

(a) the model's serve paths, qwen2.5-14b and olmo-1b smoke (2 / 1 query
    heads a rank, 1 / 2 kv heads): `Model.prefill` (the JAX
    `build_prefill_step`), chunked prefill (`model.prefill_chunk`, a
    prompt of 6 in chunks of 4), the whole-batch decode
    (`build_decode_step`) and the slot decode (`build_slot_decode_step`,
    bf16 and int8 KV, one inactive row): the logits, whole on each rank,
    and each rank's `kv_heads` block of every cache leaf;
(b) the continuous-batching engine on the mesh, teacher-forced against
    the JAX engine on the mesh with test_torch_serve.py's trace (4
    requests of 8 + 8, 2 slots, page size 4, chunk 4: two requests spill),
    both KV widths, through an injected transient exhaustion, a forced
    preemption and a tick fault under one fault plan;
(c) `run_static` on the mesh token by token against JAX's `run_static`;
(d) the serve plan on the mesh field by field against the JAX plan, and
    the engine and `run_static` under it bitwise their resident runs;
(e) the serve launcher under torchrun on `--mesh 1x2` and `1x1x2`
    against the JAX launcher on 2 emulated devices.

Tolerances (stated with the worst case measured on this CPU):
- logits within 2**-5 of the JAX row's largest |logit| (test_torch_serve.py's
  bound, 4 bf16 ulps; measured at most 2**-6.3);
- each rank's cache block within 2**-5 of the JAX block's largest |value|
  (bf16 values, measured at most 2**-6.6; int8 KV compared dequantized,
  measured 2**-6.1);
- the teacher-forced engine rows within the same bound (measured 2**-5.7),
  and where JAX's top-1 / top-2 margin exceeds twice it, the port's own
  argmax agrees;
- greedy runs (`run_static`) part only at a JAX margin within twice the
  tolerance (test_torch_serve.py's rule; measured: olmo-1b's 4 requests
  and 3 of qwen2.5-14b's identical, the fourth parted at a near tie).
Everything a rank decides is bitwise the same on both ranks: the gathered
logits, the tokens, the statuses and the pool's counters; the JAX pool's
counters equal the port's exactly.
"""
import contextlib
import io
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_ddl import REPO, _env, init_gloo, start_jax, start_ranks, wait_all
from tests.test_torch_ddl_train import _wait_for, flat_tree, unflat_tree
from tests.test_torch_ref import (jax_pricing, jax_ref,  # noqa: F401 (fixtures)
                                  jax_ref_scope, random_params)

from repro_torch.config.base import LMSConfig, MeshSpec, ShapeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import Model

AXES = ("pod", "data", "model")
TP = 2
ARCHS = ("qwen2.5-14b", "olmo-1b")
ENGINE_ARCH = "qwen2.5-14b"
KV = ("model", "int8")
SLOTS, MAX_LEN, PAGE, CHUNK = 2, 16, 4, 4
N_REQ, PROMPT, GEN = 4, 8, 8
# the paths' batch: 3 rows, a prompt of PROMPT, a chunked prompt of 6
B, CPROMPT = 3, 6
POSITIONS, ACTIVE = [PROMPT, PROMPT - 3, PROMPT - 1], [True, False, True]
# transient exhaustion, a forced preemption, then a tick fault
EVENTS = [("pool.reserve", 0, dict(kind="exhaust", times=2)),
          ("engine.tick", 2, dict(kind="preempt")),
          ("engine.tick", 9, dict(kind="raise"))]
POOL_KEYS = ("spilled_pages", "fetched_pages", "prefetched_pages", "direct_pages",
             "preempted_requests", "preempted_pages", "injected_exhaustions",
             "peak_resident_pages")
PLAN_BUDGET = 60_000          # puts the params (and the KV backlog) on the host
TOL = 2.0 ** -5
ME = "tests.test_torch_tp_serve"
CLI = ["--smoke", "--requests", "4", "--slots", "2", "--prompt-len", "8", "--gen", "8",
       "--page-size", "4", "--prefill-chunk", "4"]


def _inputs(vocab, seed=5):
    rng = np.random.default_rng(seed)
    return {"prompt": rng.integers(0, vocab, (B, PROMPT), dtype=np.int32),
            "chunked": rng.integers(0, vocab, (1, CPROMPT), dtype=np.int32),
            "next": rng.integers(0, vocab, (B, 1), dtype=np.int32)}


def _f32(tree, prefix):
    """{prefix + path: f32 array} of a cache tree (JAX or torch leaves)."""
    out = {}
    for k, v in flat_tree(tree).items():
        out[prefix + k.replace("@bf16", "")] = np.asarray(v, np.float32)
    return out


def _fault_plan(mod):
    return mod.FaultInjector(mod.FaultPlan([mod.FaultEvent(*e[:2], **e[2]) for e in EVENTS]))


# ---------------------------------------------------------------------------
# the JAX side: a (1, 1, 2) mesh of emulated devices
# ---------------------------------------------------------------------------

def jax_engine(ref, mesh, arch, jparams, kv_dtype, injector=None):
    """The JAX engine on `mesh` over the trace: (tokens, logits rows, metrics,
    statuses)."""
    jcfg = ref.get_smoke_config(arch)
    eng = ref.ServeEngine(ref.Model(jcfg, attn_impl="naive"), mesh, slots=SLOTS,
                          max_len=MAX_LEN, page_size=PAGE, prefill_chunk=CHUNK,
                          params=jparams, kv_dtype=kv_dtype, injector=injector)
    rows, select = {}, eng._select

    def record(req, row):
        rows.setdefault(req.rid, []).append(np.array(row, np.float32))
        return select(req, row)
    eng._select = record
    reqs = ref.synth_requests(jcfg, N_REQ, PROMPT, GEN, np.random.default_rng(1))
    toks = eng.run(reqs)
    return toks, rows, eng.metrics(), {r.rid: r.status for r in reqs}


def save_engine(path, toks, rows, metrics, statuses):
    res = {f"tok/{rid}": np.asarray(t, np.int32) for rid, t in toks.items()}
    for rid, rs in rows.items():
        res[f"rows/{rid}"] = np.stack(rs).astype(np.float32)
    res.update({f"metric/{k}": np.float64(v) for k, v in metrics.items()})
    res.update({f"status/{rid}": np.array(s) for rid, s in statuses.items()})
    np.savez(path, **res)


def _jax_paths(ref, mesh, arch, jparams, res):
    """(a): each serve path's logits and cache on the mesh."""
    jax, jnp = ref.jax, ref.jnp
    from repro.config import base as jb
    from repro.models import kvquant as jkv
    from repro.train import steps as js
    cfg = ref.get_smoke_config(arch)
    model = ref.Model(cfg, attn_impl="naive")
    inp = _inputs(cfg.vocab_size)
    total = MAX_LEN
    fn, params_sh, _, _ = js.build_prefill_step(
        model, jb.ShapeConfig("p", "prefill", PROMPT, B), mesh,
        spec=js.StepSpec(cache_len=total))
    params = jax.device_put(jparams, params_sh)
    logits, cache = fn(params, {"tokens": jnp.asarray(inp["prompt"])})
    res[f"{arch}/prefill/logits"] = np.asarray(logits, np.float32)
    res.update(_f32(jax.tree.map(np.asarray, cache), f"{arch}/prefill/cache/"))

    # chunked prefill: a prompt of CPROMPT in chunks of CHUNK, padded
    chunk_fn = jax.jit(model.prefill_chunk)
    scratch = model.init_cache(1, total)
    for lo in range(0, CPROMPT, CHUNK):
        hi = min(lo + CHUNK, CPROMPT)
        toks = np.zeros((1, CHUNK), np.int32)
        toks[:, :hi - lo] = inp["chunked"][:, lo:hi]
        lg, scratch = chunk_fn(params, scratch, {"tokens": jnp.asarray(toks)}, lo, hi)
        res[f"{arch}/prefill_chunk/logits/{lo}"] = np.asarray(lg, np.float32)[:, :hi - lo]
    res.update(_f32(jax.tree.map(np.asarray, scratch), f"{arch}/prefill_chunk/cache/"))

    dec, _, _, _ = js.build_decode_step(model, jb.ShapeConfig("d", "decode", total, B), mesh,
                                        spec=js.StepSpec(donate=False))
    logits, c2 = dec(params, cache, {"tokens": jnp.asarray(inp["next"])}, jnp.int32(PROMPT))
    res[f"{arch}/decode_step/logits"] = np.asarray(logits, np.float32)
    res.update(_f32(jax.tree.map(np.asarray, c2), f"{arch}/decode_step/cache/"))

    for kv in KV:
        slot, _, _, cache_sh = js.build_slot_decode_step(
            model, jb.ShapeConfig("s", "decode", total, B), mesh,
            spec=js.StepSpec(donate=False, kv_dtype=kv))
        start = jkv.quantize_cache_tree(cache, total) if kv == "int8" else cache
        start = jax.device_put(start, cache_sh)
        logits, c3 = slot(params, start, {"tokens": jnp.asarray(inp["next"])},
                          jnp.asarray(POSITIONS, jnp.int32), jnp.asarray(ACTIVE))
        res[f"{arch}/decode_slots_{kv}/logits"] = np.asarray(logits, np.float32)
        res.update(_f32(jax.tree.map(np.asarray, c3), f"{arch}/decode_slots_{kv}/cache/"))


def _jax_side(out_dir):
    ref = jax_ref()
    from repro.config import base as jb
    from repro.launch import serve as jserve
    from repro.launch.mesh import make_mesh
    from repro.runtime import inject as jinject
    out = pathlib.Path(out_dir)
    mesh = make_mesh(jb.MeshSpec((1, 1, TP), AXES))
    params = {arch: unflat_tree(dict(np.load(out / f"{arch}_params.npz"))) for arch in ARCHS}
    # (b) first: the port's ranks wait for its tokens
    for kv in KV:
        save_engine(out / f"jax_engine_{kv}.npz",
                    *jax_engine(ref, mesh, ENGINE_ARCH, params[ENGINE_ARCH], kv,
                                _fault_plan(jinject)))
    res = {}
    for arch in ARCHS:
        jcfg = ref.get_smoke_config(arch)
        _, toks, _ = ref.launch_serve.run_static(
            ref.Model(jcfg, attn_impl="naive"), mesh,
            ref.synth_requests(jcfg, N_REQ, PROMPT, GEN, np.random.default_rng(4)),
            PROMPT, GEN, params=params[arch])
        res[f"{arch}/static"] = np.asarray(toks, np.int32)
        _jax_paths(ref, mesh, arch, params[arch], res)
    np.savez(out / "jax_paths.npz", **res)
    for m in ("1x2", "1x1x2"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jserve.main(["--arch", ENGINE_ARCH, "--mesh", m] + CLI)
        (out / f"jax_cli_{m}.txt").write_text(buf.getvalue())


# ---------------------------------------------------------------------------
# the port's ranks: 2 gloo processes on 1x1x2
# ---------------------------------------------------------------------------

def port_engine(cfg, mesh, params, kv_dtype, forced=None, injector=None, **kw):
    """The port's engine on `mesh` over the trace, teacher-forced with
    `forced` {rid: tokens} where given: (tokens, rows, own argmaxes,
    metrics, statuses)."""
    from repro_torch.serve import ServeEngine, synth_requests
    kw.setdefault("page_size", PAGE)
    eng = ServeEngine(Model(cfg, attn_impl="naive"), slots=SLOTS, max_len=MAX_LEN,
                      prefill_chunk=CHUNK, params=params, kv_dtype=kv_dtype,
                      device="cpu", mesh=mesh, injector=injector, **kw)
    rows, own, select = {}, {}, eng._select

    def pick(req, row):
        rows.setdefault(req.rid, []).append(row.astype(np.float32))
        own.setdefault(req.rid, []).append(int(np.argmax(row)))
        if forced is None:
            return select(req, row)
        return int(forced[req.rid][len(req.tokens)])
    eng._select = pick
    reqs = synth_requests(cfg, N_REQ, PROMPT, GEN, np.random.default_rng(1))
    toks = eng.run(reqs)
    return toks, rows, own, eng.metrics(), {r.rid: r.status for r in reqs}


def _port_paths(arch, mesh, params, res):
    from repro_torch.models import kvquant
    from repro_torch.serve import decode_step_batch
    from repro_torch.train import steps as ts
    cfg = get_smoke_config(arch)
    model = Model(cfg, attn_impl="naive")
    inp = {k: torch.from_numpy(v) for k, v in _inputs(cfg.vocab_size).items()}
    total = MAX_LEN
    pre, _ = ts.build_prefill_step(model, ShapeConfig("p", "prefill", PROMPT, B),
                                   ts.StepSpec(cache_len=total), mesh=mesh)
    logits, cache = pre(params, {"tokens": inp["prompt"]})
    res[f"{arch}/prefill/logits"] = logits.float().numpy()
    res.update(_f32(cache, f"{arch}/prefill/cache/"))

    scratch = model.init_cache(1, total, "cpu", mesh)
    for lo in range(0, CPROMPT, CHUNK):
        hi = min(lo + CHUNK, CPROMPT)
        toks = torch.zeros((1, CHUNK), dtype=torch.int32)
        toks[:, :hi - lo] = inp["chunked"][:, lo:hi]
        lg, scratch = model.prefill_chunk(params, scratch, {"tokens": toks}, lo, hi, mesh=mesh)
        res[f"{arch}/prefill_chunk/logits/{lo}"] = lg.float().numpy()[:, :hi - lo]
    res.update(_f32(scratch, f"{arch}/prefill_chunk/cache/"))

    dec, _ = ts.build_decode_step(model, ShapeConfig("d", "decode", total, B), mesh=mesh)
    clone = {"stack0": {k: {n: t.clone() for n, t in v.items()}
                        for k, v in cache["stack0"].items()}}
    logits, c2 = dec(params, clone, decode_step_batch(cfg, inp["next"], None), PROMPT)
    res[f"{arch}/decode_step/logits"] = logits.float().numpy()
    res.update(_f32(c2, f"{arch}/decode_step/cache/"))

    for kv in KV:
        slot, _ = ts.build_slot_decode_step(model, ShapeConfig("s", "decode", total, B),
                                            ts.StepSpec(kv_dtype=kv), mesh=mesh)
        start = {"stack0": {k: {n: t.clone() for n, t in v.items()}
                            for k, v in cache["stack0"].items()}}
        if kv == "int8":
            start = kvquant.quantize_cache_tree(start, total)
        logits, c3 = slot(params, start, {"tokens": inp["next"]},
                          torch.tensor(POSITIONS, dtype=torch.int32), torch.tensor(ACTIVE))
        res[f"{arch}/decode_slots_{kv}/logits"] = logits.float().numpy()
        res.update(_f32(c3, f"{arch}/decode_slots_{kv}/cache/"))


def serve_plan(cfg, mesh_spec, kv_dtype="model"):
    """The port's serve plan of the trace on `mesh_spec` under PLAN_BUDGET."""
    from repro_torch import hw as thw
    from repro_torch.core.lms import planner as tp
    return tp.plan(tp.PlanRequest(
        cfg=cfg, shape=ShapeConfig("serve", "decode", MAX_LEN, SLOTS), mesh=mesh_spec,
        lms=LMSConfig(hbm_budget=PLAN_BUDGET), hw=thw.H100_SXM, serve=True, slots=SLOTS,
        backlog_slots=6, page_size=PAGE, kv_dtype=kv_dtype))


def _port_ranks(rank, world, out_dir):
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import run_static
    from repro_torch.runtime import inject as tinject
    from repro_torch.serve import synth_requests
    from repro_torch.train import steps as ts
    out = pathlib.Path(out_dir)
    init_gloo(rank, world, out)
    spec = MeshSpec((1, 1, TP), AXES)
    mesh = make_mesh(spec)
    res = {}
    params = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        params[arch] = params_from_jax(unflat_tree(dict(np.load(out / f"{arch}_params.npz"))),
                                       "cpu", mesh, cfg)
        _port_paths(arch, mesh, params[arch], res)
        reqs = synth_requests(cfg, N_REQ, PROMPT, GEN, np.random.default_rng(4))
        got, toks, _ = run_static(Model(cfg, attn_impl="naive"), reqs, PROMPT, GEN,
                                  params=params[arch], device="cpu", mesh=mesh)
        assert got is params[arch]
        res[f"{arch}/static"] = toks

    # (b) teacher-forced with the JAX engine's tokens, under the JAX fault plan
    cfg = get_smoke_config(ENGINE_ARCH)
    tparams = params[ENGINE_ARCH]
    for kv in KV:
        _wait_for(out / f"jax_engine_{kv}.npz")
        j = dict(np.load(out / f"jax_engine_{kv}.npz"))
        forced = {int(k[4:]): v for k, v in j.items() if k.startswith("tok/")}
        toks, rows, own, m, st = port_engine(cfg, mesh, tparams, kv, forced,
                                             _fault_plan(tinject))
        save_engine(out / f"port_engine_{kv}_{rank}.npz", toks, rows, m, st)
        np.savez(out / f"port_own_{kv}_{rank}.npz",
                 **{f"own/{rid}": np.asarray(v) for rid, v in own.items()})

    # (d) under the serve plan against resident runs of the plan's geometry
    plan = serve_plan(cfg, spec)
    assert plan.residency["params"] == "host"
    placed = ts.place_params(tparams, plan, "cpu")
    geo = dict(page_size=plan.kv_paging.page_size, device_pages=plan.kv_paging.device_pages,
               host_pages=plan.kv_paging.host_pages)
    planned = port_engine(cfg, mesh, placed, "model", plan=plan)
    resident = port_engine(cfg, mesh, tparams, "model", **geo)
    for name, run in (("planned", planned), ("resident", resident)):
        for rid, rs in run[1].items():
            res[f"plan/{name}/rows/{rid}"] = np.stack(rs)
            res[f"plan/{name}/tok/{rid}"] = run[0][rid]
    reqs = synth_requests(cfg, N_REQ, PROMPT, GEN, np.random.default_rng(4))
    res["plan/planned/static"] = run_static(Model(cfg, attn_impl="naive"), reqs, PROMPT, GEN,
                                            params=placed, device="cpu", plan=plan,
                                            mesh=mesh)[1]
    res["plan/resident/static"] = res[f"{ENGINE_ARCH}/static"]
    res["plan/residency"] = np.array(sorted(plan.residency.items()))
    np.savez(out / f"port_{rank}.npz", **res)


def _cli(mesh):
    """torchrun of the serve launcher on 2 CPU ranks of `mesh`."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", "--arch", ENGINE_ARCH,
           "--device", "cpu", "--mesh", mesh] + CLI
    return subprocess.Popen(cmd, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch import serve
    ref = jax_ref()
    out = tmp_path_factory.mktemp("tp_serve")
    for i, arch in enumerate(ARCHS):
        jparams, _ = random_params(ref, ref.get_smoke_config(arch), seed=i)
        np.savez(out / f"{arch}_params.npz",
                 **flat_tree(ref.jax.tree.map(np.asarray, jparams)))
    clis = {m: _cli(m) for m in ("1x2", "1x1x2")}
    procs = start_jax(ME, "_jax_side", out, devices=TP) + start_ranks(ME, "_port_ranks", out, TP)
    wait_all(procs, timeout=300)
    cli_out = {m: wait_all([p], timeout=120)[0] for m, p in clis.items()}
    # the one-device launcher with the same flags: the mesh serves its params
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--arch", ENGINE_ARCH, "--device", "cpu"] + CLI)
    cli_out["1x1"] = buf.getvalue()
    return out, cli_out


def _ranks(out, name):
    return [dict(np.load(out / name.format(r=r))) for r in range(TP)]


def _block(a, k, r):
    """Rank r's kv_heads block of a global cache leaf [L, B, S, K, ...] (the
    scales [L, B, S, K] too)."""
    n = a.shape[3] // TP
    return a[:, :, :, r * n:(r + 1) * n]


PATHS = ("prefill", "prefill_chunk", "decode_step", "decode_slots_model", "decode_slots_int8")


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_paths_match_jax(runs, arch, path):
    """The path's logits on each rank against JAX's whole logits, bitwise
    the same on both ranks; each rank's cache block against the JAX cache's
    `kv_heads` block (int8 codes dequantized with their scales)."""
    out, _ = runs
    j = dict(np.load(out / "jax_paths.npz"))
    ranks = _ranks(out, "port_{r}.npz")
    pre = f"{arch}/{path}/"
    keys = [k for k in j if k.startswith(pre + "logits")]
    assert keys
    for key in keys:
        want = j[key]
        for r in ranks:
            assert r[key].shape == want.shape
            err = np.abs(r[key] - want).max() / np.abs(want).max()
            assert err <= TOL, (key, err)
            assert r[key].tobytes() == ranks[0][key].tobytes(), key
    leaves = sorted(k for k in j if k.startswith(pre + "cache/"))
    assert leaves
    if path.endswith("int8"):
        for key in leaves:
            if not key.endswith("/k") and not key.endswith("/v"):
                continue
            want = j[key] * j[key + "_scale"][..., None]
            for i, r in enumerate(ranks):
                got = r[key] * r[key + "_scale"][..., None]
                blk = _block(want, key, i)
                assert got.shape == blk.shape
                assert np.abs(got - blk).max() <= TOL * np.abs(blk).max(), key
        return
    for key in leaves:
        for i, r in enumerate(ranks):
            blk = _block(j[key], key, i)
            assert r[key].shape == blk.shape, key
            assert np.abs(r[key] - blk).max() <= TOL * max(np.abs(blk).max(), 1e-30), key


@pytest.mark.parametrize("kv_dtype", KV)
def test_engine_on_the_mesh_matches_jax_teacher_forced(runs, kv_dtype):
    """Every logits row of every request within 2**-5 of the JAX engine's
    row max, the port's argmax agreeing where JAX's margin is wide; the
    statuses (one batch failed by the tick fault) and the pool's counters
    equal the JAX engine's; tokens, rows, statuses, counters, the wall
    time and the TTFT / TPOT metrics bitwise the same on both ranks."""
    out, _ = runs
    j = dict(np.load(out / f"jax_engine_{kv_dtype}.npz"))
    ranks = _ranks(out, f"port_engine_{kv_dtype}_{{r}}.npz")
    owns = _ranks(out, f"port_own_{kv_dtype}_{{r}}.npz")
    for r in ranks[1:]:
        assert set(r) == set(ranks[0])
        for k in r:
            if k == "metric/decode_tok_s":
                continue           # each rank's own device time
            # the rest, the wall time and the TTFT / TPOT stamps too: rank 0's
            assert np.array_equal(r[k], ranks[0][k]), k
    assert {"metric/ttft_mean_s", "metric/tpot_p50_s", "metric/wall_s"} <= set(ranks[0])
    port = ranks[0]
    statuses = {k: str(v) for k, v in j.items() if k.startswith("status/")}
    assert statuses == {k: str(v) for k, v in port.items() if k.startswith("status/")}
    assert "failed" in statuses.values() and "ok" in statuses.values()
    checked = 0
    for key in (k for k in j if k.startswith("rows/")):
        want, got = j[key], port[key]
        assert got.shape == want.shape, key
        own = owns[0]["own/" + key[5:]]
        for step in range(want.shape[0]):
            tol = TOL * np.abs(want[step]).max()
            assert np.abs(got[step] - want[step]).max() <= tol, (key, step)
            top = np.sort(want[step])
            if top[-1] - top[-2] > 2 * tol:
                assert own[step] == int(np.argmax(want[step])), (key, step)
                checked += 1
    assert checked > 0
    for key in POOL_KEYS:
        assert port[f"metric/pool_{key}"] == j[f"metric/pool_{key}"], key
    assert port["metric/pool_spilled_pages"] > 0
    assert port["metric/pool_preempted_requests"] == 1
    assert port["metric/pool_injected_exhaustions"] == 2
    for k in ("ticks", "decode_tokens", "ok", "failed"):
        assert port[f"metric/{k}"] == j[f"metric/{k}"], k


def _near_tie(ref, jparams, arch, prompt, toks, step):
    """JAX's one-device dense logits scoring token `step` of a greedy run
    have a top-2 margin within twice the tolerance."""
    jm = ref.Model(ref.get_smoke_config(arch), attn_impl="naive")
    seq = np.concatenate([prompt, toks[:step]]).astype(np.int32)[None]
    w = np.asarray(ref.jax.jit(jm.prefill)(jparams, {"tokens": ref.jnp.asarray(seq)})[0],
                   np.float32)[0]
    top = np.sort(w)
    return top[-1] - top[-2] <= 2 * TOL * np.abs(w).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_run_static_on_the_mesh_matches_jax(runs, arch):
    """`run_static` on 1x1x2 against JAX's on (1, 1, 2), token by token:
    identical, or parted at a JAX near tie; identical on both ranks."""
    from repro_torch.serve import synth_requests
    out, _ = runs
    ref = jax_ref()
    jparams = unflat_tree(dict(np.load(out / f"{arch}_params.npz")))
    want = dict(np.load(out / "jax_paths.npz"))[f"{arch}/static"]
    ranks = _ranks(out, "port_{r}.npz")
    assert np.array_equal(ranks[0][f"{arch}/static"], ranks[1][f"{arch}/static"])
    got = ranks[0][f"{arch}/static"]
    assert got.shape == want.shape == (N_REQ, GEN)
    reqs = synth_requests(get_smoke_config(arch), N_REQ, PROMPT, GEN, np.random.default_rng(4))
    identical = 0
    for i, r in enumerate(reqs):
        parted = np.flatnonzero(got[i] != want[i])
        if parted.size == 0:
            identical += 1
        else:
            assert _near_tie(ref, jparams, arch, r.prompt, got[i], parted[0]), (i, parted[0])
    assert identical >= N_REQ // 2


@pytest.mark.parametrize("arch", [ENGINE_ARCH, "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("kv_dtype", KV)
@pytest.mark.parametrize("mesh", [((1, 1, 2), AXES), ((1, 2), ("data", "model"))],
                         ids=["1x1x2", "1x2"])
def test_serve_plan_on_the_mesh_matches_jax(jax_pricing, mesh, kv_dtype, arch):
    """The serve plan on a model mesh (params and KV priced by |model|)
    equals the JAX package's plan on the same MeshSpec field by field
    (`jax_pricing`: the port's own working sets zeroed); it streams the
    params at PLAN_BUDGET, and prices a rank below the one-device plan."""
    import dataclasses
    from tests.test_torch_lms import conv
    ref = jax_ref()
    from repro import hw as jhw
    from repro.config import base as jb
    from repro.core.lms import planner as jplan
    from repro_torch import hw as thw
    cfg = get_smoke_config(arch)
    tpl = serve_plan(cfg, MeshSpec(*mesh), kv_dtype)
    jp = jplan.plan(jplan.PlanRequest(
        cfg=ref.get_smoke_config(arch),
        shape=jb.ShapeConfig("serve", "decode", MAX_LEN, SLOTS), mesh=jb.MeshSpec(*mesh),
        lms=jb.LMSConfig(hbm_budget=PLAN_BUDGET), hw=conv(thw.H100_SXM, jhw.HardwareSpec),
        serve=True, slots=SLOTS, backlog_slots=6, page_size=PAGE, kv_dtype=kv_dtype))
    assert dataclasses.asdict(tpl) == dataclasses.asdict(jp)
    assert tpl.residency["params"] == "host"
    one = serve_plan(cfg, MeshSpec((1, 1), ("data", "model")), kv_dtype)
    assert one.peak_bytes > tpl.peak_bytes


def test_engine_and_static_under_the_plan_are_bitwise_resident(runs):
    """On each rank the engine under the serve plan (params streamed from
    the host arena a layer at a time) gives its resident run's rows and
    tokens bitwise (the resident engine given the plan's page geometry),
    and `run_static` under the plan its resident tokens."""
    out, _ = runs
    for r in _ranks(out, "port_{r}.npz"):
        planned = {k[len("plan/planned/"):]: v for k, v in r.items()
                   if k.startswith("plan/planned/")}
        resident = {k[len("plan/resident/"):]: v for k, v in r.items()
                    if k.startswith("plan/resident/")}
        assert planned.keys() == resident.keys() and len(planned) > N_REQ
        for k in planned:
            assert planned[k].tobytes() == resident[k].tobytes(), k


LINE = re.compile(r"served (\d+) requests .* concurrency ([\d.]+) \| pages spilled/returned "
                  r"(\d+)/(\d+)")


@pytest.mark.parametrize("mesh", ["1x2", "1x1x2"])
def test_torchrun_serve_cli_on_the_mesh(runs, mesh):
    """torchrun of the serve launcher on 2 CPU ranks prints, from rank 0
    only, the JAX launcher's served / concurrency / pages line on the same
    mesh of 2 devices (the params differ: each package draws its own), and
    the one-device launcher's tokens: the mesh serves the same params
    (each rank draws the one-device values and keeps its blocks)."""
    out, cli = runs
    text = cli[mesh]
    assert text.count("served 4 requests") == 1, text
    got = LINE.search(text)
    want = LINE.search((out / f"jax_cli_{mesh}.txt").read_text())
    assert got and want and got.groups() == want.groups()
    tok = re.compile(r"generated token ids \(first request\): (\[[^\]]*\])")
    assert tok.search(text).group(1) == tok.search(cli["1x1"]).group(1)
