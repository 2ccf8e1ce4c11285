"""LMS + DDL in the port on the CPU: the layer-streamed train step on the
ranks of a 2x1x1 ("pod", "data", "model") mesh over gloo, each layer's
grads reduced by the DDL hook's queue while the backward goes on, against
the JAX package and against the port's own resident step.

Inputs: the qwen2.5-14b smoke config (2 layers, d_model 64, bf16) from one
random state made from a seed with numpy (or the port's init from a seed),
3 steps of 4 x 16 tokens of the synthetic stream, each rank on its own 2
rows. Ranks rendezvous through a file under the test's tmp dir; the JAX
side runs in a subprocess with 2 emulated devices.

The plan. At smoke width the planner prices the serialized reduction
below the overlapped one (a bucket's latency outweighs a 64-wide layer),
so its plans keep grads on the device. The plan that sinks grads is the
planner's plan at a 600 kB budget (params and optimizer streamed) with
grads put on the host and the overlap recommended: built the same way on
both sides, and equal field by field.

Tolerances. Against the JAX package those of tests/test_torch_ddl_train.py,
for the same reasons (bf16 rounded at other places, the int8 pod hop):
loss, ce and grad norm within 2e-3 relative; after 3 Adam steps the
master weights within 2 lr N, the median within 0.01 lr N, the 99th
percentile within 0.1 lr N; every rank's params bitwise the same. One
exception, measured: with compress_dcn on this mesh (|data| 1, so every
element of every leaf crosses the int8 pod hop, each rank's grads from 2
rows) the 99th percentile lies at 0.39 lr N, and the port's resident DDL
step lies at the same 0.39 from the JAX package's resident step:
where the two frameworks' bf16 grads differ by an ulp an int8 code can
round the other way, a step of a row's scale / 127, which Adam turns into
an O(lr) update for a small grad. So the compressed case holds the 99th
percentile by what LMS adds to it, nothing: the port's LMS + DDL masters
equal its resident DDL step's bitwise, and the JAX package's equal its
resident step's bitwise (checked on its side). Against
the port's resident overlapped step, and the queued reduction against the
same reductions issued inline: bitwise (the same collectives on the same
values, the same buckets, the global norm from the same per-slice sums in
the same order, the optimizer's math elementwise).
"""
import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from tests.test_torch_ddl import REPO, _env, init_gloo, start_jax, start_ranks, wait_all
from tests.test_torch_ddl_train import _rel, _wait_for, flat_tree, save_state, state_from_npz
from tests.test_torch_ref import jax_ref, jax_ref_scope  # noqa: F401 (autouse fixture)

from repro_torch.config import base as tb
from repro_torch.configs import get_smoke_config
from repro_torch.core.ddl import overlap
from repro_torch.core.lms import offload as off, planner as tp
from repro_torch.train import steps as tsteps
from repro_torch.tree import tree_leaves

ARCH = "qwen2.5-14b"
OLMO = "olmo-1b"
MESH = ((2, 1, 1), ("pod", "data", "model"))
STEPS, BATCH, SEQ, LR = 3, 4, 16, 1e-3
BUDGET = 600_000
OFFLOAD_ALL_BUT_MLP = {"resid": "offload", "attn_norm": "offload", "qkv": "offload",
                       "attn_out": "offload", "mlp_norm": "offload", "mlp_hidden": "remat"}
CLI = ["--arch", ARCH, "--smoke", "--mesh", "2x1x1", "--compress-dcn", "--steps", "3",
       "--batch", "4", "--seq", "16"]
ME = "tests.test_torch_lms_ddl"
# name -> (compress_dcn, overlap_grads, prefetch depth, grads residency,
# the queue's reductions issued inline); each held bitwise to the resident
# step with the same compress_dcn and overlap_grads
VARIANTS = {"depth1_host": (True, True, 1, "host", False),
            "depth2_host": (True, True, 2, "host", False),
            "depth1_device": (True, True, 1, "device", False),
            "depth2_device": (True, True, 2, "device", False),
            "uncompressed_depth2_host": (False, True, 2, "host", False),
            "serialized_host": (True, False, 2, "host", False),
            "inline_depth2_host": (True, True, 2, "host", True)}


def sink_plan(planner, base, cfg, shape, mesh, hw):
    """The planner's plan at BUDGET for the hardware model `hw` with grads
    on the host and the overlap recommended (`planner`, `base`, `hw`:
    either package's)."""
    plan = planner.plan(planner.PlanRequest(cfg=cfg, shape=shape, mesh=mesh, hw=hw,
                                            lms=base.LMSConfig(hbm_budget=BUDGET)))
    res = {**plan.residency, "grads": "host"}
    sched = planner.make_swap_schedule(
        res, cfg.num_layers, "train", prefetch_depth=plan.swap_schedule.prefetch_depth,
        overlap_grads=True, swap_bytes=dict(plan.swap_schedule.swap_bytes))
    return dataclasses.replace(plan, residency=res, overlap_grads=True, swap_schedule=sched)


def _jax_h100():
    """The port's hardware model (the H100) as the JAX package's class, so
    both sides price the plan alike."""
    from repro import hw as jhw
    from repro_torch import hw as thw
    return jhw.HardwareSpec(**{f.name: getattr(thw.H100_SXM, f.name)
                               for f in dataclasses.fields(thw.H100_SXM)})


def _plan_json(plan) -> str:
    return json.dumps(dataclasses.asdict(plan), sort_keys=True)


def _batches(vocab):
    from repro_torch.data import SyntheticTokens
    data = SyntheticTokens(vocab, seed=3)
    return [data.batch(i, 0, 1, BATCH, SEQ) for i in range(STEPS)]


def _shape(base):
    return base.ShapeConfig("t", "train", SEQ, BATCH)


# ---------------------------------------------------------------------------
# the JAX side: the step under the sinking plan, the Trainer, the launcher
# ---------------------------------------------------------------------------

def _jax_side(out_dir):
    from tests.test_torch_ref import random_params
    ref = jax_ref()
    jax, jnp = ref.jax, ref.jnp
    from repro.config import base as jb
    from repro.core.lms import planner as jp
    from repro.launch import train as jlaunch
    from repro.launch.mesh import make_mesh
    from repro.optim.adamw import adamw_init
    from repro.train import steps as js, trainer as jtrainer
    out = pathlib.Path(out_dir)
    cfg = ref.get_smoke_config(ARCH)
    jparams, _ = random_params(ref, cfg, seed=11)
    init = js.TrainState(jnp.zeros((), jnp.int32), jparams, adamw_init(jparams))
    save_state(out / "init.npz", jax.tree.map(np.asarray, init))
    spec = jb.MeshSpec(*MESH)
    mesh = make_mesh(spec)
    plan = sink_plan(jp, jb, cfg, _shape(jb), spec, _jax_h100())
    (out / "jax_plan.json").write_text(_plan_json(plan))
    res = {}

    def run(name, cfg, init, c, p):
        tcfg = jb.TrainConfig(
            model=cfg, shape=_shape(jb), mesh=spec,
            lms=jb.LMSConfig(enabled=p is not None, hbm_budget=BUDGET),
            ddl=jb.DDLConfig(compress_dcn=c), learning_rate=LR, warmup_steps=0,
            total_steps=10)
        step, state_sh, batch_sh = js.build_train_step(ref.Model(cfg), tcfg, mesh, plan=p,
                                                       donate=False, overlap_grads=True)
        state = jax.device_put(init, state_sh)
        for i, b in enumerate(_batches(cfg.vocab_size)):
            state, met = step(state, jax.device_put(
                {k: jnp.asarray(v) for k, v in b.items()}, batch_sh))
            for k in ("loss", "ce", "grad_norm", "lr"):
                res[f"{name}/{k}/{i}"] = np.float32(met[k])
        res.update({f"{name}/master/{k}": v for k, v in
                    flat_tree(jax.tree.map(np.asarray, state.opt.master)).items()})
    # the step under the plan, compress off and on; the resident step
    # (overlapped) compressed, which the compressed one equals bitwise
    for name, c, p in (("compress=False", False, plan), ("compress=True", True, plan),
                       ("resident_compress", True, None)):
        run(name, cfg, init, c, p)
    # olmo-1b (norm subtrees with no leaves, a tied embedding), compressed,
    # under its own sinking plan and resident
    ocfg = ref.get_smoke_config(OLMO)
    oparams, _ = random_params(ref, ocfg, seed=12)
    oinit = js.TrainState(jnp.zeros((), jnp.int32), oparams, adamw_init(oparams))
    save_state(out / "olmo_init.npz", jax.tree.map(np.asarray, oinit))
    oplan = sink_plan(jp, jb, ocfg, _shape(jb), spec, _jax_h100())
    (out / "jax_olmo_plan.json").write_text(_plan_json(oplan))
    for name, p in ((f"{OLMO}/compress=True", oplan), (f"{OLMO}/resident_compress", None)):
        run(name, ocfg, oinit, True, p)
    np.savez(out / "jax_steps.npz", **res)

    # the Trainer under its own plan, the overlapped backward asked for;
    # it plans for the port's hardware model, as the port's trainer does
    import functools
    jtrainer.PlanRequest = functools.partial(jp.PlanRequest, hw=_jax_h100())
    tcfg = jb.TrainConfig(
        model=cfg, shape=_shape(jb), mesh=spec, lms=jb.LMSConfig(hbm_budget=BUDGET),
        ddl=jb.DDLConfig(compress_dcn=True, overlap_grads=True), learning_rate=LR,
        warmup_steps=1, total_steps=3, log_every=2, checkpoint_dir=str(out / "ckpt"))
    trainer = jtrainer.Trainer(tcfg)
    (out / "jax_trainer_plan.json").write_text(_plan_json(trainer.plan))
    save_state(out / "trainer_init.npz", jax.tree.map(np.asarray, trainer.init_state()))
    _, hist = trainer.train(steps=3)
    np.savez(out / "jax_trainer.npz", **{f"{k}/{r['step']}": np.float64(r[k])
                                         for r in hist for k in ("loss", "ce", "grad_norm", "lr")})

    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jlaunch.main(CLI + ["--ckpt-dir", str(out / "cli_ckpt")])
    (out / "jax_cli.txt").write_text(buf.getvalue())


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------

def _tcfg(**kw):
    return tb.TrainConfig(model=get_smoke_config(ARCH), shape=_shape(tb),
                          mesh=tb.MeshSpec(*MESH), learning_rate=LR, warmup_steps=0,
                          total_steps=10, **{"checkpoint_dir": None, **kw})


def _port_steps(rank, world, out_dir):
    """(i): the step under the sinking plan from JAX's initial state, with
    compress_dcn off and on; the resident step compressed beside it."""
    from repro_torch.data import local_rows
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    out = pathlib.Path(out_dir)
    init_gloo(rank, world, out)
    mesh = make_mesh(tb.MeshSpec(*MESH))
    cfg = get_smoke_config(ARCH)
    plan = sink_plan(tp, tb, cfg, _shape(tb), tb.MeshSpec(*MESH), tp.hwlib.DEFAULT)
    (out / f"port_plan_{rank}.json").write_text(_plan_json(plan))
    res = {}

    def run(name, cfg, init, c, p):
        tcfg = dataclasses.replace(
            _tcfg(lms=tb.LMSConfig(enabled=p is not None, hbm_budget=BUDGET),
                  ddl=tb.DDLConfig(compress_dcn=c)), model=cfg)
        step = tsteps.build_train_step(Model(cfg), tcfg, plan=p, mesh=mesh)
        state = tsteps.place_train_state(state_from_npz(init), p, "cpu")
        assert (state.grads is not None) == (p is not None)
        for i, b in enumerate(_batches(cfg.vocab_size)):
            rows = local_rows(b, mesh.dp_index, mesh.dp_size)
            state, met = step(state, {k: torch.from_numpy(v) for k, v in rows.items()})
            for k in ("loss", "ce", "grad_norm", "lr"):
                res[f"{name}/{k}/{i}"] = np.float32(met[k].item())
        res.update({f"{name}/master/{k}": v for k, v in flat_tree(state.opt.master).items()})
        res.update({f"{name}/params/{k}": v for k, v in flat_tree(state.params).items()})
    _wait_for(out / "init.npz")
    for name, c, p in (("compress=False", False, plan), ("compress=True", True, plan),
                       ("resident_compress", True, None)):
        run(name, cfg, out / "init.npz", c, p)
    ocfg = get_smoke_config(OLMO)
    oplan = sink_plan(tp, tb, ocfg, _shape(tb), tb.MeshSpec(*MESH), tp.hwlib.DEFAULT)
    (out / f"port_olmo_plan_{rank}.json").write_text(_plan_json(oplan))
    _wait_for(out / "olmo_init.npz")
    for name, p in ((f"{OLMO}/compress=True", oplan), (f"{OLMO}/resident_compress", None)):
        run(name, ocfg, out / "olmo_init.npz", True, p)
    np.savez(out / f"port_steps_{rank}.npz", **res)


def _hand_plan(cfg, grads: str, depth: int):
    res = {"params": "host", "grads": grads, "optimizer": "host", "kvcache": "device"}
    sched = tp.make_swap_schedule(res, cfg.num_layers, "train", prefetch_depth=depth)
    return tp.MemoryPlan(dict(OFFLOAD_ALL_BUT_MLP), res, 1, 1, 1, 1, True,
                         swap_schedule=sched, overlap_grads=True)


def _state_leaves(st):
    o = st.opt
    return [st.step, o.step] + [x for t in (st.params, o.mu, o.nu, o.master)
                                for x in tree_leaves(t)]


def _inline_put(self, i, grads, dst):
    """ReductionQueue.put with the layer reduced at once, in the backward
    (a test-only stand-in for the worker thread)."""
    self._step.count += 1
    self._reduce_into(i, grads, dst, self._step.squares)


def _port_bitwise(rank, world, out_dir):
    """(ii), (iii), (v): each variant's 3 steps from the port's init
    against the resident step from the same init, metrics and every state
    leaf bitwise; the swap counters of each variant's first step."""
    from repro_torch.data import local_rows
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    out = pathlib.Path(out_dir)
    init_gloo(rank, world, out / "bitwise")
    mesh = make_mesh(tb.MeshSpec(*MESH))
    cfg = get_smoke_config(ARCH)
    model = Model(cfg)
    batches = [{k: torch.from_numpy(v) for k, v in local_rows(b, mesh.dp_index,
                                                               mesh.dp_size).items()}
               for b in _batches(cfg.vocab_size)]

    def run(tcfg, plan, inline=False):
        state = tsteps.init_train_state(model, tcfg, 5, "cpu", plan=plan)
        step = tsteps.build_train_step(model, tcfg, plan=plan, mesh=mesh)
        put = overlap.ReductionQueue.put
        if inline:
            overlap.ReductionQueue.put = _inline_put
        try:
            mets, swaps = [], []
            for b in batches:
                before = off.swap_counters()
                state, met = step(state, b)
                swaps.append({k: v - before.get(k, 0) for k, v in off.swap_counters().items()})
                mets.append({k: v.item() for k, v in met.items()})
        finally:
            overlap.ReductionQueue.put = put
        return mets, state, swaps[0]

    refs = {}
    for c in (False, True):
        for ov in (False, True):
            refs[c, ov] = run(_tcfg(lms=tb.LMSConfig(enabled=False),
                                    ddl=tb.DDLConfig(compress_dcn=c, overlap_grads=ov)), None)
    res, runs = {}, {}
    stack_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(refs[True, True][1].params["decoder"]["stack0"]))
    for name, (c, ov, depth, grads, inline) in VARIANTS.items():
        plan = _hand_plan(cfg, grads, depth)
        mets, state, swap = run(_tcfg(lms=tb.LMSConfig(hbm_budget=BUDGET),
                                      ddl=tb.DDLConfig(compress_dcn=c, overlap_grads=ov)),
                                plan, inline)
        runs[name] = (mets, state)
        base_mets, base_state, _ = refs[c, ov]
        res[f"{name}/metrics_bitwise"] = mets == base_mets
        res[f"{name}/state_bitwise"] = all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(_state_leaves(base_state), _state_leaves(state)))
        res[f"{name}/sunk"] = state.grads is not None
        for d in ("in", "out"):
            res[f"{name}/grads_{d}"] = swap.get(f"lms.swap_{d}_bytes.grads", 0)
        res[f"{name}/params"] = {k: v.tolist() for k, v in flat_tree(state.params).items()}
    q_mets, q_state = runs["depth2_host"]
    i_mets, i_state = runs["inline_depth2_host"]
    res["queued_equals_inline"] = q_mets == i_mets and all(
        torch.equal(a, b) for a, b in zip(_state_leaves(q_state), _state_leaves(i_state)))
    res["stack_grads_bytes"] = stack_bytes
    (out / f"port_bitwise_{rank}.json").write_text(json.dumps(res))


def _port_trainer(rank, world, out_dir):
    """(vi): the Trainer under its own plan on this rank, from the JAX
    trainer's initial state placed as the plan says."""
    from repro_torch.train.trainer import Trainer
    out = pathlib.Path(out_dir)
    init_gloo(rank, world, out / "trainer")
    tcfg = dataclasses.replace(
        _tcfg(lms=tb.LMSConfig(hbm_budget=BUDGET),
              ddl=tb.DDLConfig(compress_dcn=True, overlap_grads=True)),
        warmup_steps=1, total_steps=3, log_every=2)
    trainer = Trainer(tcfg, device="cpu")
    (out / f"port_trainer_plan_{rank}.json").write_text(_plan_json(trainer.plan))
    _wait_for(out / "trainer_init.npz")
    trainer.init_state = lambda: tsteps.place_train_state(
        state_from_npz(out / "trainer_init.npz"), trainer.plan, "cpu")
    state, hist = trainer.train(steps=3)
    np.savez(out / f"port_trainer_{rank}.npz",
             **{f"{k}/{r['step']}": np.float64(r[k]) for r in hist
                for k in ("loss", "ce", "grad_norm", "lr")},
             **{f"params/{k}": v for k, v in flat_tree(state.params).items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every side at once: the JAX subprocess, the port's ranks for (i),
    (ii)-(iii)-(v) and (vi), and torchrun of the CLI (vii)."""
    out = tmp_path_factory.mktemp("lms_ddl")
    (out / "trainer").mkdir()
    (out / "bitwise").mkdir()
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--device", "cpu"]
        + CLI + ["--ckpt-dir", str(out / "port_cli_ckpt")], cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    procs = (start_jax(ME, "_jax_side", out, devices=2)
             + start_ranks(ME, "_port_steps", out, 2)
             + start_ranks(ME, "_port_bitwise", out, 2)
             + start_ranks(ME, "_port_trainer", out, 2) + [cli])
    outs = wait_all(procs, timeout=300)
    return out, outs[-1]


# ---------------------------------------------------------------------------
# (i) the step against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", [False, True])
def test_lms_ddl_step_matches_jax(runs, compress):
    """(i), ~40 s (the module's fixture, shared) + < 1 s: the same plan on
    both sides (grads on the host, params and optimizer streamed); per step
    loss, ce, grad norm and lr; after 3 steps the master weights (compressed:
    the 99th percentile as the module's note says); both ranks' params bitwise
    the same."""
    out, _ = runs
    jplan = json.loads((out / "jax_plan.json").read_text())
    for r in range(2):
        assert json.loads((out / f"port_plan_{r}.json").read_text()) == jplan
    assert jplan["residency"]["grads"] == "host" and jplan["overlap_grads"]
    jres = dict(np.load(out / "jax_steps.npz"))
    ranks = [dict(np.load(out / f"port_steps_{r}.npz")) for r in range(2)]
    v = f"compress={compress}"
    for i in range(STEPS):
        for k, tol in (("loss", 2e-3), ("ce", 2e-3), ("grad_norm", 2e-3), ("lr", 1e-6)):
            key = f"{v}/{k}/{i}"
            for r in range(2):
                assert _rel(ranks[r][key], jres[key]) <= tol, (key, r, ranks[r][key], jres[key])
    masters = sorted(k for k in jres if k.startswith(f"{v}/master/"))
    diff = np.concatenate([np.abs(ranks[0][k] - jres[k]).ravel() for k in masters])
    unit = LR * STEPS
    assert diff.max() <= 2 * unit + 1e-6, diff.max() / unit
    assert np.median(diff) <= 0.01 * unit, np.median(diff) / unit
    if compress:
        resident = [k.replace(v, "resident_compress") for k in masters]
        for side in (jres, ranks[0]):
            assert all(np.array_equal(side[k].view(np.int32), side[r].view(np.int32))
                       for k, r in zip(masters, resident))
    else:
        assert np.percentile(diff, 99) <= 0.1 * unit, np.percentile(diff, 99) / unit
    for k in ranks[0]:
        if k.startswith(f"{v}/params/") or k.startswith(f"{v}/master/"):
            assert np.array_equal(ranks[1][k].view(np.int32), ranks[0][k].view(np.int32)), k


def test_olmo_lms_ddl_step_matches_jax(runs):
    """(i) for olmo-1b (norm subtrees with no leaves, a tied embedding;
    compressed): the same sinking plan on both sides; per step loss, ce,
    grad norm and lr within (i)'s bounds; after 3 steps the master weights
    within 2 lr N (median 0.01 lr N); on each side the step under the
    plan equals the resident step bitwise; both ranks the same."""
    out, _ = runs
    jplan = json.loads((out / "jax_olmo_plan.json").read_text())
    for r in range(2):
        assert json.loads((out / f"port_olmo_plan_{r}.json").read_text()) == jplan
    assert jplan["residency"]["grads"] == "host" and jplan["overlap_grads"]
    jres = dict(np.load(out / "jax_steps.npz"))
    ranks = [dict(np.load(out / f"port_steps_{r}.npz")) for r in range(2)]
    v = f"{OLMO}/compress=True"
    for i in range(STEPS):
        for k, tol in (("loss", 2e-3), ("ce", 2e-3), ("grad_norm", 2e-3), ("lr", 1e-6)):
            key = f"{v}/{k}/{i}"
            for r in range(2):
                assert _rel(ranks[r][key], jres[key]) <= tol, (key, r, ranks[r][key], jres[key])
    masters = sorted(k for k in jres if k.startswith(f"{v}/master/"))
    assert any(k.endswith("@empty") for k in masters)
    diff = np.concatenate([np.abs(ranks[0][k] - jres[k]).ravel() for k in masters])
    unit = LR * STEPS
    assert diff.max() <= 2 * unit + 1e-6, diff.max() / unit
    assert np.median(diff) <= 0.01 * unit, np.median(diff) / unit
    resident = [k.replace(v, f"{OLMO}/resident_compress") for k in masters]
    for side in (jres, ranks[0]):
        assert all(np.array_equal(side[k].view(np.int32), side[r].view(np.int32))
                   for k, r in zip(masters, resident))
    for k in ranks[0]:
        if k.startswith(f"{v}/params/") or k.startswith(f"{v}/master/"):
            assert np.array_equal(ranks[1][k].view(np.int32), ranks[0][k].view(np.int32)), k


# ---------------------------------------------------------------------------
# (ii), (iii), (v) against the port's resident step
# ---------------------------------------------------------------------------

def _bitwise(runs):
    out, _ = runs
    return [json.loads((out / f"port_bitwise_{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_lms_ddl_equals_resident_ddl_bitwise(runs, variant):
    """(ii), the shared fixture + < 1 s: the LMS + DDL step (params and the
    optimizer streamed, five activation classes offloaded) against the
    resident DDL step with the same compress_dcn and overlap, 3 steps from
    one init: every metric and every state leaf bitwise, on both ranks;
    the replicas bitwise the same; grads sunk to the host when the plan
    says so."""
    ranks = _bitwise(runs)
    _, _, _, grads, _ = VARIANTS[variant]
    for r in ranks:
        assert r[f"{variant}/metrics_bitwise"] and r[f"{variant}/state_bitwise"]
        assert r[f"{variant}/sunk"] == (grads == "host")
    assert ranks[0][f"{variant}/params"] == ranks[1][f"{variant}/params"]


def test_queued_reduction_equals_inline_bitwise(runs):
    """(iii), the shared fixture + < 1 s: the queue's reductions on its worker
    thread against the same reductions issued inline in the backward
    (ReductionQueue.put patched in the test): every metric and state leaf
    bitwise, on both ranks."""
    assert all(r["queued_equals_inline"] for r in _bitwise(runs))


@pytest.mark.parametrize("variant", ["depth2_host", "serialized_host", "depth2_device"])
def test_grads_swap_counters(runs, variant):
    """(v), the shared fixture + < 1 s: a step moves the stack's grads out to
    the host once (the sink, or the placement after the tree pass) and back in
    once (the sweep): in and out each the stack's grads bytes, 2x together, as
    the planner prices `swap_bytes["grads"]`; nothing with the grads on the
    device."""
    for r in _bitwise(runs):
        n = r["stack_grads_bytes"]
        want = n if VARIANTS[variant][3] == "host" else 0
        assert r[f"{variant}/grads_in"] == r[f"{variant}/grads_out"] == want
        assert r[f"{variant}/grads_in"] + r[f"{variant}/grads_out"] == 2 * want


# ---------------------------------------------------------------------------
# (iv) the overlap's resolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["allreduce", "none", "zero1"])
@pytest.mark.parametrize("dp", [1, 2, 4])
def test_resolve_overlap_matches_jax(mode, dp):
    """(iv), ~3 s (the first imports JAX) or < 1 s: the port's
    `_resolve_overlap` against the JAX package's on every builder argument,
    DDLConfig knob and plan recommendation (no plan, a plan without one, True,
    False)."""
    jax_ref()
    from repro.train import steps as js
    for arg in (None, True, False):
        for knob in (None, True, False):
            for rec in ("no plan", None, True, False):
                plan = None if rec == "no plan" else types.SimpleNamespace(overlap_grads=rec)
                tcfg = types.SimpleNamespace(ddl=types.SimpleNamespace(mode=mode,
                                                                       overlap_grads=knob))
                assert tsteps._resolve_overlap(arg, plan, tcfg, dp) == \
                    js._resolve_overlap(arg, plan, tcfg, dp), (arg, knob, rec)


def test_ddl_for_matches_jax():
    """< 1 s: StepSpec.ddl_for against the JAX package's: a calibrated plan's
    tuned bucket stands in for bucket_mb=None, a bucket the user gave wins, an
    uncalibrated plan or none leaves the DDL config as it is."""
    jax_ref()
    from repro.config import base as jb
    from repro.train import steps as js
    for bucket in (None, 8):
        for plan in (None, types.SimpleNamespace(calibrated=False, tuned_bucket_mb=16),
                     types.SimpleNamespace(calibrated=True, tuned_bucket_mb=16),
                     types.SimpleNamespace(calibrated=True, tuned_bucket_mb=None)):
            got = tsteps.StepSpec(plan=plan).ddl_for(_tcfg(ddl=tb.DDLConfig(bucket_mb=bucket)))
            want = js.StepSpec(plan=plan).ddl_for(types.SimpleNamespace(
                ddl=jb.DDLConfig(bucket_mb=bucket)))
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (bucket, plan)


# ---------------------------------------------------------------------------
# (vi) the Trainer, (vii) the CLI
# ---------------------------------------------------------------------------

def test_trainer_on_2x1x1_under_a_plan_matches_jax_trainer(runs):
    """(vi), the shared fixture + < 1 s: the port's Trainer
    (LMSConfig(hbm_budget=600 kB), compress_dcn, the overlapped backward asked
    for) on 2 ranks against the JAX Trainer on 2 devices: the same plan, and
    from the same initial state each step's loss, ce and grad norm within 2e-3
    and the lr; both ranks' histories and params the same."""
    out, _ = runs
    jplan = json.loads((out / "jax_trainer_plan.json").read_text())
    assert jplan["swap_schedule"]["stream"] == ["params", "optimizer"]
    for r in range(2):
        assert json.loads((out / f"port_trainer_plan_{r}.json").read_text()) == jplan
    j = dict(np.load(out / "jax_trainer.npz"))
    ranks = [dict(np.load(out / f"port_trainer_{r}.npz")) for r in range(2)]
    for s in (1, 2, 3):
        for k in ("loss", "ce", "grad_norm"):
            assert _rel(ranks[0][f"{k}/{s}"], j[f"{k}/{s}"]) <= 2e-3, (k, s)
        assert _rel(ranks[0][f"lr/{s}"], j[f"lr/{s}"]) <= 1e-6 or j[f"lr/{s}"] == 0
    for k in ranks[0]:
        assert np.array_equal(ranks[1][k], ranks[0][k]), k


STEP_LINE = re.compile(r"^step +(\d+) \| loss ([\d.]+) \| gnorm ([\d.]+) \| lr ([\d.e+-]+) \| \d+ ms$")


def test_torchrun_cli_with_lms_matches_jax_launcher(runs):
    """(vii), the shared fixture + < 1 s: torchrun of the training CLI on 2 CPU
    ranks with LMS on (no --no-lms) prints the JAX launcher's step lines (same
    flags, 2 devices) once, from rank 0: the same steps and lrs, finite losses
    (the packages draw their random init differently) and the final-loss line."""
    out, cli_out = runs
    lines = cli_out.splitlines()
    steps = [STEP_LINE.match(x) for x in lines if x.startswith("step ")]
    jsteps = [STEP_LINE.match(x) for x in (out / "jax_cli.txt").read_text().splitlines()
              if x.startswith("step ")]
    assert all(steps) and all(jsteps)
    assert [m.group(1) for m in steps] == [m.group(1) for m in jsteps] == ["1", "2", "3"]
    for m, jm in zip(steps, jsteps):
        assert np.isfinite(float(m.group(2))) and np.isfinite(float(m.group(3)))
        assert m.group(4) == jm.group(4)
    assert sum(x.startswith("final loss: ") for x in lines) == 1


def test_stack_squares_equal_leaf_squares():
    """< 1 s: the per-slice sums of squares made from the layers as they come,
    in the backward's order, equal `leaf_squares` over each whole stacked
    leaf bitwise, where slices lie inside a layer, span two layers, or
    hold the whole leaf (the slice shrunk to 1000 elements so a small
    leaf has all three)."""
    from repro_torch.optim import adamw
    rng = np.random.default_rng(0)
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dt)
              for s, dt in (((5, 700), torch.bfloat16), ((5, 3), torch.float32),
                            ((5, 2300), torch.float32))]
    saved = adamw.SLICE
    adamw.SLICE = 1000
    try:
        sq = adamw.StackSquares([tuple(t.shape) for t in leaves])
        for i in reversed(range(5)):
            sq.add(i, [t[i] for t in leaves])
        got = sq.squares()
        want = [adamw.leaf_squares(t) for t in leaves]
    finally:
        adamw.SLICE = saved
    assert [len(g) for g in got] == [len(w) for w in want] == [4, 1, 12]
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
    assert torch.equal(adamw.norm_of(got), adamw.norm_of(want))
    with pytest.raises(RuntimeError, match="not every layer"):
        adamw.StackSquares([(2, 4)]).squares()


def _drain_within(queue, layers, timeout=30.0):
    """drain() on a helper thread, joined with a timeout. -> the exception
    drain raised, or None."""
    import threading
    got = []

    def run():
        try:
            queue.drain(layers)
        except Exception as e:
            got.append(e)
    t = threading.Thread(target=run)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "drain did not return"
    return got[0] if got else None


def test_reduction_queue_order_backpressure_and_errors():
    """~1 s: the queue under a tiny switch interval, 64 layers put at depth 1
    and 2: every layer reduced once, in the order put, each mean in its
    own slot; a reduction that raises is raised by drain and the layers
    after it are not reduced; after abandon the next step's queue opens."""
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for depth in (1, 2):
            order = []

            def reduce(tree):
                order.append(int(tree["w"][0]))
                return {"w": tree["w"] * 2}
            q = overlap.ReductionQueue(reduce)
            dst = torch.zeros(64, 3)
            q.open(torch.device("cpu"), depth)
            for i in range(64):
                q.put(i, {"w": torch.full((3,), float(i))}, {"w": dst[i]})
            assert _drain_within(q, 64) is None
            assert order == list(range(64))
            assert torch.equal(dst, 2 * torch.arange(64.0).repeat_interleave(3).view(64, 3))

        def failing(tree):
            if int(tree["w"][0]) == 3:
                raise ValueError("layer 3")
            order.append(int(tree["w"][0]))
            return tree
        order = []
        q = overlap.ReductionQueue(failing)
        q.open(torch.device("cpu"), 2)
        for i in range(8):
            q.put(i, {"w": torch.full((1,), float(i))}, {"w": torch.zeros(1)})
        err = _drain_within(q, 8)
        assert isinstance(err, ValueError) and order == [0, 1, 2]
        q.open(torch.device("cpu"), 2)
        q.put(0, {"w": torch.ones(1)}, {"w": torch.zeros(1)})
        q.abandon()
        q.open(torch.device("cpu"), 2)
        assert _drain_within(q, 0) is None
    finally:
        sys.setswitchinterval(saved)
