"""Tensor parallelism under LMS, in the Trainer, the launcher and
checkpoints, on the CPU:

* the LMS plan of a tensor-parallel mesh equal to the JAX package's field
  by field (1x1x2, 1x2x2, 2x1x2, at budgets that stream params and the
  optimizer and at one that does not);
* the tensor-parallel step under a plan that streams params and the
  optimizer from pinned host memory (2 ranks of 1x1x2, the planner's plan
  and a hand-made one at prefetch depth 1), and LMS + DDL under a plan
  that also sinks grads to the host with the overlapped backward (4 ranks
  of 1x2x2), each bitwise against the resident tensor-parallel step from
  the same init over 3 steps;
* the `Trainer` on 1x1x2 under its plan against the JAX `Trainer` on the
  same mesh of 2 emulated devices, from the same initial state: each
  step's loss, ce, grad norm and lr within 2e-3 relative (measured at most
  1.2e-4; the train step's bound, `test_torch_tp_train`);
* a checkpoint resume on 1x1x2 bitwise against an uninterrupted run, and
  that checkpoint restored on a mesh without the `model` axis equal to
  the blocks joined;
* `torchrun` of the training CLI on `--mesh 1x1x2` against the JAX
  launcher on 2 devices (the same step and lr lines, finite losses).
"""
import dataclasses
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_ddl import REPO, _env, init_gloo, start_jax, start_ranks, wait_all
from tests.test_torch_ddl_train import STEP_LINE, _wait_for, save_state
from tests.test_torch_ref import jax_pricing, jax_ref, jax_ref_scope  # noqa: F401
from tests.test_torch_tp_train import tp_state_from_npz

from repro_torch.config.base import (DDLConfig, LMSConfig, MeshSpec, ShapeConfig,
                                     TrainConfig)
from repro_torch.configs import get_smoke_config
from repro_torch.core.lms import planner as tp
from repro_torch.models.model import Model

ARCH = "qwen2.5-14b"
AXES = ("pod", "data", "model")
BUDGET = 400_000
STEPS, BATCH, SEQ = 3, 4, 16
CLI = ["--arch", ARCH, "--smoke", "--no-lms", "--mesh", "1x1x2", "--steps", "3",
       "--batch", "4", "--seq", "16"]
ME = "tests.test_torch_tp_lms"
# the hand-made plan's activation policy: every tagged class offloaded but
# the MLP's hidden, recomputed
POLICY = {"resid": "offload", "attn_norm": "offload", "qkv": "offload",
          "attn_out": "offload", "mlp_norm": "offload", "mlp_hidden": "remat"}


def _tcfg(shape, lms, **kw):
    return TrainConfig(model=get_smoke_config(ARCH),
                       shape=ShapeConfig("t", "train", SEQ, BATCH),
                       mesh=MeshSpec(shape, AXES), lms=lms,
                       **{"learning_rate": 1e-3, "warmup_steps": 1, "total_steps": 10,
                          "checkpoint_dir": None, **kw})


# ---------------------------------------------------------------------------
# (d) plans on a tensor-parallel mesh, and streamed steps bitwise resident
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [(1, 1, 2), (1, 2, 2), (2, 1, 2)])
def test_plan_matches_jax_on_tp_mesh(jax_pricing, mesh):
    """plan() of the smoke config on the mesh, at BUDGET (params and the
    optimizer on the host), at 2 MB and with the default budget: the
    MemoryPlan equal to the JAX package's field by field."""
    from tests.test_torch_lms import conv
    jax_ref()
    from repro.config import base as jb
    from repro.core.lms import planner as jp
    from repro import hw as jhw
    from repro.configs import get_smoke_config as jsmoke
    from repro_torch import hw as thw
    from repro_torch.config import base as tb
    jcfg = jsmoke(ARCH)
    # both sides price the port's card
    jcard = conv(thw.H100_SXM, jhw.HardwareSpec)
    for knobs in ({"hbm_budget": BUDGET}, {"hbm_budget": 2_000_000}, {}):
        for zero1 in (False, True):
            want = jp.plan(jp.PlanRequest(cfg=jcfg, shape=jb.ShapeConfig("t", "train", SEQ, BATCH),
                                          mesh=jb.MeshSpec(mesh, AXES), hw=jcard,
                                          lms=jb.LMSConfig(**knobs), zero1=zero1))
            got = tp.plan(tp.PlanRequest(cfg=conv(jcfg, tb.ModelConfig),
                                         shape=ShapeConfig("t", "train", SEQ, BATCH),
                                         mesh=MeshSpec(mesh, AXES), hw=thw.H100_SXM,
                                         lms=LMSConfig(**knobs), zero1=zero1))
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (mesh, knobs)
            if knobs.get("hbm_budget") == BUDGET:
                assert got.residency["params"] == got.residency["optimizer"] == "host"


def _hand_plan(cfg, grads: str, depth: int):
    res = {"params": "host", "grads": grads, "optimizer": "host", "kvcache": "device"}
    sched = tp.make_swap_schedule(res, cfg.num_layers, "train", prefetch_depth=depth)
    return tp.MemoryPlan(dict(POLICY), res, 1, 1, 1, 1, True, swap_schedule=sched,
                         overlap_grads=True)


def _leaves(st):
    from repro_torch.tree import tree_leaves
    o = st.opt
    return [st.step, o.step] + [x for t in (st.params, o.mu, o.nu, o.master)
                                for x in tree_leaves(t)]


def _run_steps(tcfg, plan, mesh, batches, seed=5):
    from repro_torch.data import local_rows
    from repro_torch.train.steps import build_train_step, init_train_state
    model = Model(tcfg.model)
    step = build_train_step(model, tcfg, plan=plan, mesh=mesh)
    state = init_train_state(model, tcfg, seed, "cpu", plan=plan, mesh=mesh)
    mets = []
    for b in batches:
        rows = local_rows(b, mesh.dp_index, mesh.dp_size)
        state, m = step(state, {k: torch.from_numpy(v) for k, v in rows.items()})
        mets.append([m[k].clone() for k in ("loss", "grad_norm", "ce")])
    return [t.clone() for t in _leaves(state)], mets


def _batches(vocab, n=STEPS, batch=BATCH):
    from repro_torch.data import SyntheticTokens
    data = SyntheticTokens(vocab, seed=3)
    return [data.batch(i, 0, 1, batch, SEQ) for i in range(n)]


def _bitwise(out, name, got, want):
    (gs, gm), (ws, wm) = got, want
    same = (len(gs) == len(ws) and all(torch.equal(a, b) for a, b in zip(gs, ws))
            and all(torch.equal(a, b) for x, y in zip(gm, wm) for a, b in zip(x, y)))
    out[name] = np.bool_(same)


def _port_streamed(rank, world, out_dir):
    """2 ranks of 1x1x2: the planner's plan at BUDGET and a hand-made one at
    depth 1 against the resident step; results into streamed_<rank>.npz."""
    from repro_torch.launch.mesh import make_mesh
    out = pathlib.Path(out_dir)
    init_gloo(rank, world, out / "streamed")
    mesh = make_mesh(MeshSpec((1, 1, 2), AXES))
    cfg = get_smoke_config(ARCH)
    batches = _batches(cfg.vocab_size)
    tcfg = _tcfg((1, 1, 2), LMSConfig(enabled=False))
    resident = _run_steps(tcfg, None, mesh, batches)
    res = {}
    planned = tp.plan(tp.PlanRequest(cfg=cfg, shape=tcfg.shape, mesh=tcfg.mesh,
                                     lms=LMSConfig(hbm_budget=BUDGET)))
    assert planned.swap_schedule.stream == ("params", "optimizer")
    _bitwise(res, "planner", _run_steps(tcfg, planned, mesh, batches), resident)
    _bitwise(res, "hand_depth1", _run_steps(tcfg, _hand_plan(cfg, "device", 1), mesh, batches),
             resident)
    np.savez(out / f"streamed_{rank}.npz", **res)


def _port_lms_ddl(rank, world, out_dir):
    """4 ranks of 1x2x2: LMS + DDL under a plan that sinks grads to the host
    with the overlapped backward, against the resident overlapped step."""
    from repro_torch.launch.mesh import make_mesh
    out = pathlib.Path(out_dir)
    init_gloo(rank, world, out / "lms_ddl")
    mesh = make_mesh(MeshSpec((1, 2, 2), AXES))
    cfg = get_smoke_config(ARCH)
    batches = _batches(cfg.vocab_size, batch=2 * BATCH)
    tcfg = _tcfg((1, 2, 2), LMSConfig(enabled=False), ddl=DDLConfig(overlap_grads=True))
    resident = _run_steps(tcfg, None, mesh, batches)
    res = {}
    for depth in (1, 2):
        _bitwise(res, f"sink_depth{depth}",
                 _run_steps(tcfg, _hand_plan(cfg, "host", depth), mesh, batches), resident)
    np.savez(out / f"lms_ddl_{rank}.npz", **res)


# ---------------------------------------------------------------------------
# the Trainer against the JAX Trainer; checkpoints; the CLI
# ---------------------------------------------------------------------------

def _jax_side(out_dir):
    """The JAX Trainer on (1, 1, 2) under its plan, and the JAX launcher."""
    ref = jax_ref()
    jax = ref.jax
    from repro.config import base as jb
    from repro.launch import train as jlaunch
    from repro.train import trainer as jtrainer
    out = pathlib.Path(out_dir)
    tcfg = jb.TrainConfig(
        model=ref.get_smoke_config(ARCH), shape=jb.ShapeConfig("t", "train", SEQ, BATCH),
        mesh=jb.MeshSpec((1, 1, 2), AXES), lms=jb.LMSConfig(hbm_budget=BUDGET),
        learning_rate=1e-3, warmup_steps=1, total_steps=3, checkpoint_dir=str(out / "jckpt"))
    trainer = jtrainer.Trainer(tcfg)
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


def _port_trainer(rank, world, out_dir):
    """The Trainer on 1x1x2 under its plan from the JAX trainer's initial
    state; then the checkpoint drill: 2 steps with a checkpoint, a new
    Trainer resuming to 4, against 4 steps without one; the checkpoint
    restored on one device against the blocks joined."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models import sharding as shd
    from repro_torch.train import steps as tsteps
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import tree_leaves
    out = pathlib.Path(out_dir)
    init_gloo(rank, world, out / "trainer")
    _wait_for(out / "trainer_init.npz")
    lms = LMSConfig(hbm_budget=BUDGET)
    tcfg = _tcfg((1, 1, 2), lms, total_steps=3)
    trainer = Trainer(tcfg, device="cpu")
    cfg = tcfg.model
    trainer.init_state = lambda: tsteps.place_train_state(
        tp_state_from_npz(out / "trainer_init.npz", cfg, trainer.mesh), trainer.plan, "cpu")
    _, hist = trainer.train(steps=3)
    res = {f"{k}/{r['step']}": np.float64(r[k]) for r in hist
           for k in ("loss", "ce", "grad_norm", "lr")}
    res["streams"] = np.array(trainer.plan.swap_schedule.stream == ("params", "optimizer"))

    # the checkpoint drill, from the port's own init
    ckpt = str(out / "ckpt")
    kw = dict(total_steps=4, checkpoint_every=2)
    Trainer(_tcfg((1, 1, 2), lms, checkpoint_dir=ckpt, **kw), device="cpu").train(steps=2)
    resumed = Trainer(_tcfg((1, 1, 2), lms, checkpoint_dir=ckpt, **kw), device="cpu")
    state, hist2 = resumed.train(steps=4)
    res["resumed_steps"] = np.array([r["step"] for r in hist2])
    straight, _ = Trainer(_tcfg((1, 1, 2), lms, **kw), device="cpu").train(steps=4)
    res["resume_bitwise"] = np.bool_(all(torch.equal(a, b) for a, b in
                                         zip(_leaves(state), _leaves(straight))))
    model = Model(cfg)
    specs = model.param_specs(resumed.mesh)
    joined = [shd.global_leaf(t, s, resumed.mesh)
              for tree in (state.params, state.opt.mu, state.opt.nu, state.opt.master)
              for t, s in zip(tree_leaves(tree), tree_leaves(specs))]
    if rank == 0:
        one = _tcfg((1, 1, 1), LMSConfig(enabled=False), checkpoint_dir=ckpt)
        with Checkpointer(ckpt).open(process=0) as reader:
            restored = tsteps.restore_train_state(reader, model, one, "cpu")
        got = [t for tree in (restored.params, restored.opt.mu, restored.opt.nu,
                              restored.opt.master) for t in tree_leaves(tree)]
        res["restore_global"] = np.bool_(
            len(got) == len(joined) and all(torch.equal(a, b) for a, b in zip(got, joined))
            and int(restored.step) == 4)
    np.savez(out / f"port_trainer_{rank}.npz", **res)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_lms")
    for sub in ("streamed", "lms_ddl", "trainer"):
        (out / sub).mkdir()
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--device", "cpu"]
        + CLI + ["--ckpt-dir", str(out / "port_cli_ckpt")], cwd=REPO, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = (start_jax(ME, "_jax_side", out, devices=2)
             + start_ranks(ME, "_port_streamed", out, 2)
             + start_ranks(ME, "_port_lms_ddl", out, 4)
             + start_ranks(ME, "_port_trainer", out, 2) + [cli])
    outs = wait_all(procs, timeout=300)
    return out, outs[-1]


@pytest.mark.parametrize("variant", ["planner", "hand_depth1"])
def test_tp_step_under_a_plan_is_resident_bitwise(runs, variant):
    """1x1x2: 3 steps with params and the optimizer streamed from pinned
    host memory equal the resident tensor-parallel steps bit for bit (every
    state leaf, loss, grad norm, ce), on both ranks."""
    out, _ = runs
    for r in range(2):
        assert dict(np.load(out / f"streamed_{r}.npz"))[variant], (variant, r)


@pytest.mark.parametrize("variant", ["sink_depth1", "sink_depth2"])
def test_tp_lms_ddl_with_a_grads_sink_is_resident_bitwise(runs, variant):
    """1x2x2, overlapped: params and the optimizer streamed and each
    layer's reduced grads sunk to pinned host memory by the reduction
    queue, bitwise the resident overlapped step, on all 4 ranks."""
    out, _ = runs
    for r in range(4):
        assert dict(np.load(out / f"lms_ddl_{r}.npz"))[variant], (variant, r)


def test_trainer_on_1x1x2_matches_jax_trainer(runs):
    """The port's Trainer under its plan on 2 ranks of 1x1x2 against the
    JAX Trainer on the same mesh: each step's loss, ce, grad norm and lr;
    both ranks' histories the same."""
    out, _ = runs
    j = dict(np.load(out / "jax_trainer.npz"))
    ranks = [dict(np.load(out / f"port_trainer_{r}.npz")) for r in range(2)]
    assert ranks[0]["streams"]
    for s in (1, 2, 3):
        for k in ("loss", "ce", "grad_norm"):
            rel = abs(ranks[0][f"{k}/{s}"] - j[f"{k}/{s}"]) / abs(j[f"{k}/{s}"])
            assert rel <= 2e-3, (k, s, rel)
        assert abs(ranks[0][f"lr/{s}"] - j[f"lr/{s}"]) <= 1e-6 * max(abs(j[f"lr/{s}"]), 1e-30)
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert ranks[1][f"{k}/{s}"] == ranks[0][f"{k}/{s}"]


def test_checkpoint_resume_on_1x1x2_is_bitwise(runs):
    """A run checkpointed at step 2 and resumed by a new Trainer to step 4
    ends with the uninterrupted run's state bit for bit on both ranks; the
    checkpoint restored on one device is the global state, the blocks
    joined."""
    out, _ = runs
    ranks = [dict(np.load(out / f"port_trainer_{r}.npz")) for r in range(2)]
    for res in ranks:
        assert list(res["resumed_steps"]) == [3, 4]
        assert res["resume_bitwise"]
    assert ranks[0]["restore_global"]


def test_torchrun_cli_on_1x1x2_matches_jax_launcher(runs):
    """torchrun of the training CLI on 2 CPU ranks of 1x1x2 prints the JAX
    launcher's step lines (same flags, 2 devices) once, from rank 0: the
    same steps and lrs, finite losses, one final-loss line."""
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
    assert re.search(r"final loss: [\d.]+", cli_out)
