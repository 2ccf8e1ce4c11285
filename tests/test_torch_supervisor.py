"""The port's Supervisor (src/repro_torch/runtime/supervisor.py) on the
CPU: the crash-recovery drill of tests/test_supervisor.py held bitwise
against the uninterrupted run, resident and under an LMS plan; the
restart budget; a dead attempt's checkpoint writer joined and its error
recorded; and, on 2 gloo ranks spawned as processes, the drill in zero1
mode under a plan (1x2x1) and in allreduce mode with the int8 pod hop
(2x1x1), the torn-commit window on one rank leaving no committed step, an
elastic restart from 2 ranks to 1 with the global batch kept, zero1's
reshard refused, and a JAX zero1 checkpoint of one process (2 emulated
devices) restored on 2 port ranks as each rank's block.

Inputs: the qwen2.5-14b smoke config (2 layers, d_model 64) trained from
the trainer's seed on the synthetic stream, 2 x 16 tokens a step on one
rank, 4 x 16 on a mesh. Tolerances: a resumed run replays the same
batches from the same state through the same code, so the drills are
bitwise (losses, grad norms, every param and optimizer leaf). The elastic
restart changes the mesh (one rank, 2 microbatches: sums in another
order), so its final loss is held within the JAX test's 5e-2 relative of
the uninterrupted 2-rank run's, and bitwise against a hand-built restore
of the same checkpoint on the new mesh.
"""
import dataclasses
import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

from tests.test_torch_ddl import start_jax, start_ranks, wait_all
from tests.test_torch_ddl_train import _wait_for
from tests.test_torch_ref import jax_ref, jax_ref_scope  # noqa: F401 (autouse fixture)

from repro_torch.config import base as tb
from repro_torch.configs import get_smoke_config
from repro_torch.core.lms import offload as off
from repro_torch.runtime import (FaultEvent, FaultInjector, FaultPlan, InjectedFault,
                                 RestartBudgetExhausted, RestartPolicy, Supervisor)
from repro_torch.train.trainer import Trainer
from repro_torch.tree import tree_leaves

ARCH = "qwen2.5-14b"
ME = "tests.test_torch_supervisor"
SEQ = 16
LMS_PLAN = tb.LMSConfig(hbm_budget=600_000)


def _tcfg(ckpt_dir, steps=6, mesh=((1, 1), ("data", "model")), batch=2, **kw):
    return tb.TrainConfig(model=get_smoke_config(ARCH), shape=tb.ShapeConfig("t", "train", SEQ,
                                                                             batch),
                          mesh=tb.MeshSpec(*mesh), lms=kw.pop("lms", tb.LMSConfig(enabled=False)),
                          ddl=kw.pop("ddl", tb.DDLConfig(mode="none")),
                          learning_rate=5e-3, warmup_steps=2, total_steps=steps,
                          checkpoint_dir=None if ckpt_dir is None else str(ckpt_dir),
                          checkpoint_every=2, **kw)


def _policy(**kw):
    return RestartPolicy(**{"max_restarts": 3, "backoff_base": 0.0, "jitter": False, **kw})


def _leaves(state):
    """Every param and optimizer leaf of a TrainState or Zero1State."""
    if hasattr(state, "opt"):
        return tree_leaves({"params": state.params, "opt": dict(state.opt._asdict())})
    return tree_leaves(state.params) + [state.mu, state.nu, state.master, state.step]


def _drill(tcfg, steps, at=3, **sup):
    """The uninterrupted run (no checkpoints), then the Supervisor over a
    run killed before step at + 1 with async checkpoints every 2 steps.
    -> (result, {check: bool})."""
    state0, hist0 = Trainer(dataclasses.replace(tcfg, checkpoint_dir=None),
                            device="cpu").train(steps=steps)
    state0 = [t.clone() for t in _leaves(state0)]
    off.release_arenas()
    inj = FaultInjector(FaultPlan([FaultEvent("trainer.step", at=at)]))
    s = Supervisor(tcfg, device="cpu", policy=_policy(), injector=inj,
                   sleep_fn=lambda d: None, **sup)
    res = s.run(steps=steps)
    checks = {
        "attempts": (res.attempts, res.restarts) == (2, 1),
        "steps": [r["step"] for r in res.hist] == list(range(1, steps + 1)),
        "loss": [r["loss"] for r in res.hist] == [r["loss"] for r in hist0],
        "grad_norm": [r["grad_norm"] for r in res.hist] == [r["grad_norm"] for r in hist0],
        "leaves": all(a.dtype == b.dtype and torch.equal(a, b)
                      for a, b in zip(_leaves(res.state), state0)),
        # every 2 steps and the last, keep=3
        "committed": s.trainer.ckpt.all_steps() == sorted({*range(2, steps + 1, 2), steps})[-3:]}
    return res, checks


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def test_supervisor_no_fault_single_attempt(tmp_path):
    sup = Supervisor(_tcfg(tmp_path, steps=4), device="cpu", policy=_policy(),
                     sleep_fn=lambda d: None)
    res = sup.run(steps=4)
    assert res.attempts == 1 and res.restarts == 0 and not res.left
    assert [m["step"] for m in res.hist] == [1, 2, 3, 4]


@pytest.mark.parametrize("lms", [tb.LMSConfig(enabled=False), LMS_PLAN],
                         ids=["resident", "planned"])
def test_supervisor_crash_recovery_equals_uninterrupted(tmp_path, lms):
    """Killed before step 4 (step 2's checkpoint written asynchronously
    while step 3 ran): the Supervisor restores step 2 (under the plan into
    the pinned placement again), replays 3-4, finishes 6, and every step's
    loss and grad norm and every leaf at the end equal the uninterrupted
    run's bitwise."""
    res, checks = _drill(_tcfg(tmp_path / "sup", lms=lms), steps=6)
    assert all(checks.values()), checks


def test_supervisor_restart_budget_exhausts(tmp_path):
    inj = FaultInjector(FaultPlan([FaultEvent("trainer.step", at=0, times=100)]))
    sup = Supervisor(_tcfg(tmp_path, steps=4), device="cpu", policy=_policy(max_restarts=2),
                     injector=inj, sleep_fn=lambda d: None)
    with pytest.raises(RestartBudgetExhausted) as ei:
        sup.run(steps=4)
    assert ei.value.__cause__ is not None
    assert ei.value.__cause__.site == "trainer.step"


def test_supervisor_counts_healthy_steps_into_policy(tmp_path):
    inj = FaultInjector(FaultPlan([FaultEvent("trainer.step", at=2)]))
    pol = _policy(stable_steps=3)
    sup = Supervisor(_tcfg(tmp_path, steps=6), device="cpu", policy=pol, injector=inj,
                     sleep_fn=lambda d: None)
    res = sup.run(steps=6)
    assert res.restarts == 1
    assert pol.restarts == 0, "3+ healthy steps after restart refund budget"


def test_supervisor_joins_a_dead_attempts_writer(tmp_path, monkeypatch):
    """Before the next attempt the Supervisor joins the dead attempt's
    checkpoint writer. A writer that died of a caught fault (its commit
    window) is part of the same failure: recorded in the notes and as a
    sup.writer_error instant, nothing committed, the attempt's trainer
    dropped. A writer that died of anything else propagates."""
    from repro_torch.checkpoint import checkpointer as ckmod
    tcfg = _tcfg(tmp_path / "sup", steps=2)
    inj = FaultInjector(FaultPlan([FaultEvent("ckpt.commit", at=0)]))
    sup = Supervisor(tcfg, device="cpu", policy=_policy(), injector=inj,
                     sleep_fn=lambda d: None)
    fault = InjectedFault("trainer.step", FaultEvent("trainer.step", at=0), 0)
    sup.trainer = Trainer(tcfg, device="cpu", injector=inj, obs=sup.obs)
    sup.trainer.ckpt.save(1, {"w": torch.zeros(3)})     # async: dies in its window
    ckpt, notes = sup.trainer.ckpt, []
    sup._recover(fault, 1, notes)
    assert sup.trainer is None and ckpt._thread is None
    assert notes == ["attempt 1: checkpoint writer failed: injected fault at ckpt.commit "
                     "(call 0): raise"]
    assert "sup.writer_error" in [e.site for e in sup.obs.ring.events()]
    assert ckpt.all_steps() == []

    def broken(path, arrays):
        raise OSError("disk gone")
    monkeypatch.setattr(ckmod, "write_npz", broken)
    sup.trainer = Trainer(tcfg, device="cpu", obs=sup.obs)
    sup.trainer.ckpt.save(1, {"w": torch.zeros(3)})
    with pytest.raises(OSError, match="disk gone"):
        sup._recover(fault, 2, notes)


# ---------------------------------------------------------------------------
# 2 gloo ranks
# ---------------------------------------------------------------------------

def _init(rank, world, path):
    import datetime
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=90))


DRILLS = {
    # zero1 on 1x2x1 under the 600 kB plan: params streamed, the flat
    # AdamW shard in host memory
    "zero1_planned": dict(mesh=((1, 2, 1), ("pod", "data", "model")), lms=LMS_PLAN,
                          ddl=tb.DDLConfig(mode="zero1")),
    "allreduce_compress": dict(mesh=((2, 1, 1), ("pod", "data", "model")),
                               ddl=tb.DDLConfig(mode="allreduce", compress_dcn=True)),
}


def _ranks_drills(rank, world, out_dir):
    """Pair A: the drill in each DRILLS mode, bitwise against the
    uninterrupted run; then zero1's reshard refused; then the JAX zero1
    checkpoint restored as this rank's block."""
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models.model import Model
    from repro_torch.train import steps as tsteps
    out = pathlib.Path(out_dir)
    _init(rank, world, out / "pg_a")
    res = {}
    for name, kw in DRILLS.items():
        _, checks = _drill(_tcfg(out / f"ckpt_{name}", steps=5, batch=4, **kw), steps=5)
        res[name] = checks
    inj = FaultInjector(FaultPlan([FaultEvent("trainer.step", at=3,
                                              payload={"lost_devices": 1})]))
    sup = Supervisor(_tcfg(out / "ckpt_z1_reshard", steps=5, batch=4,
                           **DRILLS["zero1_planned"]), device="cpu", policy=_policy(),
                     injector=inj, sleep_fn=lambda d: None, devices_available=2)
    try:
        sup.run(steps=5)
        res["zero1_reshard"] = "no error"
    except RuntimeError as e:
        res["zero1_reshard"] = str(e)
    # the JAX package's zero1 checkpoint of one process on (1, 2, 1)
    jdir = out / "jax_z1"
    _wait_for(out / "jax_done.json")
    tcfg = _tcfg(jdir, steps=2, batch=4, mesh=((1, 2, 1), ("pod", "data", "model")),
                 ddl=tb.DDLConfig(mode="zero1"))
    model = Model(tcfg.model)
    with Checkpointer(str(jdir)).open() as reader:
        got = tsteps.restore_zero1_state(reader, model, tcfg, "cpu", 2, data_index=rank)
    z = np.load(jdir / "step_00000002" / "shard_0.npz")
    n = got.master.numel()
    res["jax_zero1"] = {
        "num_processes": reader.num_processes,
        "blocks": all(np.array_equal(z[k][rank * n:(rank + 1) * n], getattr(got, k).numpy())
                      for k in ("mu", "nu", "master")),
        "params": all(np.array_equal(z[("BF16::" if p.dtype == torch.bfloat16 else "")
                                       + "params/" + k],
                                     p.view(torch.int16).numpy().view(np.uint16)
                                     if p.dtype == torch.bfloat16 else p.numpy())
                      for k, p in _flat_params(got.params).items()),
        "step": int(got.step) == 2}
    dist.destroy_process_group()
    (out / f"drills_{rank}.json").write_text(json.dumps(res))


def _flat_params(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat_params(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _ranks_torn(rank, world, out_dir):
    """Pair B: allreduce on 2x1x1, async checkpoints every 2 steps, and
    rank 1's writer dies in its commit window of step 2 (rank 0's does
    not): each rank records how its run ended; rank 1 then exits, which
    ends rank 0's wait at the second barrier."""
    out = pathlib.Path(out_dir)
    _init(rank, world, out / "pg_b")
    plan = [FaultEvent("ckpt.commit", at=0)] if rank == 1 else []
    trainer = Trainer(_tcfg(out / "ckpt_torn", steps=4, batch=4,
                            mesh=((2, 1, 1), ("pod", "data", "model")),
                            ddl=tb.DDLConfig(mode="allreduce")),
                      device="cpu", injector=FaultInjector(FaultPlan(plan)))
    try:
        trainer.train(steps=4)
        ended = "finished"
    except InjectedFault as e:
        ended = f"injected {e.site}"
    except RuntimeError as e:       # the peer's exit, seen by gloo
        ended = f"runtime error: {type(e).__name__}"
    (out / f"torn_{rank}.json").write_text(json.dumps({"ended": ended}))


def _ranks_elastic(rank, world, out_dir):
    """Pair C: allreduce on a 2x1 (data) mesh, 6 steps; the uninterrupted
    run, then the Supervisor with a fault before step 4 that takes one
    device: rank 1 leaves, rank 0 restores step 2 on 1x1 with 2
    microbatches and finishes; then rank 0 restores the same checkpoint
    by hand on that mesh (the oracle)."""
    import torch.distributed as dist
    out = pathlib.Path(out_dir)
    _init(rank, world, out / "pg_c0")
    mesh = ((2, 1), ("data", "model"))
    _, hist0 = Trainer(_tcfg(None, steps=6, batch=4, mesh=mesh,
                             ddl=tb.DDLConfig(mode="allreduce")), device="cpu").train(steps=6)
    inj = FaultInjector(FaultPlan([FaultEvent("trainer.step", at=3,
                                              payload={"lost_devices": 1})]))
    sup = Supervisor(_tcfg(out / "ckpt_elastic", steps=6, batch=4, mesh=mesh,
                           ddl=tb.DDLConfig(mode="allreduce")),
                     device="cpu", policy=_policy(), injector=inj, sleep_fn=lambda d: None,
                     rendezvous=lambda attempt: f"file://{out}/pg_c{attempt}")
    res = sup.run(steps=6)
    row = {"left": res.left, "restarts": res.restarts, "notes": res.notes,
           "mesh": list(res.tcfg.mesh.shape), "microbatches": res.tcfg.microbatches,
           "steps": [r["step"] for r in res.hist], "loss": [r["loss"] for r in res.hist],
           "loss0": [r["loss"] for r in hist0], "pg": dist.is_initialized()}
    if rank == 0:
        oracle = out / "ckpt_oracle"
        oracle.mkdir()
        shutil.copytree(out / "ckpt_elastic" / "step_00000002", oracle / "step_00000002")
        _, horacle = Trainer(dataclasses.replace(res.tcfg, checkpoint_dir=str(oracle)),
                             device="cpu").train(steps=6)
        row["oracle"] = [r["loss"] for r in horacle]
    (out / f"elastic_{rank}.json").write_text(json.dumps(row))


def _jax_side(out_dir):
    """The JAX Trainer, zero1 on (1, 2, 1) over 2 emulated devices, 2
    steps, checkpointed as one process."""
    jax_ref()
    from repro.config import base as jb
    from repro.train import trainer as jtrainer
    out = pathlib.Path(out_dir)
    tcfg = jb.TrainConfig(
        model=jax_ref().get_smoke_config(ARCH), shape=jb.ShapeConfig("t", "train", SEQ, 4),
        mesh=jb.MeshSpec((1, 2, 1), ("pod", "data", "model")),
        lms=jb.LMSConfig(enabled=False), ddl=jb.DDLConfig(mode="zero1"),
        learning_rate=5e-3, warmup_steps=2, total_steps=2,
        checkpoint_dir=str(out / "jax_z1"), checkpoint_every=2, async_checkpoint=False)
    jtrainer.Trainer(tcfg).train(steps=2)
    (out / "jax_done.json").write_text("{}")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every multi-process drill at once: the JAX side (2 emulated
    devices) and three pairs of gloo ranks."""
    out = tmp_path_factory.mktemp("supervisor")
    procs = (start_jax(ME, "_jax_side", out, devices=2)
             + start_ranks(ME, "_ranks_drills", out, 2)
             + start_ranks(ME, "_ranks_torn", out, 2)
             + start_ranks(ME, "_ranks_elastic", out, 2))
    wait_all(procs, timeout=420)
    return out


def _rows(out, name):
    return [json.loads((out / f"{name}_{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("mode", list(DRILLS))
def test_two_rank_drill_equals_uninterrupted(ranks, mode):
    """zero1 under a plan (params streamed, the flat AdamW shard in host
    memory, each rank's blocks in its own shard) and allreduce with the
    int8 pod hop (the replicated state written once): killed before step
    4, restored from step 2 on both ranks, bitwise the uninterrupted run
    on each rank."""
    for row in _rows(ranks, "drills"):
        assert all(row[mode].values()), row[mode]


def test_torn_commit_on_one_rank_leaves_no_committed_step(ranks):
    """Rank 1 dies between its shard write and the commit: its error
    surfaces on rank 1 at the next wait, rank 0's run ends too, and step
    2 (shards written, directory in place) has no manifest: nothing is
    committed."""
    from repro_torch.checkpoint import Checkpointer
    rows = _rows(ranks, "torn")
    assert rows[1]["ended"] == "injected ckpt.commit"
    assert rows[0]["ended"] != "finished"
    step2 = ranks / "ckpt_torn" / "step_00000002"
    assert (step2 / "shard_0.npz").exists() and not (step2 / "manifest.json").exists()
    assert Checkpointer(str(ranks / "ckpt_torn")).all_steps() == []


def test_elastic_restart_two_ranks_to_one(ranks):
    """Rank 1 leaves; rank 0 finishes on 1x1 with 2 microbatches (the
    global batch kept), its steps 1-6 once each, the final loss within
    5e-2 of the uninterrupted 2-rank run's and bitwise the oracle's; the
    survivor's process group is gone (a mesh of one needs none)."""
    rows = _rows(ranks, "elastic")
    assert rows[1]["left"] and not rows[0]["left"]
    r0 = rows[0]
    assert r0["restarts"] == 1 and "data axis 2->1" in r0["notes"][0]
    assert r0["mesh"] == [1, 1] and r0["microbatches"] == 2 and not r0["pg"]
    assert r0["steps"] == [1, 2, 3, 4, 5, 6]
    assert r0["loss"][:3] == r0["loss0"][:3]
    np.testing.assert_allclose(r0["loss"][-1], r0["loss0"][-1], rtol=5e-2)
    assert r0["loss"][2:] == r0["oracle"]


def test_zero1_reshard_refused(ranks):
    for row in _rows(ranks, "drills"):
        assert "zero1" in row["zero1_reshard"] and "cannot reshard" in row["zero1_reshard"]


def test_jax_zero1_checkpoint_restores_as_each_ranks_block(ranks):
    """The JAX Trainer's zero1 checkpoint of one process (global flat mu,
    nu and master) restores on each of 2 port ranks as its block of them,
    bitwise, with the params bitwise (bf16 from its bits)."""
    for row in _rows(ranks, "drills"):
        assert row["jax_zero1"] == {"num_processes": 1, "blocks": True, "params": True,
                                    "step": True}
