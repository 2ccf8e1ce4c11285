"""The port's Checkpointer (src/repro_torch/checkpoint) on the CPU: the
JAX package's checkpoint tests (tests/test_checkpoint.py) and its
checkpoint crash drills (tests/test_fault_inject.py) on the port's
tensors; checkpoints written by either package restored by the other,
bitwise, bf16 included; the member-by-member reader; the snapshot a save
takes of a state that the next step updates in place; restore into a
plan's placement; the port's Trainer resuming from a JAX Trainer's
checkpoint, both continuing to step 4; and the trained states of
olmo-1b (norm subtrees with no leaves, a tied embedding) through either
package's checkpoints, bitwise both ways.

Inputs are made from a numpy seed (states) or by the trainers from their
seeds (the qwen2.5-14b smoke config, 2 layers, d_model 64). Tolerances:
checkpoint round trips are bitwise (the same bytes written and read). The
resumed runs of the two packages are held at tests/test_torch_train.py's
step tolerance, for its reasons (bf16 rounded at other places): loss, ce
and grad norm within 2e-3 relative.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

from tests.test_torch_ref import jax_ref, jax_ref_scope  # noqa: F401 (autouse fixture)

from repro_torch.checkpoint import Checkpointer, checkpointer as ckmod
from repro_torch.config.base import (DDLConfig, LMSConfig, MeshSpec, ShapeConfig,
                                     TrainConfig)
from repro_torch.configs import get_smoke_config
from repro_torch.core.lms import offload as off
from repro_torch.runtime import FaultEvent, FaultInjector, FaultPlan, InjectedFault
from repro_torch.train import steps as tsteps
from repro_torch.train.trainer import Trainer
from repro_torch.tree import tree_leaves

ARCH = "qwen2.5-14b"


@pytest.fixture
def tmpdir(tmp_path):
    return str(tmp_path / "ckpt")


def _state(seed=0):
    """The JAX test's state on the port's tensors: an f32 matrix, a bf16
    vector, a list and an int32 scalar."""
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32)),
                       "b": torch.from_numpy(rng.standard_normal(4).astype(np.float32))
                       .to(torch.bfloat16)},
            "opt": {"mu": [torch.zeros(3), torch.ones(2)],
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _same(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py on the port
# ---------------------------------------------------------------------------

def test_roundtrip(tmpdir):
    ck = Checkpointer(tmpdir, async_save=False)
    st = _state()
    ck.save(10, st, extra={"data_state": {"epoch": 1, "step_in_epoch": 5, "seed": 0}})
    step, restored, extra = ck.restore()
    assert step == 10
    assert _same(restored["params"]["w"], st["params"]["w"])
    assert _same(restored["params"]["b"], st["params"]["b"])
    assert isinstance(restored["opt"]["mu"], list)
    assert all(_same(a, b) for a, b in zip(restored["opt"]["mu"], st["opt"]["mu"]))
    assert _same(restored["opt"]["step"], st["opt"]["step"])
    assert extra["data_state"]["step_in_epoch"] == 5


def test_atomic_commit(tmpdir):
    ck = Checkpointer(tmpdir, async_save=False)
    ck.save(1, _state())
    torn = os.path.join(tmpdir, "step_00000002")
    os.makedirs(torn)
    np.savez(os.path.join(torn, "shard_0.npz"), x=np.zeros(3))
    assert ck.latest_step() == 1
    step, _, _ = ck.restore()
    assert step == 1


def test_gc_keeps_last_k(tmpdir):
    ck = Checkpointer(tmpdir, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ck.save(s, _state(s))
    assert ck.all_steps() == [3, 4]


def test_gc_keep_zero_means_keep_all(tmpdir):
    ck = Checkpointer(tmpdir, keep=0, async_save=False)
    for s in (1, 2, 3):
        ck.save(s, _state(s))
    assert ck.all_steps() == [1, 2, 3]
    assert ck.latest_step() == 3
    ck_neg = Checkpointer(tmpdir, keep=-1, async_save=False)
    ck_neg.save(4, _state(4))
    assert ck_neg.all_steps() == [1, 2, 3, 4]


def test_keep_validated_in_init(tmpdir):
    with pytest.raises(TypeError):
        Checkpointer(tmpdir, keep="3")
    with pytest.raises(TypeError):
        Checkpointer(tmpdir, keep=True)


def test_async_save_waits(tmpdir):
    ck = Checkpointer(tmpdir, async_save=True)
    ck.save(5, _state())
    ck.wait()
    assert ck.latest_step() == 5


def test_torn_manifest_is_invisible(tmpdir):
    ck = Checkpointer(tmpdir, async_save=False)
    ck.save(1, _state(1))
    ck.save(2, _state(2))
    with open(os.path.join(tmpdir, "step_00000002", "manifest.json"), "w") as f:
        f.write('{"step": 2, "keys": [')
    assert ck.all_steps() == [1]
    assert ck.latest_step() == 1
    step, restored, _ = ck.restore()
    assert step == 1
    assert _same(restored["params"]["w"], _state(1)["params"]["w"])


def test_restore_falls_back_past_unreadable_shard(tmpdir):
    """A truncated shard hides its step from latest-mode restore and from
    `open` (the reader the trainer resumes through); an explicit request
    for it raises; nothing readable at all is a clear error."""
    ck = Checkpointer(tmpdir, keep=5, async_save=False)
    ck.save(1, _state(1))
    ck.save(2, _state(2))
    with open(os.path.join(tmpdir, "step_00000002", "shard_0.npz"), "r+b") as f:
        f.truncate(16)
    step, restored, _ = ck.restore()
    assert step == 1
    assert _same(restored["params"]["w"], _state(1)["params"]["w"])
    with ck.open() as reader:
        assert reader.step == 1
    with pytest.raises(Exception):
        ck.restore(step=2)
    with pytest.raises(Exception):
        ck.open(step=2)
    with open(os.path.join(tmpdir, "step_00000001", "shard_0.npz"), "r+b") as f:
        f.truncate(16)
    with pytest.raises(FileNotFoundError, match="no readable"):
        ck.restore()
    with pytest.raises(FileNotFoundError, match="no readable"):
        ck.open()


def test_restore_specific_step(tmpdir):
    ck = Checkpointer(tmpdir, keep=5, async_save=False)
    ck.save(1, _state(1))
    ck.save(2, _state(2))
    step, restored, _ = ck.restore(step=1)
    assert step == 1
    assert _same(restored["params"]["w"], _state(1)["params"]["w"])


# ---------------------------------------------------------------------------
# the crash drills of tests/test_fault_inject.py
# ---------------------------------------------------------------------------

def test_ckpt_crash_before_write(tmp_path):
    inj = FaultInjector(FaultPlan([FaultEvent("ckpt.save", at=0)]))
    ck = Checkpointer(str(tmp_path), async_save=False, injector=inj)
    with pytest.raises(InjectedFault):
        ck.save(1, _state(1))
    assert ck.latest_step() is None
    assert not any(n.startswith("step_") for n in os.listdir(tmp_path))


def test_ckpt_crash_between_shard_and_commit(tmp_path):
    """The async writer dies after the shard is in place, before the
    manifest: the error surfaces at the next wait(), the step is
    invisible, and restore lands on the previous committed step."""
    inj = FaultInjector(FaultPlan([FaultEvent("ckpt.commit", at=1)]))
    ck = Checkpointer(str(tmp_path), async_save=True, injector=inj)
    ck.save(1, _state(1))
    ck.wait()
    ck.save(2, _state(2))
    with pytest.raises(InjectedFault):
        ck.wait()
    step2 = tmp_path / "step_00000002"
    assert (step2 / "shard_0.npz").exists()
    assert not (step2 / "manifest.json").exists()
    assert ck.all_steps() == [1]
    step, restored, _ = ck.restore()
    assert step == 1 and int(restored["opt"]["step"]) == 7


def test_ckpt_async_error_surfaces_at_next_save(tmp_path):
    inj = FaultInjector(FaultPlan([FaultEvent("ckpt.commit", at=0)]))
    ck = Checkpointer(str(tmp_path), async_save=True, injector=inj)
    ck.save(1, _state(1))
    with pytest.raises(InjectedFault):
        ck.save(2, _state(2))


def test_save_records_its_span_and_commit(tmp_path):
    from repro_torch.obs import get_obs
    ck = Checkpointer(str(tmp_path), async_save=True)
    before = len(get_obs().ring.events())
    ck.save(3, _state())
    ck.wait()
    new = get_obs().ring.events()[before:]
    spans = [e for e in new if e.site == "ckpt.save"]
    commits = [e for e in new if e.site == "ckpt.commit"]
    assert len(spans) == 1 and spans[0].attrs["step"] == 3 and spans[0].attrs["bytes"] > 0
    assert len(commits) == 1 and commits[0].attrs["step"] == 3
    assert ck.last["step"] == 3 and ck.last["write_s"] >= 0 and ck.last["block_s"] >= 0


# ---------------------------------------------------------------------------
# both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    return jax_ref()


def _jax_state(ref, seed=0):
    jnp = ref.jnp
    rng = np.random.default_rng(seed)
    return {"params": {"w": jnp.asarray(rng.standard_normal((4, 5)), jnp.float32),
                       "b": jnp.asarray(rng.standard_normal(7), jnp.bfloat16),
                       "empty": {}},
            "opt": {"mu": [jnp.zeros(3), jnp.arange(2, dtype=jnp.int32)],
                    "pair": (jnp.float32(2.5), jnp.ones((2, 2), jnp.bfloat16)),
                    "step": jnp.int32(7)}}


def _bits(x) -> np.ndarray:
    """A leaf's bytes as uint8, whatever package and dtype."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).split(".")[-1]
    return np.asarray(x).dtype.name


def _same_tree(a, b):
    """Same structure (dict / list / tuple), every leaf the same dtype,
    shape and bytes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)) and not hasattr(a, "shape"):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert _dtype_name(a) == _dtype_name(b)
        assert tuple(np.shape(a)) == tuple(b.shape)
        assert np.array_equal(_bits(a), _bits(b))


def test_jax_checkpoint_restores_in_the_port_bitwise(ref, tmp_path):
    """A checkpoint the JAX package's Checkpointer wrote (async, with
    extra) restores in the port: the same tree, dicts, lists, tuples and
    empty dicts, each leaf's dtype (bf16 from its bits) and bytes."""
    from repro.checkpoint import Checkpointer as JaxCheckpointer
    jck = JaxCheckpointer(str(tmp_path), async_save=True)
    jstate = _jax_state(ref)
    jck.save(4, jstate, extra={"data_state": {"epoch": 0, "step_in_epoch": 4, "seed": 0}})
    jck.wait()
    step, state, extra = Checkpointer(str(tmp_path)).restore()
    assert step == 4 and extra["data_state"]["step_in_epoch"] == 4
    _same_tree(ref.jax.tree.map(np.asarray, jstate), state)


def test_port_checkpoint_restores_in_jax_bitwise(ref, tmp_path):
    """The reverse: the port's async checkpoint of the same tree (torch
    tensors, bf16 written from an int16 view) restores in the JAX
    package as the JAX tree, bf16 as ml_dtypes bfloat16; the manifest
    keys are the JAX package's."""
    from repro.checkpoint import Checkpointer as JaxCheckpointer
    jstate = ref.jax.tree.map(np.asarray, _jax_state(ref))

    def to_torch(x):
        if isinstance(x, dict):
            return {k: to_torch(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)) and not hasattr(x, "shape"):
            return type(x)(to_torch(v) for v in x)
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(x))
    ck = Checkpointer(str(tmp_path / "port"), async_save=True)
    ck.save(6, to_torch(jstate), extra={"data_state": {"epoch": 0, "step_in_epoch": 6,
                                                       "seed": 0}})
    ck.wait()
    jck = JaxCheckpointer(str(tmp_path / "port"))
    step, restored, extra = jck.restore()
    assert step == 6 and extra["data_state"]["step_in_epoch"] == 6
    _same_tree(jstate, restored)
    JaxCheckpointer(str(tmp_path / "jax"), async_save=False).save(6, jstate)
    keys = [json.loads((tmp_path / d / "step_00000006" / "manifest.json").read_text())["keys"]
            for d in ("port", "jax")]
    assert keys[0] == keys[1]


# ---------------------------------------------------------------------------
# the reader, and restore into a placement
# ---------------------------------------------------------------------------

def test_reader_reads_members_into_slots_in_chunks(tmp_path, monkeypatch):
    """`read_into` in chunks smaller than a leaf (CHUNK patched to 64 B)
    fills a bf16 and an f32 slot bitwise, a block of a flat leaf from an
    element offset, and refuses a slot of another dtype or shape."""
    monkeypatch.setattr(ckmod, "CHUNK", 64)
    rng = np.random.default_rng(3)
    flat = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((33, 7)).astype(np.float32)).to(torch.bfloat16)
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, {"flat": flat, "w": w})
    with ck.open() as r:
        assert r.keys() == ["flat", "w"] and r.info("w") == ((33, 7), torch.bfloat16)
        got = torch.empty(33, 7, dtype=torch.bfloat16)
        r.read_into("w", got)
        assert _same(got, w)
        block = torch.empty(250, dtype=torch.float32)
        r.read_into("flat", block, start=500)
        assert _same(block, flat[500:750])
        with pytest.raises(ValueError, match="bfloat16 in the checkpoint"):
            r.read_into("w", torch.empty(33, 7))
        with pytest.raises(ValueError, match="shape"):
            r.read_into("w", torch.empty(7, 33, dtype=torch.bfloat16))
        with pytest.raises(ValueError, match="were asked for"):
            r.read_into("flat", block, start=900)


def _smoke_tcfg(ckpt_dir, **kw):
    return TrainConfig(model=get_smoke_config(ARCH), shape=ShapeConfig("t", "train", 16, 2),
                       mesh=MeshSpec((1, 1), ("data", "model")),
                       lms=kw.pop("lms", LMSConfig(enabled=False)), ddl=DDLConfig(mode="none"),
                       learning_rate=5e-3, warmup_steps=1, total_steps=6,
                       checkpoint_dir=ckpt_dir, checkpoint_every=2, **kw)


def _leaves(state):
    return tree_leaves({"params": state.params, "opt": dict(state.opt._asdict())})


@pytest.mark.parametrize("lms", [LMSConfig(enabled=False), LMSConfig(hbm_budget=600_000)],
                         ids=["resident", "planned"])
def test_restore_train_state_into_the_plans_placement(tmp_path, lms):
    """A trained state saved by the Trainer comes back from
    `restore_train_state` bitwise, placed as the plan says (under the
    600 kB plan: the stack's params and the AdamW state in the arena),
    with the grads tree the plan asks for."""
    trainer = Trainer(_smoke_tcfg(str(tmp_path), lms=lms), device="cpu")
    state, _ = trainer.train(steps=2)
    want = [t.clone() for t in _leaves(state)]
    with trainer.ckpt.open() as reader:
        got = tsteps.restore_train_state(reader, trainer.model, trainer.tcfg, "cpu",
                                         plan=trainer.plan)
    assert all(_same(a, b) for a, b in zip(_leaves(got), want))
    assert int(got.step) == 2 and int(got.opt.step) == 2
    fresh = trainer.init_state()
    assert (got.grads is None) == (fresh.grads is None)
    off.release_arenas()


def test_snapshot_holds_step_n_while_step_n_plus_1_runs(tmp_path, monkeypatch):
    """The snapshot invariant. The writer of step 2's async checkpoint is
    held back until step 3 has run its forward and backward (it is let go
    when step 3's update calls the trainer's wait): the checkpoint still
    holds the state after step 2, bitwise that of an uninterrupted run's
    step 2; and a run resumed from it equals the uninterrupted run."""
    gate, reached = threading.Event(), []
    real = ckmod.write_npz

    def held_write(path, arrays):
        gate.wait(timeout=60)
        return real(path, arrays)
    monkeypatch.setattr(ckmod, "write_npz", held_write)
    trainer = Trainer(_smoke_tcfg(str(tmp_path / "held")), device="cpu")
    wait = trainer.step_fn.before_update

    def released_wait():
        writer = trainer.ckpt._thread
        reached.append(writer is not None and writer.is_alive())
        if writer is not None:
            gate.set()
        wait()
    trainer.step_fn.before_update = released_wait
    trainer.train(steps=3)
    monkeypatch.setattr(ckmod, "write_npz", real)
    # steps 1 and 2 found no writer; step 3 found step 2's still held
    assert reached == [False, False, True]
    base = Trainer(_smoke_tcfg(None), device="cpu")
    state2, _ = base.train(steps=2)
    _, saved, _ = trainer.ckpt.restore(step=2)
    assert all(_same(a, b) for a, b in zip(
        tree_leaves({"params": saved["params"], "opt": saved["opt"]}),
        tree_leaves({"params": state2.params, "opt": {**state2.opt._asdict()}})))
    import shutil
    shutil.rmtree(tmp_path / "held" / "step_00000003")
    _, hist4 = Trainer(_smoke_tcfg(None), device="cpu").train(steps=4)
    _, rhist = Trainer(_smoke_tcfg(str(tmp_path / "held")), device="cpu").train(steps=4)
    assert [r["step"] for r in rhist] == [3, 4]
    assert [(r["loss"], r["grad_norm"]) for r in rhist] == \
        [(r["loss"], r["grad_norm"]) for r in hist4[2:]]


# ---------------------------------------------------------------------------
# the port's Trainer resumes from the JAX Trainer's checkpoint
# ---------------------------------------------------------------------------

def test_port_trainer_resumes_from_a_jax_trainer_checkpoint(ref, tmp_path):
    """The JAX Trainer trains 2 steps and checkpoints (qwen2.5-14b smoke,
    one device, LMS off, f32 Adam state, bf16 params); the port's Trainer
    resumes from that checkpoint at step 2, restoring the data stream's
    position, and both packages continue to step 4: per step the same
    loss, ce and grad norm within 2e-3 relative, the same lr."""
    import shutil
    from repro.config import base as jb
    from repro.train import trainer as jtrainer
    shape = dict(name="t", kind="train", seq_len=16, global_batch=4)
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=4, checkpoint_every=2,
              async_checkpoint=False)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jt = jb.TrainConfig(model=ref.get_smoke_config(ARCH), shape=jb.ShapeConfig(**shape),
                        mesh=jb.MeshSpec((1, 1), ("data", "model")),
                        lms=jb.LMSConfig(enabled=False), checkpoint_dir=str(jdir), **kw)
    jtrainer.Trainer(jt).train(steps=2)
    shutil.copytree(jdir, pdir)
    _, jhist = jtrainer.Trainer(jt).train(steps=4)
    tt = TrainConfig(model=get_smoke_config(ARCH), shape=ShapeConfig(**shape),
                     mesh=MeshSpec((1, 1), ("data", "model")), lms=LMSConfig(enabled=False),
                     checkpoint_dir=str(pdir), **kw)
    trainer = Trainer(tt, device="cpu")
    state, start = trainer.resume_or_init()
    assert start == 2 and int(state.step) == 2 and trainer.loader.state.step_in_epoch == 2
    _, hist = trainer.train(steps=4)
    assert [r["step"] for r in hist] == [r["step"] for r in jhist] == [3, 4]
    for row, jrow in zip(hist, jhist):
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(row[k], jrow[k], rtol=2e-3, err_msg=k)
        np.testing.assert_allclose(row["lr"], jrow["lr"], rtol=1e-6)
    assert trainer.ckpt.latest_step() == 4


def test_olmo_train_states_cross_restore_bitwise(ref, tmp_path):
    """olmo-1b's smoke config (its LayerNorms have no params: `{}`
    subtrees, written as the JAX package's `__emptydict__` markers; a tied
    embedding): the JAX Trainer's checkpoint after 2 steps restores in the
    port whole (`Checkpointer.restore`: the JAX tree, `{}` included) and
    as a TrainState placed by a plan (`restore_train_state`, LMS 600 kB:
    the stack and the AdamW state in the arena), bitwise; the port
    Trainer's checkpoint after 2 steps restores in the JAX package as the
    port's state, bitwise, under the manifest keys the JAX package writes
    for that tree."""
    from repro.checkpoint import Checkpointer as JaxCheckpointer
    from repro.config import base as jb
    from repro.train import trainer as jtrainer
    from repro_torch.core.lms import planner as tp
    from repro_torch.models.model import Model
    arch = "olmo-1b"
    shape = dict(name="t", kind="train", seq_len=16, global_batch=2)
    kw = dict(learning_rate=5e-3, warmup_steps=1, total_steps=4, checkpoint_every=2,
              async_checkpoint=False)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jt = jb.TrainConfig(model=ref.get_smoke_config(arch), shape=jb.ShapeConfig(**shape),
                        mesh=jb.MeshSpec((1, 1), ("data", "model")),
                        lms=jb.LMSConfig(enabled=False), checkpoint_dir=str(jdir), **kw)
    jtrainer.Trainer(jt).train(steps=2)
    _, jtree, _ = JaxCheckpointer(str(jdir)).restore()
    assert jtree["params"]["final_norm"] == {}
    assert jtree["params"]["decoder"]["stack0"]["attn_0"]["ln1"] == {}
    step, tree, _ = Checkpointer(str(jdir)).restore()
    assert step == 2
    _same_tree(ref.jax.tree.map(np.asarray, jtree), tree)
    tt = TrainConfig(model=get_smoke_config(arch), shape=ShapeConfig(**shape),
                     mesh=MeshSpec((1, 1), ("data", "model")),
                     lms=LMSConfig(hbm_budget=600_000), **kw)
    model = Model(tt.model)
    plan = tp.plan(tp.PlanRequest(cfg=tt.model, shape=tt.shape, mesh=tt.mesh, lms=tt.lms))
    assert plan.residency["params"] == plan.residency["optimizer"] == "host"
    with Checkpointer(str(jdir)).open() as reader:
        got = tsteps.restore_train_state(reader, model, tt, "cpu", plan=plan)
    _same_tree(ref.jax.tree.map(np.asarray, jtree["params"]), got.params)
    _same_tree(ref.jax.tree.map(np.asarray, jtree["opt"]["master"]), got.opt.master)
    assert got.params["final_norm"] == {} and got.opt.mu["final_norm"] == {}
    off.release_arenas()

    trainer = Trainer(TrainConfig(model=get_smoke_config(arch), shape=ShapeConfig(**shape),
                                  mesh=MeshSpec((1, 1), ("data", "model")),
                                  lms=LMSConfig(enabled=False), checkpoint_dir=str(pdir),
                                  **kw), device="cpu")
    state, _ = trainer.train(steps=2)
    step, restored, _ = JaxCheckpointer(str(pdir)).restore()
    assert step == 2
    _same_tree(restored, {"step": state.step, "params": state.params,
                          "opt": dict(state.opt._asdict())})
    JaxCheckpointer(str(tmp_path / "again"), async_save=False).save(2, restored)
    keys = [json.loads((d / "step_00000002" / "manifest.json").read_text())["keys"]
            for d in (pdir, tmp_path / "again")]
    assert keys[0] == keys[1] and any(k.endswith("__emptydict__") for k in keys[0])
