"""Microbatches in the port on the CPU: the sharded microbatch accumulator
(the train step with the overlapped backward and m = 2 on a mesh of
several ranks) against the JAX package's, and LMS with m = 2 (the
layer-streaming executor run once a microbatch) against the port's
resident step, on one device and on 2 ranks, overlapped (the executor's
queue adding each layer's slot into the sharded accumulator) and
serialized; `torchrun` of the CLI with `--microbatches 2` against the JAX
launcher.

Inputs: the qwen2.5-14b smoke config (2 layers, d_model 64) with random
weights from a numpy seed (`random_params`) or the port's init from a
seed; 3 steps of 8 x 16 tokens of the synthetic stream on the (2, 2)
("pod", "data") mesh (each rank's 2 rows split in 2 microbatches of 1),
4 x 16 on the 2 ranks of a 1x2x1 mesh and on one device.

Tolerances. Against the JAX package those of tests/test_torch_ddl_train.py,
for its reasons: loss, ce and grad norm within 2e-3 relative; after 3 Adam
steps every master weight within 2 lr N, the median within 0.01 lr N and
the 99th percentile within 0.1 lr N; every rank's params bitwise the same.
Streamed against resident: bitwise (each microbatch's grads are the m = 1
step's, which tests/test_torch_lms.py holds bitwise, added into the f32
accumulator in the same order; the collectives the same).
"""
import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_ddl import REPO, _env, bits, init_gloo, start_jax, start_ranks, wait_all
from tests.test_torch_ddl_train import (STEP_LINE, _rel, _wait_for, flat_tree, save_state,
                                        state_from_npz)
from tests.test_torch_ref import jax_ref, jax_ref_scope  # noqa: F401 (autouse fixture)

from repro_torch.config import base as tb
from repro_torch.configs import get_smoke_config
from repro_torch.core.lms import planner as tp
from repro_torch.models.model import Model
from repro_torch.train import steps as tsteps
from repro_torch.tree import tree_leaves

ARCH = "qwen2.5-14b"
WORLD = 4
MESH = ((2, 2), ("pod", "data"))
PAIR = ((1, 2, 1), ("pod", "data", "model"))
STEPS, BATCH, SEQ, LR, M = 3, 8, 16, 1e-3, 2
COMPRESS = {"sharded": False, "sharded_compress": True}
OFFLOAD_ALL_BUT_MLP = {"resid": "offload", "attn_norm": "offload", "qkv": "offload",
                       "attn_out": "offload", "mlp_norm": "offload", "mlp_hidden": "remat"}
# LMS at m = 2 on 2 ranks: name -> (prefetch depth, residency)
STREAMED = {"depth1": (1, {"params": "host", "optimizer": "host"}),
            "depth2": (2, {"params": "host", "optimizer": "host"}),
            "optimizer_only": (2, {"optimizer": "host"}),
            "grads_host": (2, {"params": "host", "optimizer": "host", "grads": "host"})}
CLI = ["--arch", ARCH, "--smoke", "--mesh", "1x2x1", "--microbatches", "2",
       "--compress-dcn", "--steps", "3", "--batch", "4", "--seq", "16"]
ME = "tests.test_torch_microbatches"


def _batches(vocab, batch=BATCH, seq=SEQ):
    from repro_torch.data import SyntheticTokens
    data = SyntheticTokens(vocab, seed=3)
    return [data.batch(i, 0, 1, batch, seq) for i in range(STEPS)]


def _plan(cfg, residency, depth):
    res = {"params": "device", "grads": "device", "optimizer": "device",
           "kvcache": "device", **residency}
    sched = tp.make_swap_schedule(res, cfg.num_layers, "train", prefetch_depth=depth)
    return tp.MemoryPlan(dict(OFFLOAD_ALL_BUT_MLP), res, 1, 1, 1, 1, True,
                         swap_schedule=sched)


def _state_leaves(st):
    o = st.opt
    return [st.step, o.step] + [x for t in (st.params, o.mu, o.nu, o.master)
                                for x in tree_leaves(t)]


# ---------------------------------------------------------------------------
# the JAX side: m = 2 with the overlapped backward on (2, 2); the launcher
# ---------------------------------------------------------------------------

def _jax_side(out_dir):
    from tests.test_torch_ref import random_params
    ref = jax_ref()
    jax, jnp = ref.jax, ref.jnp
    from repro.config import base as jb
    from repro.launch import train as jlaunch
    from repro.launch.mesh import make_mesh
    from repro.optim.adamw import adamw_init
    from repro.train import steps as js
    out = pathlib.Path(out_dir)
    cfg = ref.get_smoke_config(ARCH)
    jparams, _ = random_params(ref, cfg, seed=11)
    init = js.TrainState(jnp.zeros((), jnp.int32), jparams, adamw_init(jparams))
    save_state(out / "init.npz", jax.tree.map(np.asarray, init))
    spec = jb.MeshSpec(*MESH)
    mesh = make_mesh(spec)
    res = {}
    for name, c in COMPRESS.items():
        tcfg = jb.TrainConfig(
            model=cfg, shape=jb.ShapeConfig("t", "train", SEQ, BATCH), mesh=spec,
            lms=jb.LMSConfig(enabled=False), ddl=jb.DDLConfig(compress_dcn=c),
            learning_rate=LR, warmup_steps=0, total_steps=10, microbatches=M)
        step, state_sh, batch_sh = js.build_train_step(ref.Model(cfg), tcfg, mesh,
                                                       donate=False, overlap_grads=True)
        state = jax.device_put(init, state_sh)
        for i, b in enumerate(_batches(cfg.vocab_size)):
            state, met = step(state, jax.device_put(
                {k: jnp.asarray(v) for k, v in b.items()}, batch_sh))
            for k in ("loss", "ce", "grad_norm", "lr"):
                res[f"{name}/{k}/{i}"] = np.float32(met[k])
        res.update({f"{name}/master/{k}": v for k, v in
                    flat_tree(jax.tree.map(np.asarray, state.opt.master)).items()})
    np.savez(out / "jax_steps.npz", **res)

    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jlaunch.main(CLI + ["--ckpt-dir", str(out / "cli_ckpt")])
    (out / "jax_cli.txt").write_text(buf.getvalue())


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------

def _tcfg(mesh=MESH, batch=BATCH, **kw):
    return tb.TrainConfig(model=get_smoke_config(ARCH),
                          shape=tb.ShapeConfig("t", "train", SEQ, batch),
                          mesh=tb.MeshSpec(*mesh), learning_rate=LR, warmup_steps=0,
                          total_steps=10, microbatches=M, **{"checkpoint_dir": None, **kw})


def _local(mesh, batches):
    from repro_torch.data import local_rows
    return [{k: torch.from_numpy(v) for k, v in local_rows(b, mesh.dp_index,
                                                          mesh.dp_size).items()}
            for b in batches]


def _port_steps(rank, world, out_dir):
    """m = 2 with the overlapped backward, compress off and on, from JAX's
    initial state on this rank of the (2, 2) mesh."""
    from repro_torch.launch.mesh import make_mesh
    out = pathlib.Path(out_dir)
    init_gloo(rank, world, out)
    mesh = make_mesh(tb.MeshSpec(*MESH))
    cfg = get_smoke_config(ARCH)
    batches = _local(mesh, _batches(cfg.vocab_size))
    _wait_for(out / "init.npz")
    res = {}
    for name, c in COMPRESS.items():
        tcfg = _tcfg(lms=tb.LMSConfig(enabled=False),
                     ddl=tb.DDLConfig(compress_dcn=c, overlap_grads=True))
        step = tsteps.build_train_step(Model(cfg), tcfg, mesh=mesh)
        state = state_from_npz(out / "init.npz")
        for i, b in enumerate(batches):
            state, met = step(state, b)
            for k in ("loss", "ce", "grad_norm", "lr"):
                res[f"{name}/{k}/{i}"] = np.float32(met[k].item())
        res.update({f"{name}/master/{k}": v for k, v in flat_tree(state.opt.master).items()})
        res.update({f"{name}/params/{k}": v for k, v in flat_tree(state.params).items()})
    np.savez(out / f"port_steps_{rank}.npz", **res)


def _port_streamed(rank, world, out_dir):
    """LMS at m = 2 on this rank of the 1x2x1 mesh against the resident
    m = 2 step, overlapped and serialized: metrics and every state leaf."""
    from repro_torch.core.ddl import overlap
    from repro_torch.launch.mesh import make_mesh
    out = pathlib.Path(out_dir)
    init_gloo(rank, world, out / "streamed")
    mesh = make_mesh(tb.MeshSpec(*PAIR))
    cfg = get_smoke_config(ARCH)
    model = Model(cfg)
    batches = _local(mesh, _batches(cfg.vocab_size, batch=4))
    adds = []
    open_ = overlap.ReductionQueue.open

    def open_seen(self, *a, accumulate=False, **k):
        adds.append(accumulate)
        return open_(self, *a, accumulate=accumulate, **k)
    overlap.ReductionQueue.open = open_seen

    def run(tcfg, plan):
        state = tsteps.init_train_state(model, tcfg, 5, "cpu", plan=plan)
        step = tsteps.build_train_step(model, tcfg, plan=plan, mesh=mesh)
        mets = []
        for b in batches:
            state, met = step(state, b)
            mets.append({k: v.item() for k, v in met.items()})
        return mets, state
    res = {}
    for ov in (True, False):
        kw = dict(mesh=PAIR, batch=4, ddl=tb.DDLConfig(compress_dcn=True, overlap_grads=ov))
        base, base_state = run(_tcfg(lms=tb.LMSConfig(enabled=False), **kw), None)
        for name, (depth, residency) in STREAMED.items():
            adds.clear()
            mets, state = run(_tcfg(lms=tb.LMSConfig(hbm_budget=600_000), **kw),
                              _plan(cfg, residency, depth))
            res[f"{name}/overlap={ov}"] = {
                "metrics": mets == base,
                "state": all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                             zip(_state_leaves(state), _state_leaves(base_state))),
                "queue_adds": adds == [True] * (M * STEPS) if ov else adds == []}
    overlap.ReductionQueue.open = open_
    (out / f"port_streamed_{rank}.json").write_text(json.dumps(res))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every side at once: the JAX subprocess (4 devices), the port's 4
    ranks, 2 ranks of the streamed runs, and torchrun of the CLI."""
    out = tmp_path_factory.mktemp("microbatches")
    (out / "streamed").mkdir()
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--device", "cpu"]
        + CLI + ["--ckpt-dir", str(out / "port_cli_ckpt")], cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    procs = (start_jax(ME, "_jax_side", out, devices=WORLD)
             + start_ranks(ME, "_port_steps", out, WORLD)
             + start_ranks(ME, "_port_streamed", out, 2) + [cli])
    outs = wait_all(procs, timeout=300)
    return out, outs[-1]


@pytest.mark.parametrize("variant", list(COMPRESS))
def test_sharded_accumulator_on_4_ranks_matches_jax(runs, variant):
    """The train step with the overlapped backward and 2 microbatches (the
    sharded accumulator: each microbatch's shard added into one f32
    vector, all-gathered once) against the JAX package's on the (2, 2)
    mesh, compress off and on: per step loss, ce, grad norm and lr; after
    3 steps the master weights; every rank's params the same."""
    out, _ = runs
    jres = dict(np.load(out / "jax_steps.npz"))
    ranks = [dict(np.load(out / f"port_steps_{r}.npz")) for r in range(WORLD)]
    for i in range(STEPS):
        for k, tol in (("loss", 2e-3), ("ce", 2e-3), ("grad_norm", 2e-3), ("lr", 1e-6)):
            key = f"{variant}/{k}/{i}"
            for r in range(WORLD):
                assert _rel(ranks[r][key], jres[key]) <= tol, (key, r, ranks[r][key], jres[key])
    masters = sorted(k for k in jres if k.startswith(f"{variant}/master/"))
    diff = np.concatenate([np.abs(ranks[0][k] - jres[k]).ravel() for k in masters])
    unit = LR * STEPS
    assert diff.max() <= 2 * unit + 1e-6, diff.max() / unit
    assert np.median(diff) <= 0.01 * unit, np.median(diff) / unit
    assert np.percentile(diff, 99) <= 0.1 * unit, np.percentile(diff, 99) / unit
    for k in ranks[0]:
        if "/params/" in k or "/master/" in k:
            for r in range(1, WORLD):
                assert np.array_equal(bits(ranks[r][k]), bits(ranks[0][k])), (k, r)


@pytest.mark.parametrize("name", list(STREAMED))
@pytest.mark.parametrize("ov", [True, False])
def test_lms_microbatches_on_2_ranks_equal_resident_bitwise(runs, name, ov):
    """LMS at m = 2 on 2 ranks of a 1x2x1 mesh (params and the optimizer
    streamed at depth 1 and 2, the optimizer alone, and a hand-made plan
    with grads on the host: no sink at m > 1; serialized, the accumulated
    f32 stack placed on the host after the tree pass) against the resident
    m = 2 step with the same overlap, 3 steps from one init: metrics and
    every state leaf bitwise on both ranks; overlapped, the queue adds
    each layer's slot into the accumulator once a microbatch."""
    out, _ = runs
    for r in range(2):
        got = json.loads((out / f"port_streamed_{r}.json").read_text())[f"{name}/overlap={ov}"]
        assert got == {"metrics": True, "state": True, "queue_adds": True}, (r, got)


def test_torchrun_cli_microbatches_matches_jax_launcher(runs):
    """torchrun of the CLI with --microbatches 2 on 2 CPU ranks of a 1x2x1
    mesh (LMS on, compress_dcn) prints the JAX launcher's step lines once,
    from rank 0: the same steps and lrs, finite losses and grad norms, the
    final-loss line."""
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


# ---------------------------------------------------------------------------
# one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("residency", [{"params": "host", "optimizer": "host"},
                                       {"optimizer": "host"}, {}],
                         ids=["params_and_optimizer", "optimizer", "policy_only"])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("layers", [1, 2])
def test_lms_microbatches_on_one_device_equal_resident_bitwise(layers, depth, residency):
    """LMS at m = 2 on one device (the executor once a microbatch, its
    stack grads added into the f32 accumulator) against the resident m = 2
    step, 3 steps of 4 x 16 tokens from one init, at depth 1 and 2 and 1
    and 2 layers: every metric and every state leaf bitwise."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), num_layers=layers)
    base = dict(model=cfg, shape=tb.ShapeConfig("t", "train", SEQ, 4),
                mesh=tb.MeshSpec((1, 1), ("data", "model")), learning_rate=1e-2,
                warmup_steps=1, total_steps=10, microbatches=M, checkpoint_dir=None)
    model = Model(cfg)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in _batches(cfg.vocab_size, batch=4)]
    runs = []
    for tcfg, plan in ((tb.TrainConfig(lms=tb.LMSConfig(enabled=False), **base), None),
                       (tb.TrainConfig(lms=tb.LMSConfig(hbm_budget=600_000), **base),
                        _plan(cfg, residency, depth))):
        state = tsteps.init_train_state(model, tcfg, 5, "cpu", plan=plan)
        step = tsteps.build_train_step(model, tcfg, plan=plan)
        mets = []
        for b in batches:
            state, met = step(state, b)
            mets.append({k: v.item() for k, v in met.items()})
        runs.append((mets, state))
    (mets, state), (smets, sstate) = runs
    assert smets == mets and all(np.isfinite(m["loss"]) for m in mets)
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(_state_leaves(sstate), _state_leaves(state)))


def test_host_grads_at_microbatches_are_f32():
    """A plan with grads on the host at m > 1 places a f32 grads tree (the
    accumulated grads), and a state placed for m = 1 is refused by the
    serialized step's post-hoc placement rather than rounded."""
    cfg = get_smoke_config(ARCH)
    plan = _plan(cfg, STREAMED["grads_host"][1], 2)
    tcfg = _tcfg(mesh=((1, 1), ("data", "model")), batch=4,
                 lms=tb.LMSConfig(hbm_budget=600_000))
    state = tsteps.init_train_state(Model(cfg), tcfg, 5, "cpu", plan=plan)
    assert all(t.dtype == torch.float32 for t in tree_leaves(state.grads))
    one = tsteps.place_train_state(state, plan, "cpu")
    stack = tree_leaves(state.params["decoder"]["stack0"])
    assert [t.dtype for t in tree_leaves(one.grads)] == [p.dtype for p in stack]
    assert any(p.dtype == torch.bfloat16 for p in stack)
    two = tsteps.place_train_state(state, plan, "cpu", microbatches=2)
    assert all(t.dtype == torch.float32 for t in tree_leaves(two.grads))
    step = tsteps.build_train_step(Model(cfg), tcfg, plan=plan)
    b = {k: torch.from_numpy(v) for k, v in _batches(cfg.vocab_size, batch=4)[0].items()}
    with pytest.raises(ValueError, match="place the state with microbatches"):
        step(one, b)


@pytest.mark.parametrize("flags", [["--microbatches", "2"], ["--ddl-mode", "zero1"],
                                   ["--no-lms", "--microbatches", "2", "--ddl-mode", "zero1"]],
                         ids=["lms_microbatches", "lms_zero1", "zero1_microbatches"])
def test_cli_trains_on_one_device(capsys, tmp_path, flags):
    """The CLI on one CPU device with LMS and 2 microbatches, with zero1
    under LMS, and with zero1 and --microbatches (which zero1 ignores, as
    the JAX step does: one pass over the batch): 3 steps, finite losses,
    the final-loss line."""
    from repro_torch.launch import train as launch
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
            "--seq", "16"]
    assert launch.main(args + flags + ["--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    losses = [float(line.split("|")[1].split()[1]) for line in out if line.startswith("step ")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert any(line.startswith("final loss: ") for line in out)
