"""Data-parallel training in the port against the JAX package, on the CPU:
`build_train_step` on 4 gloo ranks of a (2, 2) ("pod", "data") mesh
against the JAX package's step on the same mesh of emulated devices, for
compress_dcn off and on x the overlapped backward off and on, and 2
microbatches without it; the `Trainer` on 2 ranks of a 2x1x1 mesh against
the JAX `Trainer`; `torchrun` of the training CLI on 2 ranks against the
JAX launcher; the train step of olmo-1b (norm subtrees with no leaves,
a tied embedding) on 2 ranks, a 2x1 ("pod", "data") mesh with
compress_dcn and the overlapped backward (the reduction queue, the int8
pod hop) and a 1x2 mesh with and without the overlap, against the JAX
package's on 2 emulated devices; and what is not ported yet raises.

The train step runs the qwen2.5-14b smoke config (2 layers, d_model 64)
from one random state converted by `train_state_from_jax`, over 3 steps of
8 x 16 tokens of the synthetic stream, each rank on its own 2 rows. The
model runs in bf16, as a user runs it: the JAX package casts the
embedding rows to bf16 whatever the config's dtype, so an f32 model is
not one it can run. Tolerances, those of the one-device step
(test_torch_train), whose reasons hold here: the two frameworks round bf16
intermediates at different places, and the reductions add only f32 sums
of two values (bitwise, test_torch_ddl) and, with compression, int8 codes
that may round the other way where their input lies at a boundary. So
loss, ce and grad norm within 2e-3 relative (measured at most 4.3e-4);
after 3 Adam steps of rate lr each master weight within 2 lr N of JAX's
(measured 1.69), the median within 0.01 lr N (0.0017) and the 99th
percentile within 0.1 lr N (0.057). Every rank ends with the same params,
bit for bit. The Trainer is held to the same 2e-3 (measured 3.5e-4).
"""
import dataclasses
import pathlib
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from tests.test_torch_ddl import REPO, _env, init_gloo, start_jax, start_ranks, wait_all
from tests.test_torch_ref import jax_ref_scope  # noqa: F401 (autouse fixture)

from repro_torch.config.base import (DDLConfig, LMSConfig, MeshSpec, ShapeConfig,
                                     TrainConfig)
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model import Model
from repro_torch.train.steps import build_train_step, build_zero1_train_step

ARCH = "qwen2.5-14b"
MESH = ((2, 2), ("pod", "data"))
TRAINER_MESH = ((2, 1, 1), ("pod", "data", "model"))
STEPS, BATCH, SEQ, LR = 3, 8, 16, 1e-3
# name -> (compress_dcn, overlap_grads, microbatches)
VARIANTS = {"plain": (False, False, 1), "overlap": (False, True, 1),
            "compress": (True, False, 1), "compress_overlap": (True, True, 1),
            "microbatches_2": (False, False, 2)}
# olmo-1b on 2 ranks: name -> (mesh shape over ("pod", "data"), compress_dcn, overlap)
OLMO = "olmo-1b"
OLMO_VARIANTS = {"2x1_compress_overlap": ((2, 1), True, True),
                 "1x2_plain": ((1, 2), False, False), "1x2_overlap": ((1, 2), False, True)}
CLI = ["--arch", ARCH, "--smoke", "--no-lms", "--mesh", "2x1x1", "--compress-dcn",
       "--steps", "3", "--batch", "4", "--seq", "16"]
ME = "tests.test_torch_ddl_train"


# ---------------------------------------------------------------------------
# trees <-> npz
# ---------------------------------------------------------------------------

EMPTY = "@empty"


def flat_tree(tree, prefix=""):
    """Nested dict of arrays -> {"a/b/c": f32 array}; bf16 leaves get a
    "@bf16" suffix (f32 holds them exactly); a subtree with no leaves (a
    LayerNorm without params) is the key "a/b@empty"."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict) and not v:
            out[prefix + k + EMPTY] = np.zeros(0, np.float32)
            continue
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
            continue
        a = np.asarray(v.float() if torch.is_tensor(v) else v)
        suffix = "@bf16" if a.dtype.name == "bfloat16" or (
            torch.is_tensor(v) and v.dtype == torch.bfloat16) else ""
        out[prefix + k + suffix] = a.astype(np.float32)
    return out


def unflat_tree(flat, prefix=""):
    """Inverse of flat_tree for the keys under `prefix`, as numpy arrays
    (bf16 leaves as ml_dtypes bfloat16, as JAX hands them out)."""
    import ml_dtypes
    out = {}
    for key, a in flat.items():
        if not key.startswith(prefix):
            continue
        path = key[len(prefix):]
        if path.endswith("@bf16"):
            path, a = path[:-5], a.astype(ml_dtypes.bfloat16)
        elif path.endswith(EMPTY):
            path, a = path[:-len(EMPTY)], {}
        node = out
        *dirs, leaf = path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = a
    return out


def state_from_npz(path, device="cpu"):
    """A JAX TrainState saved by save_state -> the port's TrainState."""
    from repro_torch.convert import train_state_from_jax
    flat = dict(np.load(path))
    opt = types.SimpleNamespace(step=flat["opt_step"], mu=unflat_tree(flat, "mu/"),
                                nu=unflat_tree(flat, "nu/"), master=unflat_tree(flat, "master/"))
    st = types.SimpleNamespace(step=flat["step"], params=unflat_tree(flat, "params/"), opt=opt)
    return train_state_from_jax(st, device)


def save_state(path, state):
    """A JAX TrainState (AdamW) -> npz."""
    np.savez(path, step=np.asarray(state.step), opt_step=np.asarray(state.opt.step),
             **{f"params/{k}": v for k, v in flat_tree(state.params).items()},
             **{f"mu/{k}": v for k, v in flat_tree(state.opt.mu).items()},
             **{f"nu/{k}": v for k, v in flat_tree(state.opt.nu).items()},
             **{f"master/{k}": v for k, v in flat_tree(state.opt.master).items()})


def _batches(vocab):
    from repro_torch.data import SyntheticTokens
    data = SyntheticTokens(vocab, seed=3)
    return [data.batch(i, 0, 1, BATCH, SEQ) for i in range(STEPS)]


# ---------------------------------------------------------------------------
# the JAX side: every variant on the (2, 2) mesh, the Trainer, the launcher
# ---------------------------------------------------------------------------

def _jax_side(out_dir):
    from tests.test_torch_ref import jax_ref, random_params
    ref = jax_ref()
    jax, jnp = ref.jax, ref.jnp
    from repro.config import base as jb
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
    res = {}
    for name, (c, ov, m) in VARIANTS.items():
        tcfg = jb.TrainConfig(
            model=cfg, shape=jb.ShapeConfig("t", "train", SEQ, BATCH), mesh=spec,
            lms=jb.LMSConfig(enabled=False), ddl=jb.DDLConfig(compress_dcn=c),
            learning_rate=LR, warmup_steps=0, total_steps=10, microbatches=m)
        step, state_sh, batch_sh = js.build_train_step(ref.Model(cfg), tcfg, mesh,
                                                       donate=False, overlap_grads=ov)
        state = jax.device_put(init, state_sh)
        for i, b in enumerate(_batches(cfg.vocab_size)):
            state, met = step(state, jax.device_put(
                {k: jnp.asarray(v) for k, v in b.items()}, batch_sh))
            for k in ("loss", "ce", "grad_norm", "lr"):
                res[f"{name}/{k}/{i}"] = np.float32(met[k])
        res.update({f"{name}/master/{k}": v for k, v in
                    flat_tree(jax.tree.map(np.asarray, state.opt.master)).items()})
    np.savez(out / "jax_steps.npz", **res)

    # the Trainer on the 2x1x1 mesh (bf16), compress on; its initial state
    # is handed to the port's trainer
    tspec = jb.MeshSpec(*TRAINER_MESH)
    tcfg = jb.TrainConfig(
        model=ref.get_smoke_config(ARCH), shape=jb.ShapeConfig("t", "train", SEQ, 4),
        mesh=tspec, lms=jb.LMSConfig(enabled=False), ddl=jb.DDLConfig(compress_dcn=True),
        learning_rate=1e-3, warmup_steps=1, total_steps=3, log_every=2,
        checkpoint_dir=str(out / "ckpt"))
    trainer = jtrainer.Trainer(tcfg)
    save_state(out / "trainer_init.npz", jax.tree.map(np.asarray, trainer.init_state()))
    _, hist = trainer.train(steps=3)
    np.savez(out / "jax_trainer.npz", **{f"{k}/{r['step']}": np.float64(r[k])
                                         for r in hist for k in ("loss", "ce", "grad_norm", "lr")})

    # the launcher, 2 devices
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jlaunch.main(CLI + ["--ckpt-dir", str(out / "cli_ckpt")])
    (out / "jax_cli.txt").write_text(buf.getvalue())


def _jax_olmo(out_dir):
    """olmo-1b's train step on 2 emulated devices, each OLMO_VARIANTS mesh,
    from one random state (written for the port's ranks)."""
    from tests.test_torch_ref import jax_ref, random_params
    ref = jax_ref()
    jax, jnp = ref.jax, ref.jnp
    from repro.config import base as jb
    from repro.launch.mesh import make_mesh
    from repro.optim.adamw import adamw_init
    from repro.train import steps as js
    out = pathlib.Path(out_dir)
    cfg = ref.get_smoke_config(OLMO)
    jparams, _ = random_params(ref, cfg, seed=12)
    init = js.TrainState(jnp.zeros((), jnp.int32), jparams, adamw_init(jparams))
    save_state(out / "olmo_init.npz", jax.tree.map(np.asarray, init))
    res = {}
    for name, (shape, c, ov) in OLMO_VARIANTS.items():
        spec = jb.MeshSpec(shape, ("pod", "data"))
        tcfg = jb.TrainConfig(
            model=cfg, shape=jb.ShapeConfig("t", "train", SEQ, BATCH), mesh=spec,
            lms=jb.LMSConfig(enabled=False), ddl=jb.DDLConfig(compress_dcn=c),
            learning_rate=LR, warmup_steps=0, total_steps=10)
        step, state_sh, batch_sh = js.build_train_step(ref.Model(cfg), tcfg, make_mesh(spec),
                                                       donate=False, overlap_grads=ov)
        state = jax.device_put(init, state_sh)
        for i, b in enumerate(_batches(cfg.vocab_size)):
            state, met = step(state, jax.device_put(
                {k: jnp.asarray(v) for k, v in b.items()}, batch_sh))
            for k in ("loss", "ce", "grad_norm", "lr"):
                res[f"{name}/{k}/{i}"] = np.float32(met[k])
        res.update({f"{name}/master/{k}": v for k, v in
                    flat_tree(jax.tree.map(np.asarray, state.opt.master)).items()})
    np.savez(out / "jax_olmo.npz", **res)


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------

def _wait_for(path, timeout=240):
    import time
    deadline = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} was not written")
        time.sleep(0.2)
    time.sleep(0.5)        # np.savez writes the file in one go; let it land


def _port_steps(rank, world, out_dir):
    """Every variant on this rank of the (2, 2) mesh, from JAX's initial
    state (written by the JAX side); results into port_steps_<rank>.npz."""
    from repro_torch.data import local_rows
    from repro_torch.launch.mesh import make_mesh
    out = pathlib.Path(out_dir)
    init_gloo(rank, world, out)
    mesh = make_mesh(MeshSpec(*MESH))
    _wait_for(out / "init.npz")
    cfg = get_smoke_config(ARCH)
    res = {}
    for name, (c, ov, m) in VARIANTS.items():
        tcfg = TrainConfig(
            model=cfg, shape=ShapeConfig("t", "train", SEQ, BATCH), mesh=MeshSpec(*MESH),
            lms=LMSConfig(enabled=False), ddl=DDLConfig(compress_dcn=c, overlap_grads=ov),
            learning_rate=LR, warmup_steps=0, total_steps=10, microbatches=m,
            checkpoint_dir=None)
        step = build_train_step(Model(cfg), tcfg, mesh=mesh)
        state = state_from_npz(out / "init.npz")
        for i, b in enumerate(_batches(cfg.vocab_size)):
            rows = local_rows(b, mesh.dp_index, mesh.dp_size)
            state, met = step(state, {k: torch.from_numpy(v) for k, v in rows.items()})
            for k in ("loss", "ce", "grad_norm", "lr"):
                res[f"{name}/{k}/{i}"] = np.float32(met[k].item())
        res.update({f"{name}/master/{k}": v for k, v in flat_tree(state.opt.master).items()})
        res.update({f"{name}/params/{k}": v for k, v in flat_tree(state.params).items()})
    np.savez(out / f"port_steps_{rank}.npz", **res)


def _port_olmo(rank, world, out_dir):
    """olmo-1b's train step on this rank of each OLMO_VARIANTS mesh, from
    JAX's initial state; results into port_olmo_<rank>.npz."""
    from repro_torch.data import local_rows
    from repro_torch.launch.mesh import make_mesh
    out = pathlib.Path(out_dir)
    init_gloo(rank, world, out)
    _wait_for(out / "olmo_init.npz")
    cfg = get_smoke_config(OLMO)
    res = {}
    for name, (shape, c, ov) in OLMO_VARIANTS.items():
        spec = MeshSpec(shape, ("pod", "data"))
        mesh = make_mesh(spec)
        tcfg = TrainConfig(
            model=cfg, shape=ShapeConfig("t", "train", SEQ, BATCH), mesh=spec,
            lms=LMSConfig(enabled=False), ddl=DDLConfig(compress_dcn=c, overlap_grads=ov),
            learning_rate=LR, warmup_steps=0, total_steps=10, checkpoint_dir=None)
        step = build_train_step(Model(cfg), tcfg, mesh=mesh)
        assert (step.queue is not None) == ov
        state = state_from_npz(out / "olmo_init.npz")
        for i, b in enumerate(_batches(cfg.vocab_size)):
            rows = local_rows(b, mesh.dp_index, mesh.dp_size)
            state, met = step(state, {k: torch.from_numpy(v) for k, v in rows.items()})
            for k in ("loss", "ce", "grad_norm", "lr"):
                res[f"{name}/{k}/{i}"] = np.float32(met[k].item())
        res.update({f"{name}/master/{k}": v for k, v in flat_tree(state.opt.master).items()})
        res.update({f"{name}/params/{k}": v for k, v in flat_tree(state.params).items()})
    np.savez(out / f"port_olmo_{rank}.npz", **res)


def _port_trainer(rank, world, out_dir):
    """The Trainer on this rank of the 2x1x1 mesh from the JAX trainer's
    initial state; its history into port_trainer_<rank>.npz."""
    from repro_torch.obs import get_obs
    from repro_torch.train.trainer import Trainer
    out = pathlib.Path(out_dir)
    init_gloo(rank, world, out / "trainer")
    _wait_for(out / "trainer_init.npz")
    tcfg = TrainConfig(
        model=get_smoke_config(ARCH), shape=ShapeConfig("t", "train", SEQ, 4),
        mesh=MeshSpec(*TRAINER_MESH), lms=LMSConfig(enabled=False),
        ddl=DDLConfig(compress_dcn=True), learning_rate=1e-3, warmup_steps=1,
        total_steps=3, log_every=2, checkpoint_dir=None)
    trainer = Trainer(tcfg, device="cpu")
    assert trainer.mesh.dp_index == rank
    trainer.init_state = lambda: state_from_npz(out / "trainer_init.npz")
    state, hist = trainer.train(steps=3)
    np.savez(out / f"port_trainer_{rank}.npz",
             **{f"{k}/{r['step']}": np.float64(r[k]) for r in hist
                for k in ("loss", "ce", "grad_norm", "lr")},
             **{f"params/{k}": v for k, v in flat_tree(state.params).items()},
             buckets=get_obs().registry.counter("ddl.buckets").value)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides of the train step, the Trainer and the CLI, run at once."""
    out = tmp_path_factory.mktemp("ddl_train")
    (out / "trainer").mkdir()
    (out / "olmo").mkdir()
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--device", "cpu"]
        + CLI + ["--ckpt-dir", str(out / "port_cli_ckpt")], cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    procs = (start_jax(ME, "_jax_side", out, devices=4)
             + start_ranks(ME, "_port_steps", out, 4)
             + start_ranks(ME, "_port_trainer", out, 2)
             + start_jax(ME, "_jax_olmo", out / "olmo", devices=2)
             + start_ranks(ME, "_port_olmo", out / "olmo", 2) + [cli])
    outs = wait_all(procs, timeout=300)
    return out, outs[-1]


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _check_steps(jres, ranks, variant):
    """Per step: loss, ce, grad norm and lr of every rank against the JAX
    step's; after the steps the master weights; every rank the same."""
    for i in range(STEPS):
        for k, tol in (("loss", 2e-3), ("ce", 2e-3), ("grad_norm", 2e-3), ("lr", 1e-6)):
            key = f"{variant}/{k}/{i}"
            for r in range(len(ranks)):
                assert _rel(ranks[r][key], jres[key]) <= tol, (key, r, ranks[r][key], jres[key])
    masters = sorted(k for k in jres if k.startswith(f"{variant}/master/"))
    diff = np.concatenate([np.abs(ranks[0][k] - jres[k]).ravel() for k in masters])
    unit = LR * STEPS
    assert diff.max() <= 2 * unit + 1e-6, diff.max() / unit
    assert np.median(diff) <= 0.01 * unit, np.median(diff) / unit
    assert np.percentile(diff, 99) <= 0.1 * unit, np.percentile(diff, 99) / unit
    for k in ranks[0]:
        if k.startswith(f"{variant}/params/") or k.startswith(f"{variant}/master/"):
            for r in range(1, len(ranks)):
                assert np.array_equal(ranks[r][k].view(np.int32), ranks[0][k].view(np.int32)), (k, r)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_step_on_4_ranks_matches_jax(runs, variant):
    """Per step: loss, ce, grad norm and lr against the JAX step on the
    (2, 2) mesh; after 3 steps the master weights; every rank the same."""
    out, _ = runs
    _check_steps(dict(np.load(out / "jax_steps.npz")),
                 [dict(np.load(out / f"port_steps_{r}.npz")) for r in range(4)], variant)


@pytest.mark.parametrize("variant", list(OLMO_VARIANTS))
def test_olmo_train_step_on_2_ranks_matches_jax(runs, variant):
    """olmo-1b's train step on 2 ranks (2x1 with compress_dcn and the
    queue; 1x2 with and without the overlap) against the JAX step on the
    same mesh of 2 emulated devices: per step loss, ce, grad norm and lr;
    after 3 steps the master weights, the `{}` norm subtrees included;
    both ranks the same."""
    out, _ = runs
    _check_steps(dict(np.load(out / "olmo" / "jax_olmo.npz")),
                 [dict(np.load(out / "olmo" / f"port_olmo_{r}.npz")) for r in range(2)],
                 variant)


def test_trainer_on_2x1x1_matches_jax_trainer(runs):
    """The port's Trainer on 2 ranks (compress_dcn, overlapped backward)
    against the JAX Trainer on 2 devices, from the same initial state:
    each step's loss, ce, grad norm and lr; both ranks' histories and
    params are the same, and the hooks counted their buckets."""
    out, _ = runs
    j = dict(np.load(out / "jax_trainer.npz"))
    ranks = [dict(np.load(out / f"port_trainer_{r}.npz")) for r in range(2)]
    for s in (1, 2, 3):
        for k in ("loss", "ce", "grad_norm"):
            assert _rel(ranks[0][f"{k}/{s}"], j[f"{k}/{s}"]) <= 2e-3, (k, s)
        assert _rel(ranks[0][f"lr/{s}"], j[f"lr/{s}"]) <= 1e-6 or j[f"lr/{s}"] == 0
    for k in ranks[0]:
        assert np.array_equal(ranks[1][k], ranks[0][k]), k
    # 2 layers x 3 steps, each layer's grads in one bucket
    assert int(ranks[0]["buckets"]) == 2 * 3


STEP_LINE = re.compile(r"^step +(\d+) \| loss ([\d.]+) \| gnorm ([\d.]+) \| lr ([\d.e+-]+) \| \d+ ms$")


def test_torchrun_cli_matches_jax_launcher(runs):
    """torchrun of the training CLI on 2 CPU ranks prints the JAX
    launcher's step lines (same flags, 2 devices) once, from rank 0 only:
    the same steps and lrs, finite losses (the two packages draw their
    random init differently, so the values differ), the final-loss line
    and the DDL bucket counter."""
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
    assert sum(x.startswith("ddl.buckets: ") for x in lines) == 1


# ---------------------------------------------------------------------------
# what is not ported yet, and a world that disagrees with the mesh
# ---------------------------------------------------------------------------

def _tcfg(mesh=((1, 1), ("data", "model")), **kw):
    return TrainConfig(model=get_smoke_config(ARCH), shape=ShapeConfig("t", "train", SEQ, 4),
                       mesh=MeshSpec(*mesh), lms=LMSConfig(enabled=False),
                       **{"checkpoint_dir": None, **kw})


def test_what_is_not_ported_raises():
    """zero1 under a model axis above 1 and a mesh of several devices
    without a world that size raise; so do, under a plan on several ranks,
    params on the host with the optimizer on the device. The replicated
    step under a model axis above 1 builds (tests/test_torch_tp_train.py
    runs it). The Mamba-2 stack under a plan,
    zero1, m > 1 with the overlapped backward on several ranks and LMS with
    microbatches build now (tests/test_torch_zero1.py and
    tests/test_torch_microbatches.py run them), as does LMS on several
    ranks (tests/test_torch_lms_ddl.py)."""
    from repro_torch.core.lms import planner as tp
    model = Model(get_smoke_config(ARCH))
    two = MeshSpec((2, 1), ("data", "model"))
    res = {"params": "host", "grads": "host", "optimizer": "host", "kvcache": "device"}
    plan = tp.MemoryPlan({}, res, 1, 1, 1, 1, True, swap_schedule=tp.make_swap_schedule(
        res, model.cfg.num_layers, "train"))
    for kw in (dict(), dict(microbatches=2), dict(microbatches=2,
                                                  ddl=DDLConfig(overlap_grads=False))):
        build_train_step(model, _tcfg(mesh=((2, 1), ("data", "model")), **kw), plan=plan,
                         mesh=Mesh(two, rank=0))
    build_train_step(model, _tcfg(mesh=((2, 1), ("data", "model")), microbatches=2),
                     mesh=Mesh(two, rank=0))
    build_zero1_train_step(model, _tcfg(mesh=((2, 1), ("data", "model")),
                                        ddl=DDLConfig(mode="zero1")),
                           plan=plan, mesh=Mesh(two, rank=0))
    params_host = dict(res, optimizer="device")
    bad = tp.MemoryPlan({}, params_host, 1, 1, 1, 1, True, swap_schedule=tp.make_swap_schedule(
        params_host, model.cfg.num_layers, "train"))
    for build in (build_train_step, build_zero1_train_step):
        with pytest.raises(NotImplementedError, match="optimizer state on the device"):
            build(model, _tcfg(mesh=((2, 1), ("data", "model")), microbatches=2), plan=bad,
                  mesh=Mesh(two, rank=0))
    mamba = Model(get_smoke_config("mamba2-1.3b"))
    assert callable(build_train_step(mamba, dataclasses.replace(
        _tcfg(mesh=((2, 1), ("data", "model")), microbatches=2), model=mamba.cfg),
        plan=plan, mesh=Mesh(two, rank=0)))
    tp_mesh = MeshSpec((1, 2), ("data", "model"))
    assert callable(build_train_step(model, _tcfg(mesh=((1, 2), ("data", "model"))),
                                     mesh=Mesh(tp_mesh, rank=0)))
    with pytest.raises(NotImplementedError, match="zero1 under tensor parallelism"):
        build_zero1_train_step(model, _tcfg(mesh=((1, 2), ("data", "model")),
                                            ddl=DDLConfig(mode="zero1")))
    with pytest.raises(ValueError, match="WORLD_SIZE 2"):
        build_train_step(model, _tcfg(mesh=((1, 2), ("data", "model"))))
    with pytest.raises(ValueError, match="WORLD_SIZE 4"):
        build_train_step(model, _tcfg(mesh=((2, 2, 1), ("pod", "data", "model"))))


def test_cli_rejects_a_world_that_disagrees_with_the_mesh(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "1")
    args = ["--arch", ARCH, "--smoke", "--no-lms", "--device", "cpu", "--steps", "1"]
    with pytest.raises(ValueError, match="WORLD_SIZE 1 disagrees with --mesh 2x1x1"):
        launch.main(args + ["--mesh", "2x1x1"])
    with pytest.raises(ValueError, match="WORLD_SIZE 1 disagrees with --mesh 1x1x2"):
        launch.main(args + ["--mesh", "1x1x2"])
    with pytest.raises(NotImplementedError, match="zero1 under tensor parallelism"):
        launch.main(args + ["--mesh", "1x1x2", "--ddl-mode", "zero1"])
    # the checkpoint flags are ported: the world is checked before anything
    # is written
    for flags in (["--mesh", "2x1x1", "--microbatches", "2", "--ckpt-dir", "ckpt"],
                  ["--mesh", "2x1x1", "--ddl-mode", "zero1", "--ckpt-every", "2"]):
        with pytest.raises(ValueError, match="WORLD_SIZE 1 disagrees with --mesh 2x1x1"):
            launch.main(args + flags)
