"""DDL's zero1 mode and the shard-major layout in the port, on the CPU,
against the JAX package: `shard_spec`, `pack_global` / `unpack_global`,
the shard keep mode of the bucketed reduction, `collect_local_shards` and
`allgather_local_shards` on 4 gloo ranks of a (2, 2) ("pod", "data") mesh
against the JAX package's on 4 emulated devices; the zero1 step,
overlapped and serialized x compress_dcn off and on, over 3 steps against
the JAX package's; the zero1 step under a plan (the optimizer's flat
shard on the device and in host memory) bitwise against the resident
zero1 step; the `Trainer` with zero1 on 2 ranks of a 1x2x1 mesh against
the JAX `Trainer`; `torchrun` of the CLI with `--ddl-mode zero1` against
the JAX launcher; and `zero1_state_from_jax`. The zero1 step also on the
olmo-1b smoke config (norm subtrees with no leaves, a tied embedding),
overlapped and serialized; and phase 3 (the params gathered from the
updated master shard) on 2 ranks at 4 layers, a layer's row of a stacked
leaf at a time.

Inputs: the qwen2.5-14b smoke config (2 layers, d_model 64, bf16 but for
the f32 embedding table) with random weights from a numpy seed
(`random_params`), 3 steps of 8 x 16 tokens of the synthetic stream, each
rank on its own 2 rows; the collectives on per-rank arrays from a numpy
seed.

Tolerances. The layout functions and the uncompressed collectives are
bitwise: the same elements moved, and every sum adds two ranks' values.
The compressed pod hop within the ulp bound of tests/test_torch_ddl.py
(XLA:CPU contracts the dequantize into an FMA; ROADMAP 3.7): 2**-21 of the
largest |value|. The step against the JAX package at the tolerances of
tests/test_torch_ddl_train.py, for its reasons (bf16 rounded at other
places, int8 codes that may round the other way): loss, ce and grad norm
within 2e-3 relative; after 3 steps every master weight within 2 lr N of
JAX's, the median within 0.01 lr N, the 99th percentile within 0.1 lr N.
The plan's step against the resident one: bitwise (the same collectives
on the same values, the update elementwise).
"""
import dataclasses
import json
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from tests.test_torch_ddl import REPO, _env, bits, init_gloo, start_jax, start_ranks, wait_all
from tests.test_torch_ddl_train import STEP_LINE, _rel, _wait_for, flat_tree, unflat_tree
from tests.test_torch_ref import jax_ref, jax_ref_scope  # noqa: F401 (autouse fixture)

from repro_torch.config import base as tb
from repro_torch.configs import get_smoke_config
from repro_torch.core.ddl import allreduce, overlap
from repro_torch.core.lms import planner as tp
from repro_torch.models.model import Model
from repro_torch.train import steps as tsteps
from repro_torch.tree import tree_leaves

ARCH = "qwen2.5-14b"
WORLD = 4
MESH = ((2, 2), ("pod", "data"))
TRAINER_MESH = ((1, 2, 1), ("pod", "data", "model"))
STEPS, BATCH, SEQ, LR = 3, 8, 16, 1e-3
# name -> (overlap_grads, compress_dcn)
VARIANTS = {"overlapped": (True, False), "overlapped_compress": (True, True),
            "serialized": (False, False), "serialized_compress": (False, True),
            "olmo-1b_overlapped": (True, False), "olmo-1b_serialized": (False, False)}
# phase 3 of the zero1 step: 2 ranks of a (1, 2) mesh, the smoke config at 4 layers
PHASE3_LAYERS, PHASE3_MESH = 4, ((1, 2), ("pod", "data"))


def _arch(variant: str) -> str:
    """The smoke config a variant of VARIANTS runs."""
    return "olmo-1b" if variant.startswith("olmo-1b") else ARCH
# plan name -> the optimizer class's residency (params on the host with it)
PLANS = {"optimizer_device": {"optimizer": "device"},
         "optimizer_host": {"optimizer": "host", "params": "host"}}
CLI = ["--arch", ARCH, "--smoke", "--mesh", "1x2x1", "--ddl-mode", "zero1",
       "--compress-dcn", "--steps", "3", "--batch", "4", "--seq", "16"]
ME = "tests.test_torch_zero1"


def _per_rank(rng, *shape, scale=1.0):
    spread = rng.uniform(0.5, 4.0, (WORLD,) + (1,) * len(shape))
    return (rng.standard_normal((WORLD,) + shape) * spread * scale).astype(np.float32)


def _collective_inputs():
    """Per-rank inputs [WORLD, ...] from a numpy seed: rank r's are [r].
    bucket/*: one layer's grads (a bf16 leaf padded to |data|, an odd f32
    one, a scalar); tree/*: a tree with a stacked leaf the hooks reduced
    (s, 3 layers), a stacked one they did not (t), an unstacked leaf (u),
    an odd one (v) and a scalar (w); flat: a local shard of that tree."""
    rng = np.random.default_rng(11)
    return {"bucket/a": _per_rank(rng, 6, 7), "bucket/b": _per_rank(rng, 5),
            "bucket/c": _per_rank(rng), "tree/s": _per_rank(rng, 3, 5, 3),
            "tree/t": _per_rank(rng, 3, 7), "tree/u": _per_rank(rng, 4, 6),
            "tree/v": _per_rank(rng, 9), "tree/w": _per_rank(rng),
            "flat": _per_rank(rng, 3 * 8 + 3 * 4 + 12 + 5 + 1)}


BUCKET_KEYS = ("a", "b", "c")
TREE_KEYS = ("s", "t", "u", "v", "w")
STACKED = {"s": True, "t": True, "u": False, "v": False, "w": False}
REDUCED = {"s": True, "t": False, "u": False, "v": False, "w": False}


def _dtype(lib, key):
    return lib.bfloat16 if key == "bucket/a" else lib.float32


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_state(ref, params, ov: bool, data: int):
    """A JAX Zero1State of `params` in the overlapped (ShardSpec) or the
    serialized (pack) layout, as its init_zero1_state builds it."""
    jnp = ref.jnp
    from repro.core.ddl import allreduce as jall, overlap as jov
    from repro.train import steps as js
    shapes = ref.jax.tree.map(lambda p: ref.jax.ShapeDtypeStruct(p.shape, p.dtype), params)
    if ov:
        flat = jov.pack_global(params, jov.shard_spec(shapes, data, js._stacked_mask(shapes)))
    else:
        flat = jall.pack(params, jall.pack_spec(shapes, pad_to=data))
    return js.Zero1State(jnp.zeros((), jnp.int32), params, jnp.zeros_like(flat),
                         jnp.zeros_like(flat), flat)


def save_zero1(path, state):
    np.savez(path, step=np.asarray(state.step), mu=np.asarray(state.mu),
             nu=np.asarray(state.nu), master=np.asarray(state.master),
             **{f"params/{k}": v for k, v in flat_tree(state.params).items()})


def load_zero1(path):
    flat = dict(np.load(path))
    return types.SimpleNamespace(step=flat["step"], params=unflat_tree(flat, "params/"),
                                 mu=flat["mu"], nu=flat["nu"], master=flat["master"])


def _batches(vocab, batch=BATCH):
    from repro_torch.data import SyntheticTokens
    data = SyntheticTokens(vocab, seed=3)
    return [data.batch(i, 0, 1, batch, SEQ) for i in range(STEPS)]


def _jax_side(out_dir):
    from tests.test_torch_ref import random_params
    ref = jax_ref()
    jax, jnp = ref.jax, ref.jnp
    from jax.sharding import PartitionSpec as P
    from repro import compat
    from repro.config import base as jb
    from repro.config.base import DDLConfig as JDDL
    from repro.core.ddl import overlap as jov
    from repro.launch import train as jlaunch
    from repro.launch.mesh import make_mesh
    from repro.train import steps as js, trainer as jtrainer
    out = pathlib.Path(out_dir)
    cmesh = compat.make_mesh(*MESH)
    dp = P(("pod", "data"))
    inp = _collective_inputs()

    def run(fn, args):
        def body(*a):
            return {k: v[None] for k, v in fn(*[x[0] for x in a]).items()}
        sm = compat.shard_map(body, mesh=cmesh, in_specs=tuple(dp for _ in args),
                              out_specs=dp, check_vma=False, axis_names={"pod", "data"})
        return {k: np.asarray(v, np.float32) for k, v in jax.jit(sm)(*args).items()}

    def arrays(prefix, keys):
        return [jnp.asarray(inp[f"{prefix}/{k}"], _dtype(jnp, f"{prefix}/{k}")) for k in keys]
    kw = dict(data_axis="data", pod_axis="pod")
    tshapes = {k: jax.ShapeDtypeStruct(inp[f"tree/{k}"].shape[1:], jnp.float32)
               for k in TREE_KEYS}
    tspec = jov.shard_spec(tshapes, 2, STACKED)
    res = {}
    for c in (False, True):
        name = "on" if c else "off"

        def bucket(*a, c=c):
            return jov.reduce_tree_bucketed(dict(zip(BUCKET_KEYS, a)), JDDL(compress_dcn=c),
                                            data_size=2, pod_size=2, keep="shard", **kw)
        res.update({f"bucket_{name}/{k}": v
                    for k, v in run(bucket, arrays("bucket", BUCKET_KEYS)).items()})

        def collect(*a, c=c):
            return {"flat": jov.collect_local_shards(
                dict(zip(TREE_KEYS, a)), tspec, REDUCED, mean_over=4, compress_dcn=c, **kw)}
        res[f"collect_{name}/flat"] = run(collect, arrays("tree", TREE_KEYS))["flat"]
    res.update({f"gather/{k}": v for k, v in run(
        lambda f: jov.allgather_local_shards(f, tspec, data_axis="data"),
        [jnp.asarray(inp["flat"])]).items()})
    np.savez(out / "jax_collectives.npz", **res)

    # the zero1 step, each variant from its layout's state of one params
    # tree of its config
    spec = jb.MeshSpec(*MESH)
    mesh = make_mesh(spec)
    res = {}
    for name, (ov, c) in VARIANTS.items():
        cfg = ref.get_smoke_config(_arch(name))
        jparams, _ = random_params(ref, cfg, seed=11)
        init = _jax_state(ref, jparams, ov, 2)
        save_zero1(out / f"init_{name}.npz", jax.tree.map(np.asarray, init))
        tcfg = jb.TrainConfig(
            model=cfg, shape=jb.ShapeConfig("t", "train", SEQ, BATCH), mesh=spec,
            lms=jb.LMSConfig(enabled=False),
            ddl=JDDL(mode="zero1", compress_dcn=c, overlap_grads=ov),
            learning_rate=LR, warmup_steps=0, total_steps=10)
        step, state_sh, batch_sh, _ = js.build_zero1_train_step(ref.Model(cfg), tcfg, mesh,
                                                                donate=False)
        state = jax.device_put(init, state_sh)
        for i, b in enumerate(_batches(cfg.vocab_size)):
            state, met = step(state, jax.device_put(
                {k: jnp.asarray(v) for k, v in b.items()}, batch_sh))
            for k in ("loss", "ce", "grad_norm", "lr"):
                res[f"{name}/{k}/{i}"] = np.float32(met[k])
        res[f"{name}/master"] = np.asarray(state.master)
    np.savez(out / "jax_steps.npz", **res)

    # the Trainer with zero1 on 1x2x1; its initial state goes to the port's
    cfg = ref.get_smoke_config(ARCH)
    tspec2 = jb.MeshSpec(*TRAINER_MESH)
    tcfg = jb.TrainConfig(
        model=cfg, shape=jb.ShapeConfig("t", "train", SEQ, 4), mesh=tspec2,
        lms=jb.LMSConfig(enabled=False), ddl=JDDL(mode="zero1", compress_dcn=True),
        learning_rate=1e-3, warmup_steps=1, total_steps=3, log_every=2,
        checkpoint_dir=str(out / "ckpt"))
    trainer = jtrainer.Trainer(tcfg)
    save_zero1(out / "trainer_init.npz", jax.tree.map(np.asarray, trainer.init_state()))
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

def _tcfg(mesh=MESH, arch=ARCH, **kw):
    return tb.TrainConfig(model=get_smoke_config(arch),
                          shape=tb.ShapeConfig("t", "train", SEQ, BATCH),
                          mesh=tb.MeshSpec(*mesh), lms=tb.LMSConfig(enabled=False),
                          learning_rate=LR, warmup_steps=0, total_steps=10,
                          **{"checkpoint_dir": None, **kw})


def _plan(cfg, residency):
    res = {"params": "device", "grads": "device", "optimizer": "device",
           "kvcache": "device", **residency}
    sched = tp.make_swap_schedule(res, cfg.num_layers, "train", prefetch_depth=2)
    return tp.MemoryPlan({"resid": "offload", "mlp_hidden": "remat"}, res, 1, 1, 1, 1,
                         True, swap_schedule=sched)


def _zero1_leaves(st):
    return [st.step, st.mu, st.nu, st.master] + tree_leaves(st.params)


def _port_collectives(mesh, rank, out):
    from repro_torch.config.base import DDLConfig
    inp = {k: torch.from_numpy(np.asarray(v[rank])).to(_dtype(torch, k)) for k, v in
           _collective_inputs().items()}
    kw = dict(mesh=mesh, data_axis="data", pod_axis="pod")
    tree = {k: inp[f"tree/{k}"] for k in TREE_KEYS}
    tspec = overlap.shard_spec({k: torch.empty(v.shape, device="meta") for k, v in tree.items()},
                               2, STACKED)
    res = {}
    for c in (False, True):
        name = "on" if c else "off"
        red = overlap.reduce_tree_bucketed({k: inp[f"bucket/{k}"].clone() for k in BUCKET_KEYS},
                                           DDLConfig(compress_dcn=c), data_size=2, pod_size=2,
                                           keep="shard", **kw)
        res.update({f"bucket_{name}/{k}": red[k] for k in BUCKET_KEYS})
        res[f"collect_{name}/flat"] = overlap.collect_local_shards(
            {k: v.clone() for k, v in tree.items()}, tspec, REDUCED, mean_over=4,
            compress_dcn=c, **kw)
    res.update({f"gather/{k}": v for k, v in overlap.allgather_local_shards(
        inp["flat"], tspec, mesh=mesh, data_axis="data").items()})
    np.savez(out / f"port_collectives_{rank}.npz",
             **{k: v.float().numpy() for k, v in res.items()})


def _port_steps(rank, world, out_dir):
    """The collectives, then every zero1 variant from JAX's initial state,
    then the steps under a plan against the resident ones (the port's
    init), on this rank of the (2, 2) mesh."""
    from repro_torch.convert import zero1_state_from_jax
    from repro_torch.data import local_rows
    from repro_torch.launch.mesh import make_mesh
    out = pathlib.Path(out_dir)
    init_gloo(rank, world, out)
    mesh = make_mesh(tb.MeshSpec(*MESH))
    _port_collectives(mesh, rank, out)
    cfg = get_smoke_config(ARCH)
    model = Model(cfg)
    data_index = mesh.index("data")
    batches = [{k: torch.from_numpy(v) for k, v in local_rows(b, mesh.dp_index,
                                                              mesh.dp_size).items()}
               for b in _batches(cfg.vocab_size)]
    res = {}
    for name, (ov, c) in VARIANTS.items():
        _wait_for(out / f"init_{name}.npz")
        tcfg = _tcfg(arch=_arch(name),
                     ddl=tb.DDLConfig(mode="zero1", compress_dcn=c, overlap_grads=ov))
        step = tsteps.build_zero1_train_step(Model(tcfg.model), tcfg, mesh=mesh)
        assert isinstance(step.layout, overlap.ShardSpec) == ov
        state = zero1_state_from_jax(load_zero1(out / f"init_{name}.npz"), "cpu",
                                     data_index, 2)
        for i, b in enumerate(batches):
            state, met = step(state, b)
            for k in ("loss", "ce", "grad_norm", "lr"):
                res[f"{name}/{k}/{i}"] = np.float32(met[k].item())
        res[f"{name}/master"] = state.master.numpy()
        res.update({f"{name}/params/{k}": v for k, v in flat_tree(state.params).items()})
    np.savez(out / f"port_steps_{rank}.npz", **res)

    # under a plan, bitwise against the resident step of the same config
    bitwise = {}
    for ov in (True, False):
        tcfg = _tcfg(ddl=tb.DDLConfig(mode="zero1", compress_dcn=True, overlap_grads=ov))

        def run(plan):
            state = tsteps.init_zero1_state(model, tcfg, 5, "cpu", 2, plan=plan,
                                            data_index=data_index)
            step = tsteps.build_zero1_train_step(model, tcfg, plan=plan, mesh=mesh)
            mets = []
            for b in batches:
                state, met = step(state, b)
                mets.append({k: v.item() for k, v in met.items()})
            return mets, state, step.queue is not None
        base, base_state, _ = run(None)
        for name, residency in PLANS.items():
            mets, state, queued = run(_plan(cfg, residency))
            bitwise[f"{name}/overlap={ov}"] = {
                "metrics": mets == base, "queued": queued,
                "state": all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                             zip(_zero1_leaves(state), _zero1_leaves(base_state)))}
    (out / f"port_bitwise_{rank}.json").write_text(json.dumps(bitwise))


def _port_sliced(rank, world, out_dir):
    """zero1 under the params-host plan (the unstacked rest in the pinned
    arena beside the stack) on this rank of a 1x2x1 mesh, 3 steps from one
    init: as it runs, then with `overlap.POD_SLICE` and `steps.SLICE` cut
    to 64 elements and `rest.HEAD_ROWS` to 8, so the rest's grads are
    reduce-scattered and its new params gathered in pieces
    (`local_shard_parts`, `_zero1_params_from`), the head's grad formed a
    block of 8 rows at a time (`models/rest.HeadGrad`)."""
    from repro_torch.core.lms import offload as off
    from repro_torch.models import rest
    from repro_torch.data import local_rows
    from repro_torch.launch.mesh import make_mesh
    out = pathlib.Path(out_dir)
    init_gloo(rank, world, out)
    mesh = make_mesh(tb.MeshSpec(*PHASE3_MESH))
    tcfg = _tcfg(mesh=PHASE3_MESH, ddl=tb.DDLConfig(mode="zero1", overlap_grads=True))
    model = Model(tcfg.model)
    plan = _plan(tcfg.model, PLANS["optimizer_host"])
    batches = [{k: torch.from_numpy(v) for k, v in local_rows(b, mesh.dp_index,
                                                              mesh.dp_size).items()}
               for b in _batches(tcfg.model.vocab_size)]
    scatters = []
    psum_scatter = mesh.psum_scatter

    def spy(x, axis):
        scatters.append(x.numel())
        return psum_scatter(x, axis)
    mesh.psum_scatter = spy

    def run():
        state = tsteps.init_zero1_state(model, tcfg, 5, "cpu", 2, plan=plan,
                                        data_index=mesh.index("data"))
        arena = off._ARENAS[-1]
        lo, hi = arena.buffer.data_ptr(), arena.buffer.data_ptr() + arena.buffer.numel()
        placed = all(lo <= t.data_ptr() < hi for t in tree_leaves(state.params))
        step = tsteps.build_zero1_train_step(model, tcfg, plan=plan, mesh=mesh)
        mets = []
        for b in batches:
            state, met = step(state, b)
            mets.append({k: v.item() for k, v in met.items()})
        return mets, state, placed
    base, base_state, placed = run()
    whole = len(scatters)
    saved = overlap.POD_SLICE, tsteps.SLICE, rest.HEAD_ROWS
    overlap.POD_SLICE = tsteps.SLICE = 64
    rest.HEAD_ROWS = 8
    try:
        mets, state, _ = run()
    finally:
        overlap.POD_SLICE, tsteps.SLICE, rest.HEAD_ROWS = saved
    (out / f"sliced_{rank}.json").write_text(json.dumps({
        "placed": placed, "metrics": mets == base, "sliced": len(scatters) - whole > whole,
        "state": all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                     zip(_zero1_leaves(state), _zero1_leaves(base_state)))}))


def _port_phase3(rank, world, out_dir):
    """One zero1 step (overlapped: the ShardSpec layout) on this rank of a
    (1, 2) mesh at PHASE3_LAYERS layers, every `mesh.all_gather` recorded
    (the shape it gathers); then the whole-leaf gather of the updated
    master (`allgather_local_shards`), cast to each param's dtype."""
    from repro_torch.data import local_rows
    from repro_torch.launch.mesh import make_mesh
    out = pathlib.Path(out_dir)
    init_gloo(rank, world, out)
    mesh = make_mesh(tb.MeshSpec(*PHASE3_MESH))
    tcfg = dataclasses.replace(
        _tcfg(mesh=PHASE3_MESH, ddl=tb.DDLConfig(mode="zero1", overlap_grads=True)),
        model=dataclasses.replace(get_smoke_config(ARCH), num_layers=PHASE3_LAYERS))
    model = Model(tcfg.model)
    step = tsteps.build_zero1_train_step(model, tcfg, mesh=mesh)
    state = tsteps.init_zero1_state(model, tcfg, 5, "cpu", 2, data_index=mesh.index("data"))
    gathered = []
    all_gather = mesh.all_gather

    def spy(t, axis):
        gathered.append(list(t.shape))
        return all_gather(t, axis)
    b = _batches(tcfg.model.vocab_size)[0]
    mesh.all_gather = spy
    state, _ = step(state, {k: torch.from_numpy(v) for k, v in
                            local_rows(b, mesh.dp_index, mesh.dp_size).items()})
    mesh.all_gather = all_gather
    whole = overlap.allgather_local_shards(state.master, step.layout, mesh=mesh,
                                           data_axis="data")
    layout = step.layout
    np.savez(out / f"phase3_{rank}.npz", gathered=np.asarray(gathered),
             rows=np.asarray(layout.rows),
             sl=np.asarray([pr // layout.data_size for pr in layout.padded_rows]),
             same=np.asarray([torch.equal(p, w.to(p.dtype)) for p, w in
                              zip(tree_leaves(state.params), tree_leaves(whole))]))


def _port_trainer(rank, world, out_dir):
    """The Trainer with zero1 on this rank of the 1x2x1 mesh, from the JAX
    trainer's initial state."""
    from repro_torch.convert import zero1_state_from_jax
    from repro_torch.train.trainer import Trainer
    out = pathlib.Path(out_dir)
    init_gloo(rank, world, out / "trainer")
    tcfg = dataclasses.replace(
        _tcfg(mesh=TRAINER_MESH, ddl=tb.DDLConfig(mode="zero1", compress_dcn=True)),
        shape=tb.ShapeConfig("t", "train", SEQ, 4), warmup_steps=1, total_steps=3,
        log_every=2)
    trainer = Trainer(tcfg, device="cpu")
    own = trainer.init_state()
    assert isinstance(own, tsteps.Zero1State) and own.master.numel() == \
        tsteps._local_size(trainer.step_fn.layout)
    _wait_for(out / "trainer_init.npz")
    trainer.init_state = lambda: zero1_state_from_jax(load_zero1(out / "trainer_init.npz"),
                                                      "cpu", rank, 2)
    state, hist = trainer.train(steps=3)
    np.savez(out / f"port_trainer_{rank}.npz",
             **{f"{k}/{r['step']}": np.float64(r[k]) for r in hist
                for k in ("loss", "ce", "grad_norm", "lr")},
             **{f"params/{k}": v for k, v in flat_tree(state.params).items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every side at once: the JAX subprocess (4 devices), the port's 4
    ranks, 2 ranks of the Trainer, and torchrun of the CLI."""
    out = tmp_path_factory.mktemp("zero1")
    (out / "trainer").mkdir()
    (out / "phase3").mkdir()
    (out / "sliced").mkdir()
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--device", "cpu"]
        + CLI + ["--ckpt-dir", str(out / "port_cli_ckpt")], cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    procs = (start_jax(ME, "_jax_side", out, devices=WORLD)
             + start_ranks(ME, "_port_steps", out, WORLD)
             + start_ranks(ME, "_port_trainer", out, 2)
             + start_ranks(ME, "_port_phase3", out / "phase3", 2)
             + start_ranks(ME, "_port_sliced", out / "sliced", 2) + [cli])
    outs = wait_all(procs, timeout=300)
    return out, outs[-1]


# ---------------------------------------------------------------------------
# the layout (one process)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    return jax_ref()


def _smoke_shapes(ref):
    """The smoke config's params as shapes on both sides, and the JAX
    package's stacked mask."""
    from repro.train import steps as js
    jshapes = ref.jax.tree.map(lambda d: ref.jax.ShapeDtypeStruct(d.shape, d.dtype),
                               ref.Model(ref.get_smoke_config(ARCH)).param_defs(),
                               is_leaf=lambda x: isinstance(x, ref.layers.ParamDef))
    return jshapes, js._stacked_mask(jshapes), tsteps._meta_params(Model(get_smoke_config(ARCH)))


@pytest.mark.parametrize("data", [1, 2, 3])
def test_shard_spec_matches_jax(ref, data):
    """shard_spec of the smoke config's params (the stack's leaves
    stacked) on |data| 1, 2 and 3: every field equal to the JAX
    package's; the port's stacked mask is JAX's."""
    from repro.core.ddl import overlap as jov
    jshapes, jmask, shapes = _smoke_shapes(ref)
    mask = tsteps._stacked_mask(shapes)
    assert tree_leaves(mask) == ref.jax.tree.leaves(jmask)
    got, want = overlap.shard_spec(shapes, data, mask), jov.shard_spec(jshapes, data, jmask)
    assert got.shapes == want.shapes and got.rows == want.rows
    assert got.rowsizes == want.rowsizes and got.padded_rows == want.padded_rows
    assert (got.local_size, got.padded, got.data_size) == (want.local_size, want.padded,
                                                           want.data_size)
    assert [str(d).split(".")[-1] for d in got.dtypes] == [str(d) for d in want.dtypes]


@pytest.mark.parametrize("data", [1, 2, 3])
def test_pack_global_matches_jax_and_round_trips(ref, data):
    """pack_global of random smoke params bitwise equal to the JAX
    package's, unpack_global back to the f32 leaves bitwise on both sides;
    each rank's block by `rank_block` and the serialized layout's by
    `pack_block` equal to the global vectors' blocks."""
    from tests.test_torch_ref import random_params
    from repro.core.ddl import allreduce as jall, overlap as jov
    from repro_torch.convert import params_from_jax
    jshapes, jmask, shapes = _smoke_shapes(ref)
    jparams, _ = random_params(ref, ref.get_smoke_config(ARCH), seed=2)
    params = params_from_jax(ref.jax.tree.map(np.asarray, jparams), "cpu")
    spec = overlap.shard_spec(shapes, data, tsteps._stacked_mask(shapes))
    flat = overlap.pack_global(params, spec)
    jflat = jov.pack_global(jparams, jov.shard_spec(jshapes, data, jmask))
    assert flat.dtype == torch.float32 and flat.shape == (spec.padded,)
    assert np.array_equal(bits(flat), bits(jflat))
    back = overlap.unpack_global(flat, spec)
    jback = jov.unpack_global(jflat, jov.shard_spec(jshapes, data, jmask))
    for a, b, p in zip(tree_leaves(back), ref.jax.tree.leaves(jback), tree_leaves(params)):
        assert a.dtype == torch.float32 and a.shape == p.shape
        assert torch.equal(a, p.float()) and np.array_equal(bits(a), bits(b))
    pspec = allreduce.pack_spec(shapes, pad_to=data)
    packed = allreduce.pack(params, pspec)
    n = spec.local_size
    for r in range(data):
        block = overlap.rank_block(params, spec, r, torch.full((n,), float("nan")))
        assert torch.equal(block, flat[r * n:(r + 1) * n])
        m = pspec.padded // data
        block = allreduce.pack_block(params, pspec, r, torch.full((m,), float("nan")))
        assert torch.equal(block, packed[r * m:(r + 1) * m])


# ---------------------------------------------------------------------------
# the collectives on 4 ranks against the JAX (2, 2) mesh
# ---------------------------------------------------------------------------

COLLECTIVES_BITWISE = ([f"bucket_off/{k}" for k in BUCKET_KEYS] + ["collect_off/flat"]
                       + [f"gather/{k}" for k in TREE_KEYS])
COLLECTIVES_COMPRESSED = [f"bucket_on/{k}" for k in BUCKET_KEYS] + ["collect_on/flat"]


@pytest.mark.parametrize("name", COLLECTIVES_BITWISE + COLLECTIVES_COMPRESSED)
def test_shard_collectives_match_jax(runs, name):
    """The shard keep mode of the bucketed reduction (each leaf a zero
    grad but for this rank's slot, a bf16 leaf rounded as JAX's cotangent
    is), collect_local_shards (a stacked leaf the hooks reduced sliced,
    the rest reduce-scattered, a stacked one by rows) and
    allgather_local_shards: each rank's result against the JAX device's at
    the same coordinate, bitwise uncompressed; compressed within 2**-21 of
    the largest |value| (a bf16 leaf: one bf16 ulp)."""
    out, _ = runs
    jres = dict(np.load(out / "jax_collectives.npz"))
    for r in range(WORLD):
        got = dict(np.load(out / f"port_collectives_{r}.npz"))[name]
        want = jres[name][r]
        assert got.shape == want.shape, name
        if name in COLLECTIVES_BITWISE:
            assert np.array_equal(bits(got), bits(want)), (name, r)
        elif name == "bucket_on/a":
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
            assert np.all(np.abs(got - want) <= ulp), (name, r)
        else:
            assert np.abs(got - want).max() <= 2.0 ** -21 * np.abs(want).max(), (name, r)


# ---------------------------------------------------------------------------
# the zero1 step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_zero1_step_on_4_ranks_matches_jax(runs, variant):
    """Per step loss, ce, grad norm and lr against the JAX zero1 step on
    the (2, 2) mesh, from the same state (converted by
    zero1_state_from_jax); after 3 steps the global master vector (the
    ranks' blocks of pod 0 side by side) against JAX's; the pods' blocks
    and every rank's params bitwise the same."""
    out, _ = runs
    jres = dict(np.load(out / "jax_steps.npz"))
    ranks = [dict(np.load(out / f"port_steps_{r}.npz")) for r in range(WORLD)]
    for i in range(STEPS):
        for k, tol in (("loss", 2e-3), ("ce", 2e-3), ("grad_norm", 2e-3), ("lr", 1e-6)):
            key = f"{variant}/{k}/{i}"
            for r in range(WORLD):
                assert _rel(ranks[r][key], jres[key]) <= tol, (key, r, ranks[r][key], jres[key])
    master = np.concatenate([ranks[r][f"{variant}/master"] for r in (0, 1)])
    want = jres[f"{variant}/master"]
    assert master.shape == want.shape
    diff = np.abs(master - want)
    unit = LR * STEPS
    assert diff.max() <= 2 * unit + 1e-6, diff.max() / unit
    assert np.median(diff) <= 0.01 * unit, np.median(diff) / unit
    assert np.percentile(diff, 99) <= 0.1 * unit, np.percentile(diff, 99) / unit
    for r in (2, 3):
        assert np.array_equal(bits(ranks[r][f"{variant}/master"]),
                              bits(ranks[r - 2][f"{variant}/master"]))
    for k in ranks[0]:
        if k.startswith(f"{variant}/params/"):
            for r in range(1, WORLD):
                assert np.array_equal(bits(ranks[r][k]), bits(ranks[0][k])), (k, r)


def test_zero1_phase3_gathers_a_layer_at_a_time(runs):
    """Phase 3 of the zero1 step (the params gathered from the updated
    master shard) at 4 stacked layers on 2 ranks: every all-gather of the
    step takes one row of a leaf ([1, sl]: one layer of a stacked leaf, or
    a whole unstacked one), one per row of every leaf, so no stacked leaf
    stands gathered whole; the params equal the whole-leaf gather
    (`allgather_local_shards`) cast to their dtype, bitwise."""
    out, _ = runs
    for r in range(2):
        got = dict(np.load(out / "phase3" / f"phase3_{r}.npz"))
        rows, sl = got["rows"], got["sl"]
        assert PHASE3_LAYERS in rows.tolist()
        gathered = got["gathered"].tolist()
        assert all(g[0] == 1 for g in gathered), gathered
        assert sorted(g[1] for g in gathered) == sorted(
            int(n) for n, k in zip(sl, rows) for _ in range(k))
        assert got["same"].all()


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("ov", [True, False])
def test_zero1_under_a_plan_equals_resident_bitwise(runs, plan, ov):
    """The zero1 step under a plan (the LMS executor; the flat state on the
    device, or in host memory with the params' stack, streamed through in
    slices) against the resident zero1 step, compress_dcn, 3 steps from
    one init: every metric and every state leaf bitwise, on every rank;
    overlapped through the executor's queue in shard mode."""
    out, _ = runs
    for r in range(WORLD):
        got = json.loads((out / f"port_bitwise_{r}.json").read_text())[f"{plan}/overlap={ov}"]
        assert got == {"metrics": True, "state": True, "queued": ov}, (r, got)


def test_zero1_rest_on_host_reduced_in_slices_is_bitwise(runs):
    """zero1 under a plan that puts params on the host: every param leaf,
    the unstacked rest's too, lies in the pinned arena, and the rest's
    grads reduced and its params gathered in 64-element pieces (more
    reduce-scatters than whole leaves) give every metric and state leaf of
    3 steps bitwise, on both ranks."""
    out, _ = runs
    for r in range(2):
        got = json.loads((out / "sliced" / f"sliced_{r}.json").read_text())
        assert got == {"placed": True, "metrics": True, "sliced": True, "state": True}, (r, got)


def test_trainer_zero1_on_1x2x1_matches_jax_trainer(runs):
    """The port's Trainer with zero1 (compress_dcn, the overlapped
    backward) on 2 ranks against the JAX Trainer on 2 devices from the
    same state: each step's loss, ce, grad norm and lr within 2e-3; both
    ranks' histories and params the same."""
    out, _ = runs
    j = dict(np.load(out / "jax_trainer.npz"))
    ranks = [dict(np.load(out / f"port_trainer_{r}.npz")) for r in range(2)]
    for s in (1, 2, 3):
        for k in ("loss", "ce", "grad_norm"):
            assert _rel(ranks[0][f"{k}/{s}"], j[f"{k}/{s}"]) <= 2e-3, (k, s)
        assert _rel(ranks[0][f"lr/{s}"], j[f"lr/{s}"]) <= 1e-6 or j[f"lr/{s}"] == 0
    for k in ranks[0]:
        assert np.array_equal(ranks[1][k], ranks[0][k]), k


def test_torchrun_cli_zero1_matches_jax_launcher(runs):
    """torchrun of the CLI with --ddl-mode zero1 on 2 CPU ranks (LMS on,
    compress_dcn) prints the JAX launcher's step lines once, from rank 0:
    the same steps and lrs, finite losses and grad norms, the final-loss
    line."""
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


@pytest.mark.parametrize("variant", ["overlapped", "serialized"])
def test_zero1_state_from_jax_is_exact(runs, variant):
    """Each rank's converted state: mu, nu and master its block of the JAX
    flat vectors bit for bit, the params the JAX params; the master block
    is what the port's own layout functions make of those params."""
    from repro_torch.convert import zero1_state_from_jax
    out, _ = runs
    j = load_zero1(out / f"init_{variant}.npz")
    tcfg = _tcfg(ddl=tb.DDLConfig(mode="zero1", overlap_grads=variant == "overlapped"))
    overlapped, layout = tsteps._zero1_layout(Model(tcfg.model), tcfg, 2, 4)
    assert overlapped == (variant == "overlapped")
    n = j.master.shape[0] // 2
    for r in range(2):
        st = zero1_state_from_jax(j, "cpu", r, 2)
        for got, want in ((st.mu, j.mu), (st.nu, j.nu), (st.master, j.master)):
            assert got.dtype == torch.float32
            assert np.array_equal(bits(got), bits(want[r * n:(r + 1) * n]))
        made = torch.full((n,), float("nan"))
        if overlapped:
            overlap.rank_block(st.params, layout, r, made)
        else:
            allreduce.pack_block(st.params, layout, r, made)
        assert torch.equal(made, st.master)
        assert int(st.step) == 0


def test_init_zero1_state_is_the_rank_block_of_the_init(tmp_path):
    """init_zero1_state on one device: the params are `Model.init`'s
    bitwise, with a plan too (the stack in host memory, the flat state
    there), and the master the f32 params in the layout; data_index picks
    the block."""
    tcfg = _tcfg(mesh=((1, 1), ("data", "model")), ddl=tb.DDLConfig(mode="zero1"))
    model = Model(tcfg.model)
    params = model.init(5, "cpu")
    plan = _plan(tcfg.model, PLANS["optimizer_host"])
    for p in (None, plan):
        st = tsteps.init_zero1_state(model, tcfg, 5, "cpu", 1, plan=p, data_index=0)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(st.params), tree_leaves(params)))
        assert torch.equal(st.master, allreduce.pack(params, tsteps._zero1_layout(
            model, tcfg, 1, 1)[1]))
        assert not st.mu.any() and not st.nu.any()
    two = dataclasses.replace(tcfg, mesh=tb.MeshSpec(*TRAINER_MESH))
    _, layout = tsteps._zero1_layout(model, two, 2, 2)
    flat = overlap.pack_global(params, layout)
    for r in range(2):
        st = tsteps.init_zero1_state(model, two, 5, "cpu", 2, data_index=r)
        n = layout.local_size
        assert torch.equal(st.master, flat[r * n:(r + 1) * n])
