"""The tensor-parallel train step against the JAX package, on the CPU:
`build_train_step` on 4 gloo ranks of a 1x2x2 and a 2x1x2 ("pod", "data",
"model") mesh against the JAX package's step on the same mesh of 4
emulated devices (GSPMD over `model`, DDL over the data axes), with the
overlapped backward off and on, the int8 pod hop (`compress_dcn`) on the
2x1x2 mesh, and 2 microbatches with the overlap (the sharded accumulator
of this rank's blocks); and DDL's reduction of one layer's grads with the
leaves' specs: the sharded leaves out of the buckets and the int8 hop.

The qwen2.5-14b smoke config (2 layers, 4 / 2 heads, d_ff 128, vocab 256:
2 / 1 heads, 64 of `ff` and 128 vocab rows a rank) runs in bf16 from one
random state converted by `train_state_from_jax(mesh=)`, 3 steps of 8 x 16
tokens, each data rank on its own rows. The bounds are
`test_torch_ddl_train`'s: loss, ce and grad norm within 2e-3 relative
(measured at most 5.8e-4); after 3 Adam steps of rate lr each master
weight within 2 lr N of JAX's (measured at most 1.81, with compress_dcn:
an int8 code that rounds the other way, `test_torch_ddl_train`'s
reason), the median within 0.01 lr N (measured 0.0015) and the 99th
percentile within 0.1 lr N (measured 0.028). After the steps every
`model` rank's replicated leaves (params and masters) are bitwise equal,
and so is each block across the data ranks that hold it.
"""
import pathlib
import types

import numpy as np
import pytest
import torch

from tests.test_torch_ddl import init_gloo, start_jax, start_ranks, wait_all
from tests.test_torch_ddl_train import _wait_for, flat_tree, save_state, unflat_tree
from tests.test_torch_ref import jax_ref_scope  # noqa: F401 (autouse fixture)
from tests.test_torch_tp_model import _block, _spec_dims

from repro_torch.config.base import (DDLConfig, LMSConfig, MeshSpec, ShapeConfig,
                                     TrainConfig)
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import Model
from repro_torch.train.steps import build_train_step

ARCH = "qwen2.5-14b"
AXES = ("pod", "data", "model")
STEPS, BATCH, SEQ, LR = 3, 8, 16, 1e-3
# name -> (mesh shape, compress_dcn, overlap_grads, microbatches)
VARIANTS = {"1x2x2_plain": ((1, 2, 2), False, False, 1),
            "1x2x2_overlap": ((1, 2, 2), False, True, 1),
            "2x1x2_compress": ((2, 1, 2), True, False, 1),
            "2x1x2_compress_overlap": ((2, 1, 2), True, True, 1),
            "1x2x2_overlap_microbatches_2": ((1, 2, 2), False, True, 2)}
ME = "tests.test_torch_tp_train"


def _batches(vocab):
    from repro_torch.data import SyntheticTokens
    data = SyntheticTokens(vocab, seed=3)
    return [data.batch(i, 0, 1, BATCH, SEQ) for i in range(STEPS)]


def tp_state_from_npz(path, cfg, mesh, device="cpu"):
    """A JAX TrainState saved by `save_state` -> this rank's blocks of it."""
    from repro_torch.convert import train_state_from_jax
    flat = dict(np.load(path))
    opt = types.SimpleNamespace(step=flat["opt_step"], mu=unflat_tree(flat, "mu/"),
                                nu=unflat_tree(flat, "nu/"), master=unflat_tree(flat, "master/"))
    st = types.SimpleNamespace(step=flat["step"], params=unflat_tree(flat, "params/"), opt=opt)
    return train_state_from_jax(st, device, mesh, cfg)


def _jax_side(out_dir):
    """Every variant's 3 steps on its mesh of 4 emulated devices."""
    from tests.test_torch_ref import jax_ref, random_params
    ref = jax_ref()
    jax, jnp = ref.jax, ref.jnp
    from repro.config import base as jb
    from repro.launch.mesh import make_mesh
    from repro.optim.adamw import adamw_init
    from repro.train import steps as js
    out = pathlib.Path(out_dir)
    cfg = ref.get_smoke_config(ARCH)
    jparams, _ = random_params(ref, cfg, seed=13)
    init = js.TrainState(jnp.zeros((), jnp.int32), jparams, adamw_init(jparams))
    save_state(out / "init.npz", jax.tree.map(np.asarray, init))
    res = {}
    for name, (shape, c, ov, m) in VARIANTS.items():
        spec = jb.MeshSpec(shape, AXES)
        tcfg = jb.TrainConfig(
            model=cfg, shape=jb.ShapeConfig("t", "train", SEQ, BATCH), mesh=spec,
            lms=jb.LMSConfig(enabled=False), ddl=jb.DDLConfig(compress_dcn=c),
            learning_rate=LR, warmup_steps=0, total_steps=10, microbatches=m)
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
    np.savez(out / "jax_steps.npz", **res)


def _port_steps(rank, world, out_dir):
    """Every variant on this rank of its mesh, from JAX's initial state."""
    from repro_torch.data import local_rows
    from repro_torch.launch.mesh import make_mesh
    out = pathlib.Path(out_dir)
    init_gloo(rank, world, out)
    _wait_for(out / "init.npz")
    cfg = get_smoke_config(ARCH)
    res = {}
    for name, (shape, c, ov, m) in VARIANTS.items():
        spec = MeshSpec(shape, AXES)
        mesh = make_mesh(spec)
        tcfg = TrainConfig(
            model=cfg, shape=ShapeConfig("t", "train", SEQ, BATCH), mesh=spec,
            lms=LMSConfig(enabled=False), ddl=DDLConfig(compress_dcn=c, overlap_grads=ov),
            learning_rate=LR, warmup_steps=0, total_steps=10, microbatches=m,
            checkpoint_dir=None)
        step = build_train_step(Model(cfg), tcfg, mesh=mesh)
        assert (step.queue is not None) == ov
        state = tp_state_from_npz(out / "init.npz", cfg, mesh)
        for i, b in enumerate(_batches(cfg.vocab_size)):
            rows = local_rows(b, mesh.dp_index, mesh.dp_size)
            state, met = step(state, {k: torch.from_numpy(v) for k, v in rows.items()})
            for k in ("loss", "ce", "grad_norm", "lr"):
                res[f"{name}/{k}/{i}"] = np.float32(met[k].item())
        res.update({f"{name}/master/{k}": v for k, v in flat_tree(state.opt.master).items()})
        res.update({f"{name}/params/{k}": v for k, v in flat_tree(state.params).items()})
        res[f"{name}/coords"] = np.array([mesh.index(a) for a in AXES])
    np.savez(out / f"port_steps_{rank}.npz", **res)


def _port_buckets(rank, world, out_dir):
    """One layer's grads reduced by the overlapped backward's hook with
    and without the specs, on 4 ranks of 2x1x2 with compress_dcn: the
    reduced leaves and how many quantize calls each made."""
    from repro_torch.core.ddl import allreduce, overlap
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.tree import tree_leaves
    out = pathlib.Path(out_dir)
    init_gloo(rank, world, out / "buckets")
    spec = MeshSpec((2, 1, 2), AXES)
    mesh = make_mesh(spec)
    model = Model(get_smoke_config(ARCH))
    layer = model.param_specs(mesh)["decoder"]["stack0"]
    specs = [sp[1:] for sp in tree_leaves(layer)]
    gen = torch.Generator().manual_seed(100 + rank)
    defs = model.local_param_defs(mesh)["decoder"]["stack0"]
    grads = {k: v for k, v in _layer_grads(defs, gen).items()}
    calls = []
    saved = allreduce.compressed_allreduce_pod
    allreduce.compressed_allreduce_pod = (
        lambda x, *a, **k: calls.append(x.numel()) or saved(x, *a, **k))
    try:
        res = {}
        for name, sp in (("specs", specs), ("none", None)):
            calls.clear()
            red = overlap.reduce_tree_bucketed(
                _clone(grads), DDLConfig(compress_dcn=True), mesh=mesh, data_axis="data",
                pod_axis="pod", data_size=1, pod_size=2, param_specs=sp)
            res.update({f"{name}/{k}": v for k, v in flat_tree(red).items()})
            res[f"{name}/quantized"] = np.array(sum(calls))
    finally:
        allreduce.compressed_allreduce_pod = saved
    res.update({f"in/{k}": v for k, v in flat_tree(grads).items()})
    np.savez(out / f"port_buckets_{rank}.npz", **res)


def _layer_grads(defs, gen):
    """Random grads of one layer's leaves (the layer dim dropped)."""
    def go(d):
        if isinstance(d, dict):
            return {k: go(v) for k, v in d.items()}
        return torch.randn(d.shape[1:], generator=gen).to(torch.bfloat16)
    return go(defs)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_train")
    (out / "buckets").mkdir()
    procs = (start_jax(ME, "_jax_side", out, devices=4) + start_ranks(ME, "_port_steps", out, 4)
             + start_ranks(ME, "_port_buckets", out, 4))
    wait_all(procs, timeout=300)
    return out


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tp_train_step_matches_jax(runs, variant):
    """Per step: loss, ce, grad norm and lr of every rank against the JAX
    step on the same mesh; after 3 steps each rank's master blocks against
    JAX's; replicated leaves bitwise equal across `model`, blocks across
    the data ranks."""
    j = dict(np.load(runs / "jax_steps.npz"))
    ranks = [dict(np.load(runs / f"port_steps_{r}.npz")) for r in range(4)]
    for i in range(STEPS):
        for k, tol in (("loss", 2e-3), ("ce", 2e-3), ("grad_norm", 2e-3), ("lr", 1e-6)):
            key = f"{variant}/{k}/{i}"
            for r, res in enumerate(ranks):
                assert _rel(res[key], j[key]) <= tol, (key, r, res[key], j[key])
    dims = _spec_dims(ARCH, 2)
    unit = LR * STEPS
    prefix = f"{variant}/master/"
    diffs = []
    for res in ranks:
        m = int(res[f"{variant}/coords"][2])
        for key in j:
            if key.startswith(prefix) and not key.endswith("@empty"):
                name = key[len(prefix):].replace("@bf16", "")
                diffs.append(np.abs(res[key] - _block(j[key], dims[name], m, 2)).ravel())
    diff = np.concatenate(diffs)
    assert diff.max() <= 2 * unit + 1e-6, diff.max() / unit
    assert np.median(diff) <= 0.01 * unit, np.median(diff) / unit
    assert np.percentile(diff, 99) <= 0.1 * unit, np.percentile(diff, 99) / unit
    for a in ranks:
        for b in ranks:
            ca, cb = a[f"{variant}/coords"], b[f"{variant}/coords"]
            for key in a:
                if not (key.startswith(f"{variant}/params/") or key.startswith(prefix)):
                    continue
                name = key.split("/", 2)[2].replace("@bf16", "").replace("@empty", "")
                if dims.get(name) is None or ca[2] == cb[2]:
                    assert np.array_equal(a[key].view(np.int32), b[key].view(np.int32)), (
                        key, ca, cb)


def test_sharded_leaves_skip_the_buckets_and_the_int8_hop(runs):
    """One layer's grads on 2x1x2 with compress_dcn, through the hook's
    reduction: with the specs, each sharded leaf is the exact f32 mean of
    its two pods' blocks (no int8 code), and only the replicated leaves
    were quantized; without them (everything bucketed) the sharded leaves
    went through the int8 hop too."""
    ranks = [dict(np.load(runs / f"port_buckets_{r}.npz")) for r in range(4)]
    dims = _spec_dims(ARCH, 2)
    layer = {k.split("/", 2)[2]: v for k, v in dims.items() if k.startswith("decoder/")}
    for r, res in enumerate(ranks):
        peer = ranks[r ^ 2]          # the other pod, the same model index
        replicated = 0
        for key in res:
            if not key.startswith("specs/") or key == "specs/quantized":
                continue
            name = key[len("specs/"):]
            leaf = name.replace("@bf16", "")
            if layer[leaf] is None:
                replicated += res[f"in/{name}"].size
                continue
            want = ((res[f"in/{name}"].astype(np.float32) + peer[f"in/{name}"]) / 2)
            want = torch.from_numpy(want).to(torch.bfloat16).float().numpy()
            assert np.array_equal(res[key], want), (r, key)
            assert not np.array_equal(res[f"none/{name}"], want), (r, key)
        assert int(res["specs/quantized"]) == replicated > 0
        assert int(res["none/quantized"]) > int(res["specs/quantized"])
