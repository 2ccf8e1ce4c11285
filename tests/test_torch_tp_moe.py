"""The MoE family under expert parallelism in the port against the JAX
package, on the CPU: 2 gloo ranks of a 1x1x2 ("pod", "data", "model") mesh
against the JAX package on a (1, 1, 2) mesh of emulated devices, the
`experts` axis on `model` (qwen3-moe-235b-a22b smoke: 8 experts, 4 a
rank, top-2, SwiGLU; grok-1-314b smoke: 4 experts, 2 a rank, GeGLU):

- `apply_moe` (one layer's params, 2 x 16 tokens, capacity factor 1.25
  and 0.5) and its grads for a fixed cotangent, in f32 and in bf16, with
  the capacity drops (`moe.dropped()`) equal on both ranks and to the
  drops of JAX's routing;
- the qwen3-moe smoke engine on the mesh, teacher-forced against the JAX
  engine on the mesh (test_torch_serve.py's trace);
- 3 train steps of the qwen3-moe smoke config on the mesh against the
  JAX train step on the same mesh.
The specs of both MoE configs, smoke and full, are held to the JAX
package's in tests/test_torch_tp_model.py::test_specs_match_jax.

Tolerances (stated with the worst case measured on this CPU):
- the layer in f32: 1e-5 of the largest |value| of y and of each grad
  (tests/test_torch_moe.py's bound; measured at most 7.0e-7 and 1.6e-6);
  in bf16 2**-5 of the largest |y| and 2**-4 of the largest |grad|
  (measured 2**-7.3 and 2**-6.1); the routing, the ranks and the drops are the
  same integers on both ranks and in JAX; y, the aux loss and every
  replicated grad (the router's, the input's) are bitwise the same on
  both ranks;
- the engine: each teacher-forced logits row within 2**-5 of its largest
  |logit| (measured 2**-5.8), the pool's counters equal;
- the train step: loss and ce within 2e-3 relative of JAX's, the masters
  within 2 lr N at most, 0.01 lr N at the median and 0.1 lr N at the 99th
  percentile (tests/test_torch_tp_train.py's bounds; measured 1.6e-4
  relative and 1.43 / 0.0022 / 0.055 lr N); the grad norm within 2e-2 of
  JAX's (tests/test_torch_moe.py's MoE bound: the port's one-device step
  lies 6.1e-3 from JAX's at step 1 too; measured 6.2e-3) and within 2e-3
  of the port's one-device step from the same state (measured 6.6e-4);
  the replicated leaves bitwise the same on both ranks.
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from tests.test_torch_ddl import init_gloo, start_jax, start_ranks, wait_all
from tests.test_torch_ddl_train import _wait_for, flat_tree, save_state, unflat_tree
from tests.test_torch_ref import jax_ref, jax_ref_scope, random_params  # noqa: F401
from tests.test_torch_tp_model import _block, _spec_dims
from tests.test_torch_tp_serve import (N_REQ, POOL_KEYS, jax_engine, port_engine,
                                       save_engine)
from tests.test_torch_tp_train import tp_state_from_npz

from repro_torch.config.base import LMSConfig, MeshSpec, ShapeConfig, TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import Model

AXES = ("pod", "data", "model")
TP = 2
MOE = ("qwen3-moe-235b-a22b", "grok-1-314b")
ENGINE_ARCH = MOE[0]
CFS = (1.25, 0.5)
DTYPES = ("float32", "bfloat16")
BATCH, SEQ = 2, 16
STEPS, TBATCH, TSEQ, LR = 3, 4, 16, 1e-3
ME = "tests.test_torch_tp_moe"


def _cases():
    return [(a, cf, dt) for a in MOE for cf in CFS for dt in DTYPES]


def _name(arch, cf, dt):
    return f"{arch}/{cf}/{dt}"


def _layer_inputs(d, seed=9):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, SEQ, d)).astype(np.float32)
    ct = rng.standard_normal((BATCH, SEQ, d)).astype(np.float32)
    return x, ct


def _batches(vocab):
    from repro_torch.data import SyntheticTokens
    data = SyntheticTokens(vocab, seed=3)
    return [data.batch(i, 0, 1, TBATCH, TSEQ) for i in range(STEPS)]


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_drops(jax, jnp, cfg, p, x):
    """The assignments JAX's routing drops at the capacity (the ranking of
    `repro.models.moe.apply_moe`, in numpy)."""
    from repro.models import moe as jmoe
    t = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax(x.reshape(t, -1).astype(jnp.float32) @ p["router"], axis=-1)
    _, top_i = jax.lax.top_k(probs, cfg.experts_per_token)
    flat_e = np.asarray(top_i).reshape(-1)
    order = np.argsort(flat_e, kind="stable")
    counts = np.bincount(flat_e, minlength=cfg.num_experts)
    offsets = np.cumsum(counts) - counts
    ranks = np.empty_like(order)
    ranks[order] = np.arange(flat_e.size) - offsets[flat_e[order]]
    return int((ranks >= jmoe._capacity(cfg, t)).sum())


def _jax_side(out_dir):
    ref = jax_ref()
    jax, jnp = ref.jax, ref.jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.config import base as jb
    from repro.launch.mesh import make_mesh
    from repro.models import moe as jmoe
    from repro.models.sharding import sharding_env
    from repro.optim.adamw import adamw_init
    from repro.train import steps as js
    out = pathlib.Path(out_dir)
    mesh = make_mesh(jb.MeshSpec((1, 1, TP), AXES))
    res = {}
    for arch in MOE:
        base = ref.get_smoke_config(arch)
        jparams = unflat_tree(dict(np.load(out / f"{arch}_params.npz")))
        _, pspecs = ref.Model(base).abstract_params(mesh)
        fspecs = pspecs["decoder"]["stack0"]["attn_0"]["ffn"]
        x, ct = _layer_inputs(base.d_model)
        for cf in CFS:
            cfg = dataclasses.replace(base, moe_capacity_factor=cf)
            for dt in DTYPES:
                dtype = getattr(jnp, dt)
                p = {k: jnp.asarray(v[0]).astype(jnp.float32 if k == "router" or
                                                 dt == "float32" else v.dtype)
                     for k, v in jparams["decoder"]["stack0"]["attn_0"]["ffn"].items()}
                p = {k: jax.device_put(v, NamedSharding(mesh, P(*tuple(fspecs[k])[1:])))
                     for k, v in p.items()}
                xx = jnp.asarray(x, dtype)

                def loss(p, x):
                    with sharding_env(mesh):
                        y, aux = jmoe.apply_moe(cfg, p, x)
                    return jnp.sum(y.astype(jnp.float32) * jnp.asarray(ct)), (y, aux)
                (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                    loss, argnums=(0, 1), has_aux=True))(p, xx)
                n = _name(arch, cf, dt)
                res[f"{n}/y"] = np.asarray(y, np.float32)
                res[f"{n}/aux"] = np.float32(aux)
                res[f"{n}/gx"] = np.asarray(gx, np.float32)
                res.update({f"{n}/g/{k}": np.asarray(v, np.float32) for k, v in gp.items()})
                res[f"{n}/drops"] = np.int64(_jax_drops(jax, jnp, cfg, p, xx))
    np.savez(out / "jax_layer.npz", **res)

    params = unflat_tree(dict(np.load(out / f"{ENGINE_ARCH}_params.npz")))
    save_engine(out / "jax_engine.npz", *jax_engine(ref, mesh, ENGINE_ARCH, params, "model"))

    cfg = ref.get_smoke_config(ENGINE_ARCH)
    init = js.TrainState(jnp.zeros((), jnp.int32), params, adamw_init(params))
    save_state(out / "init.npz", jax.tree.map(np.asarray, init))
    spec = jb.MeshSpec((1, 1, TP), AXES)
    tcfg = jb.TrainConfig(model=cfg, shape=jb.ShapeConfig("t", "train", TSEQ, TBATCH),
                          mesh=spec, lms=jb.LMSConfig(enabled=False), learning_rate=LR,
                          warmup_steps=0, total_steps=10)
    step, state_sh, batch_sh = js.build_train_step(ref.Model(cfg), tcfg, make_mesh(spec),
                                                   donate=False)
    state = jax.device_put(init, state_sh)
    steps = {}
    for i, b in enumerate(_batches(cfg.vocab_size)):
        state, met = step(state, jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                                                batch_sh))
        for k in ("loss", "ce", "grad_norm"):
            steps[f"{k}/{i}"] = np.float32(met[k])
    steps.update({f"master/{k}": v for k, v in
                  flat_tree(jax.tree.map(np.asarray, state.opt.master)).items()})
    np.savez(out / "jax_steps.npz", **steps)


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------

def _port_ranks(rank, world, out_dir):
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.train.steps import build_train_step
    out = pathlib.Path(out_dir)
    init_gloo(rank, world, out)
    spec = MeshSpec((1, 1, TP), AXES)
    mesh = make_mesh(spec)
    res = {}
    for arch in MOE:
        base = get_smoke_config(arch)
        params = params_from_jax(unflat_tree(dict(np.load(out / f"{arch}_params.npz"))),
                                 "cpu", mesh, base)
        ffn = params["decoder"]["stack0"]["attn_0"]["ffn"]
        x, ct = _layer_inputs(base.d_model)
        for cf in CFS:
            cfg = dataclasses.replace(base, moe_capacity_factor=cf)
            for dt in DTYPES:
                dtype = getattr(torch, dt)
                p = {k: v[0].to(torch.float32 if k == "router" or dt == "float32"
                                else v.dtype).clone().requires_grad_() for k, v in ffn.items()}
                xx = torch.from_numpy(x).to(dtype).requires_grad_()
                moe.reset_dropped()
                y, aux = moe.apply_moe(cfg, p, xx, mesh)
                gx, *gp = torch.autograd.grad((y.float() * torch.from_numpy(ct)).sum(),
                                              [xx] + list(p.values()))
                n = _name(arch, cf, dt)
                res[f"{n}/y"] = y.detach().float().numpy()
                res[f"{n}/aux"] = np.float32(aux.item())
                res[f"{n}/gx"] = gx.float().numpy()
                res.update({f"{n}/g/{k}": g.float().numpy() for k, g in zip(p, gp)})
                res[f"{n}/drops"] = np.int64(moe.dropped())
    np.savez(out / f"port_layer_{rank}.npz", **res)

    cfg = get_smoke_config(ENGINE_ARCH)
    _wait_for(out / "jax_engine.npz")
    j = dict(np.load(out / "jax_engine.npz"))
    forced = {int(k[4:]): v for k, v in j.items() if k.startswith("tok/")}
    params = params_from_jax(unflat_tree(dict(np.load(out / f"{ENGINE_ARCH}_params.npz"))),
                             "cpu", mesh, cfg)
    toks, rows, _, m, st = port_engine(cfg, mesh, params, "model", forced)
    save_engine(out / f"port_engine_{rank}.npz", toks, rows, m, st)

    tcfg = TrainConfig(model=cfg, shape=ShapeConfig("t", "train", TSEQ, TBATCH), mesh=spec,
                       lms=LMSConfig(enabled=False), learning_rate=LR, warmup_steps=0,
                       total_steps=10, checkpoint_dir=None)
    step = build_train_step(Model(cfg), tcfg, mesh=mesh)
    _wait_for(out / "init.npz")
    state = tp_state_from_npz(out / "init.npz", cfg, mesh)
    steps = {}
    for i, b in enumerate(_batches(cfg.vocab_size)):
        state, met = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "ce", "grad_norm"):
            steps[f"{k}/{i}"] = np.float32(met[k].item())
    steps.update({f"master/{k}": v for k, v in flat_tree(state.opt.master).items()})
    steps.update({f"params/{k}": v for k, v in flat_tree(state.params).items()})
    # the port's one-device step from the same state, beside the mesh's
    one = MeshSpec((1, 1), ("data", "model"))
    step = build_train_step(Model(cfg), dataclasses.replace(tcfg, mesh=one))
    state = tp_state_from_npz(out / "init.npz", cfg, None)
    for i, b in enumerate(_batches(cfg.vocab_size)):
        state, met = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "ce", "grad_norm"):
            steps[f"one/{k}/{i}"] = np.float32(met[k].item())
    np.savez(out / f"port_steps_{rank}.npz", **steps)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ref = jax_ref()
    out = tmp_path_factory.mktemp("tp_moe")
    for i, arch in enumerate(MOE):
        jparams, _ = random_params(ref, ref.get_smoke_config(arch), seed=40 + i)
        np.savez(out / f"{arch}_params.npz",
                 **flat_tree(ref.jax.tree.map(np.asarray, jparams)))
    procs = start_jax(ME, "_jax_side", out, devices=TP) + start_ranks(ME, "_port_ranks", out, TP)
    wait_all(procs, timeout=300)
    return out


def _ranks(out, name):
    return [dict(np.load(out / name.format(r=r))) for r in range(TP)]


def _expert_block(a, r):
    n = a.shape[0] // TP
    return a[r * n:(r + 1) * n]


@pytest.mark.parametrize("arch,cf,dtype", _cases())
def test_expert_parallel_layer_matches_jax(runs, arch, cf, dtype):
    """y, the aux loss and the grads (the input's, the router's, each
    rank's experts' block) against JAX's on the mesh; the drops equal on
    both ranks and to JAX's routing's; y, aux and the replicated grads
    bitwise the same on both ranks."""
    n = _name(arch, cf, dtype)
    j = dict(np.load(runs / "jax_layer.npz"))
    ranks = _ranks(runs, "port_layer_{r}.npz")
    f32 = dtype == "float32"
    ytol, gtol = (1e-5, 1e-5) if f32 else (2.0 ** -5, 2.0 ** -4)
    top = np.abs(j[f"{n}/y"]).max()
    for i, r in enumerate(ranks):
        assert int(r[f"{n}/drops"]) == int(j[f"{n}/drops"])
        assert np.abs(r[f"{n}/y"] - j[f"{n}/y"]).max() <= ytol * top
        assert abs(float(r[f"{n}/aux"]) - float(j[f"{n}/aux"])) <= 1e-5 * abs(float(j[f"{n}/aux"]))
        for key in [f"{n}/gx"] + [k for k in j if k.startswith(f"{n}/g/")]:
            want = j[key] if key.endswith(("gx", "router")) else _expert_block(j[key], i)
            assert r[key].shape == want.shape, key
            assert np.abs(r[key] - want).max() <= gtol * np.abs(want).max(), key
        for key in (f"{n}/y", f"{n}/aux", f"{n}/gx", f"{n}/g/router"):
            assert r[key].tobytes() == ranks[0][key].tobytes(), key
    if cf == 0.5:
        assert int(j[f"{n}/drops"]) > 0


def test_moe_engine_on_the_mesh_matches_jax_teacher_forced(runs):
    """qwen3-moe smoke's engine on 1x1x2 against the JAX engine on
    (1, 1, 2), teacher-forced: every row within 2**-5 of its largest
    |logit|; the pool's counters equal; both ranks bitwise alike."""
    j = dict(np.load(runs / "jax_engine.npz"))
    ranks = _ranks(runs, "port_engine_{r}.npz")
    for k in ranks[0]:
        if k.startswith("metric/") and (k.endswith("_s") or "tok_s" in k):
            continue
        assert np.array_equal(ranks[1][k], ranks[0][k]), k
    port = ranks[0]
    rows = [k for k in j if k.startswith("rows/")]
    assert len(rows) == N_REQ
    for key in rows:
        want, got = j[key], port[key]
        assert got.shape == want.shape
        tol = 2.0 ** -5 * np.abs(want).max(axis=1)
        assert (np.abs(got - want).max(axis=1) <= tol).all(), key
    for key in POOL_KEYS:
        assert port[f"metric/pool_{key}"] == j[f"metric/pool_{key}"], key
    assert port["metric/ok"] == N_REQ


def test_moe_train_step_on_the_mesh_matches_jax(runs):
    """3 steps of qwen3-moe smoke on 1x1x2 (the experts over `model`)
    against the JAX train step on (1, 1, 2): loss, ce and grad norm, the
    masters' blocks; the replicated leaves bitwise across the ranks."""
    j = dict(np.load(runs / "jax_steps.npz"))
    ranks = _ranks(runs, "port_steps_{r}.npz")
    for i in range(STEPS):
        for k in ("loss", "ce", "grad_norm"):
            for r in ranks:
                got = float(r[f"{k}/{i}"])
                # the MoE grad norm: tests/test_torch_moe.py's bound against JAX
                # (the port's one-device step lies 6.1e-3 from it too), and
                # test_torch_tp_train's against the port's one-device step
                want, one = float(j[f"{k}/{i}"]), float(r[f"one/{k}/{i}"])
                assert abs(got - want) <= (2e-2 if k == "grad_norm" else 2e-3) * abs(want), \
                    (k, i, got, want)
                assert abs(got - one) <= 2e-3 * abs(one), (k, i, got, one)
    dims = _spec_dims(ENGINE_ARCH, TP)
    unit = LR * STEPS
    diffs = []
    for m, r in enumerate(ranks):
        for key in j:
            if key.startswith("master/") and not key.endswith("@empty"):
                name = key[len("master/"):].replace("@bf16", "")
                diffs.append(np.abs(r[key] - _block(j[key], dims[name], m, TP)).ravel())
                if dims[name] is None:
                    assert r[key].tobytes() == ranks[0][key].tobytes(), key
    diff = np.concatenate(diffs)
    assert diff.max() <= 2 * unit + 1e-6, diff.max() / unit
    assert np.median(diff) <= 0.01 * unit, np.median(diff) / unit
    assert np.percentile(diff, 99) <= 0.1 * unit, np.percentile(diff, 99) / unit
