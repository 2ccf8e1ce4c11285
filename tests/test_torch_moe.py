"""The MoE family on the port against the JAX package on the CPU, at the
smoke configs of qwen3-moe-235b-a22b (2 layers, d_model 64, 8 experts of
d_ff 32, top-2, SwiGLU) and grok-1-314b (4 experts of d_ff 128, top-2,
GeGLU): the MoE layer and its grads, `Model.loss` with its aux loss, the
planner, training under an LMS plan, DDL and zero1 on 2 gloo ranks,
checkpoints, the serve engine (resident, under a serve plan) and
`run_static`; and the blocked cross-entropy every family's loss takes.

Tolerances.
- The layer in f32 (one call, so the comparison is of the algorithm):
  1e-5 of the largest |value| for outputs and grads (matrix products
  summed in other orders in XLA and torch). The routing, the ranks and
  the capacity drops are the same integers on both sides.
- The layer in bf16: 2**-5 of the largest |y| (4 bf16 ulps) and 2**-4 of
  the largest |grad|. The port sums a token's k expert rows in f32 and
  rounds once, where JAX adds them in bf16, so the two lie up to an ulp
  apart before the products' own roundings.
- The model in bf16: the loss and ce within 1%; the aux loss within 5%:
  it counts each token's top-1 expert, and a bf16 difference in a layer's
  input moves a near tie of two router probabilities, one token of the
  batch's 32 changing an expert's share by 1/32.
- The engine: teacher-forced with the JAX engine's tokens, each logits
  row within 2**-5 of its largest |logit| (tests/test_torch_ssm_serve.py).
  Capacity couples the tokens of one call, so both engines send the same
  calls (chunk, slots, padding rows and idle slots take capacity in token
  order in both), and grok's decode on 4 slots has capacity 2 for 8
  assignments: drops happen in both.
- DDL and zero1 against the JAX package's loss and grads on each rank's
  rows, averaged: loss within 2e-3, grad norm within 2e-2 relative
  (tests/test_torch_ddl_train.py's bounds). The port's runs against each
  other (streamed against resident, zero1 under a plan against zero1,
  a checkpoint's restore): bitwise.
- The blocked cross-entropy against the JAX formula: 1e-6 relative in
  f32; against the plain form it replaces, on the CPU: bitwise.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from tests.test_torch_ddl import init_gloo, start_ranks, wait_all
from tests.test_torch_ddl_train import save_state, state_from_npz
from tests.test_torch_ref import (jax_pricing, jax_ref,  # noqa: F401 (fixtures)
                                  jax_ref_scope, random_params)

from repro_torch import hw as thw
from repro_torch.config import base as tb
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.lms import offload as off, planner as tp
from repro_torch.launch.serve import run_static
from repro_torch.models import layers, moe
from repro_torch.models.model import Model
from repro_torch.serve import ServeEngine, synth_requests
from repro_torch.train import steps as tsteps
from repro_torch.train.trainer import Trainer
from repro_torch.tree import tree_leaves

ME = "tests.test_torch_moe"
ARCHS = ("qwen3-moe-235b-a22b", "grok-1-314b")
MESH1 = ((1, 1), ("data", "model"))
# a train plan's budget that streams the params and the AdamW state at smoke width
TRAIN_BUDGET = 300_000
# the served trace: prompts of 3 to 30 tokens, 6 greedy tokens each, on 4 slots
PROMPTS, GEN, SLOTS, MAX_LEN = (3, 9, 16, 21, 30, 12), 6, 4, 48
SERVE_BUDGET = 60_000
# DDL: 2 ranks, 2 steps of 4 x 16 tokens
WORLD, DDL_BATCH, DDL_SEQ, DDL_STEPS, LR = 2, 4, 16, 2, 1e-3
DDL_MESH = ((1, 2), ("pod", "data"))


def f32(x):
    return np.asarray(x).astype(np.float32)


def within_max(got, want, tol, what=""):
    """max |got - want| <= tol * max |want|."""
    got, want = f32(got), f32(want)
    err = np.abs(got - want).max()
    bound = tol * max(np.abs(want).max(), 1e-6)
    assert err <= bound, f"{what}: max |diff| {err} > {bound}"


def conv(obj, cls):
    """A frozen dataclass as the other package's class of the same fields."""
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})


@pytest.fixture(scope="module")
def ref():
    return jax_ref()


@pytest.fixture(scope="module")
def jm(ref):
    from repro import hw as jhw
    from repro.config import base as jbase
    from repro.configs import get_config as jget_config
    from repro.core.lms import planner as jplan
    from repro.models import moe as jmoe
    from repro.optim import adamw as jadamw
    from repro.train import steps as jsteps
    return dict(hw=jhw, base=jbase, plan=jplan, moe=jmoe, adamw=jadamw, steps=jsteps,
                get_config=jget_config)


@pytest.fixture(scope="module")
def params(ref):
    """arch -> (JAX params, the port's), from one numpy seed."""
    out = {}
    for arch in ARCHS:
        jparams, nparams = random_params(ref, ref.get_smoke_config(arch), seed=1)
        out[arch] = (jparams, params_from_jax(nparams, "cpu"))
    return out


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_moe_defs_and_converter_match_jax(ref, jm, params, arch):
    """The port's MoE params are the JAX package's: the router an f32
    [d, E] leaf, the experts [E, d, f] and [E, f, d] in bf16, stacked
    [L, ...]; `params_from_jax` carries each leaf bitwise, the router
    without a cast."""
    cfg = get_smoke_config(arch)
    got = {k: (d.shape, d.axes, d.dtype) for k, d in moe.moe_defs(cfg).items()}
    want = {k: (d.shape, d.axes, d.dtype)
            for k, d in jm["moe"].moe_defs(ref.get_smoke_config(arch)).items()}
    assert got == want
    jparams, tparams = params[arch]
    ffn = tparams["decoder"]["stack0"]["attn_0"]["ffn"]
    jffn = jparams["decoder"]["stack0"]["attn_0"]["ffn"]
    e, d, f, L = cfg.num_experts, cfg.d_model, cfg.d_ff, cfg.num_layers
    assert ffn["router"].dtype == torch.float32 and tuple(ffn["router"].shape) == (L, d, e)
    assert tuple(ffn["w_gate"].shape) == (L, e, d, f) and ffn["w_gate"].dtype == torch.bfloat16
    assert tuple(ffn["w_down"].shape) == (L, e, f, d)
    for k in ffn:
        assert np.array_equal(f32(ffn[k].float()), f32(jffn[k])), k


def test_capacity_matches_jax(ref, jm):
    for arch in ARCHS:
        for cf in (0.5, 1.25, 2.0, 4.0):
            cfg = dataclasses.replace(get_smoke_config(arch), moe_capacity_factor=cf)
            jcfg = dataclasses.replace(ref.get_smoke_config(arch), moe_capacity_factor=cf)
            for t in (1, 4, 7, 24, 64, 4096):
                assert moe._capacity(cfg, t) == jm["moe"]._capacity(jcfg, t), (arch, cf, t)


def _layer_inputs(cfg, seed, t=(2, 12)):
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": 0.3 * rng.standard_normal((d, e)),
         "w_gate": 0.125 * rng.standard_normal((e, d, f)),
         "w_up": 0.125 * rng.standard_normal((e, d, f)),
         "w_down": 0.125 * rng.standard_normal((e, f, d))}
    x = rng.standard_normal(t + (d,))
    r = rng.standard_normal(t + (d,))
    return ({k: v.astype(np.float32) for k, v in p.items()}, x.astype(np.float32),
            r.astype(np.float32))


def _jax_dropped(ref, jcfg, jp, jx):
    """Assignments the JAX layer drops: each expert's count past capacity."""
    jnp = ref.jnp
    xf = jx.reshape(-1, jx.shape[-1])
    probs = ref.jax.nn.softmax(xf.astype(jnp.float32) @ jp["router"], axis=-1)
    _, top_i = ref.jax.lax.top_k(probs, jcfg.experts_per_token)
    cap = max(int(xf.shape[0] * jcfg.experts_per_token * jcfg.moe_capacity_factor
                  / jcfg.num_experts), jcfg.experts_per_token)
    counts = np.bincount(np.asarray(top_i).ravel(), minlength=jcfg.num_experts)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [2.0, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_and_grads_match_jax(ref, jm, arch, cf, dtype):
    """`apply_moe` (y and the aux loss) and the grads of sum(y * r) + aux
    with respect to x and every param, the f32 router included, against
    jax.grad of the JAX layer; at cf 2.0 nothing drops, at 0.5 the
    capacity drops assignments, as many as JAX's ranks drop."""
    jax, jnp = ref.jax, ref.jnp
    cfg = dataclasses.replace(get_smoke_config(arch), moe_capacity_factor=cf)
    jcfg = dataclasses.replace(ref.get_smoke_config(arch), moe_capacity_factor=cf)
    p, x, r = _layer_inputs(cfg, seed=3)
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else getattr(jnp, dtype))
          for k, v in p.items()}
    jx, jr = jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(r, jnp.float32)

    def jloss(prm, xx):
        y, aux = jm["moe"].apply_moe(jcfg, prm, xx)
        return jnp.sum(y.astype(jnp.float32) * jr) + aux, (y, aux)
    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jp, jx)
    tdt = getattr(torch, dtype)
    tp_ = {k: torch.from_numpy(v).to(torch.float32 if k == "router" else tdt).requires_grad_()
           for k, v in p.items()}
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    moe.reset_dropped()
    y, aux = moe.apply_moe(cfg, tp_, tx)
    assert y.dtype == tdt and aux.dtype == torch.float32
    (torch.sum(y.float() * torch.from_numpy(r)) + aux).backward()
    dropped = _jax_dropped(ref, jcfg, jp, jx)
    assert moe.dropped() == dropped
    assert (dropped > 0) == (cf < 1.0)
    tol, gtol = (1e-5, 1e-5) if dtype == "float32" else (2.0 ** -5, 2.0 ** -4)
    within_max(y.detach().float(), jy, tol, "y")
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    within_max(tx.grad.float(), jgx, gtol, "grad x")
    for k in p:
        assert tp_[k].grad.dtype == tp_[k].dtype
        within_max(tp_[k].grad.float(), jgp[k], gtol, f"grad {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_ample_capacity_matches_dense_fallback(ref, jm, arch):
    """With capacity for every assignment (cf = E / k) the dispatched layer
    equals every expert on every token weighted by the routing
    (`apply_moe_dense_fallback`, the port's and the JAX package's) within
    1e-5 of max |y| in f32, and nothing drops."""
    cfg0 = get_smoke_config(arch)
    cf = cfg0.num_experts / cfg0.experts_per_token
    cfg = dataclasses.replace(cfg0, moe_capacity_factor=cf)
    jcfg = dataclasses.replace(ref.get_smoke_config(arch), moe_capacity_factor=cf)
    p, x, _ = _layer_inputs(cfg, seed=4)
    tp_ = {k: torch.from_numpy(v) for k, v in p.items()}
    moe.reset_dropped()
    y, _ = moe.apply_moe(cfg, tp_, torch.from_numpy(x))
    assert moe.dropped() == 0
    dense = moe.apply_moe_dense_fallback(cfg, tp_, torch.from_numpy(x))
    jdense = jm["moe"].apply_moe_dense_fallback(
        jcfg, {k: ref.jnp.asarray(v) for k, v in p.items()}, ref.jnp.asarray(x))
    within_max(y, dense, 1e-5, "dispatched vs the port's dense")
    within_max(dense, jdense, 1e-5, "the port's dense vs JAX's")


@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_matches_jax(ref, params, arch):
    """`Model.loss` -> (ce + 0.01 aux, {"ce", "aux"}) against the JAX
    package's on the same params and tokens, with ignored labels; the aux
    loss is > 0 (E * sum(me * ce) >= 1 for any routing)."""
    jparams, tparams = params[arch]
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[0, :3] = -1
    jl, jmet = ref.Model(ref.get_smoke_config(arch)).loss(
        jparams, {"tokens": ref.jnp.asarray(toks), "labels": ref.jnp.asarray(labels)})
    loss, met = Model(cfg).loss(tparams, {"tokens": torch.from_numpy(toks),
                                          "labels": torch.from_numpy(labels)})
    assert set(met) == {"ce", "aux"}
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-2)
    np.testing.assert_allclose(met["ce"].item(), float(jmet["ce"]), rtol=1e-2)
    np.testing.assert_allclose(met["aux"].item(), float(jmet["aux"]), rtol=5e-2)
    assert met["aux"].item() >= 1.0 - 1e-6
    np.testing.assert_allclose(loss.item(), met["ce"].item() + 0.01 * met["aux"].item(),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# plans and training under a plan
# ---------------------------------------------------------------------------

def _train_req(lib, cfg, seq, batch, budget, hw):
    return dict(cfg=cfg, shape=lib.ShapeConfig("t", "train", seq, batch),
                mesh=lib.MeshSpec(*MESH1), lms=lib.LMSConfig(hbm_budget=budget), hw=hw)


def _serve_req(lib, cfg, seq, slots, budget, hw):
    return dict(cfg=cfg, shape=lib.ShapeConfig("serve", "decode", seq, slots),
                mesh=lib.MeshSpec(*MESH1), lms=lib.LMSConfig(hbm_budget=budget), hw=hw,
                serve=True, slots=slots, backlog_slots=2 * slots, page_size=16)


PLAN_CASES = {
    # name -> (arch, full width?, serve?, seq, batch or slots, budget)
    "qwen3-smoke-train": (ARCHS[0], False, False, 32, 2, TRAIN_BUDGET),
    "grok-smoke-train": (ARCHS[1], False, False, 32, 2, TRAIN_BUDGET),
    "qwen3-smoke-serve": (ARCHS[0], False, True, MAX_LEN, SLOTS, SERVE_BUDGET),
    "grok-smoke-serve": (ARCHS[1], False, True, MAX_LEN, SLOTS, SERVE_BUDGET),
    "qwen3-full-train": (ARCHS[0], True, False, 2048, 2, 16e9),
    "qwen3-full-serve": (ARCHS[0], True, True, 160, 4, 16e9),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_matches_jax(jax_pricing, ref, jm, case):
    """The port's plan equals the JAX package's field by field (the
    `moe_hidden` and `router_probs` classes among its activations) for
    both smoke configs, and for qwen3-moe-235b-a22b at its published
    width (94 layers: 2 x 2048 tokens of training, 4 slots of serving)."""
    arch, full, serve, seq, n, budget = PLAN_CASES[case]
    jb = jm["base"]
    jhw = conv(thw.H100_SXM, jm["hw"].HardwareSpec)
    jcfg = jm["get_config"](arch) if full else ref.get_smoke_config(arch)
    cfg = get_config(arch) if full else get_smoke_config(arch)
    make = _serve_req if serve else _train_req
    jp = jm["plan"].plan(jm["plan"].PlanRequest(**make(jb, jcfg, seq, n, budget, jhw)))
    got = tp.plan(tp.PlanRequest(**make(tb, cfg, seq, n, budget, thw.H100_SXM)))
    assert dataclasses.asdict(got) == dataclasses.asdict(jp)
    if not serve:
        assert {"moe_hidden", "router_probs"} <= set(got.assignment)
    if full:
        assert got.residency["params"] == "host"


@pytest.mark.parametrize("arch", ARCHS)
def test_streamed_steps_equal_resident_bitwise(jax_pricing, ref, jm, arch):
    """3 train steps under the smoke plan of TRAIN_BUDGET (the plan the
    JAX package makes: the stack's params, the f32 router among them, and
    the AdamW state streamed from pinned host memory, the residual stream
    offloaded, the rest recomputed) equal the resident steps bitwise:
    every metric, aux > 0 among them, and every leaf of the state; the
    params' swap bytes are at least the stack twice a step."""
    from repro_torch.data import SyntheticTokens
    cfg = get_smoke_config(arch)
    tcfg = tb.TrainConfig(model=cfg, shape=tb.ShapeConfig("t", "train", 32, 2),
                          mesh=tb.MeshSpec(*MESH1), lms=tb.LMSConfig(hbm_budget=TRAIN_BUDGET),
                          warmup_steps=1, learning_rate=1e-2, total_steps=10,
                          checkpoint_dir=None)
    plan = tp.plan(tp.PlanRequest(cfg=cfg, shape=tcfg.shape, mesh=tcfg.mesh, lms=tcfg.lms,
                                  hw=thw.H100_SXM))
    assert plan.residency["params"] == "host" and plan.residency["optimizer"] == "host"
    data = SyntheticTokens(cfg.vocab_size, seed=3)
    batches = [{k: torch.from_numpy(v) for k, v in data.batch(i, 0, 1, 2, 32).items()}
               for i in range(3)]

    def run(p):
        model = Model(cfg)
        state = tsteps.init_train_state(model, tcfg, 5, "cpu", plan=p)
        step = tsteps.build_train_step(model, tcfg, spec=tsteps.StepSpec(plan=p))
        before = off.swap_counters()
        mets = []
        for b in batches:
            state, m = step(state, b)
            mets.append({k: v.item() for k, v in m.items()})
        moved = off.swap_counters().get("lms.swap_in_bytes.params", 0) - before.get(
            "lms.swap_in_bytes.params", 0)
        o = state.opt
        leaves = [state.step, o.step] + [t for tree in (state.params, o.mu, o.nu, o.master)
                                         for t in tree_leaves(tree)]
        return mets, leaves, moved, state
    base, base_leaves, base_moved, _ = run(None)
    mets, leaves, moved, state = run(plan)
    assert mets == base
    assert all(np.isfinite(m["aux"]) and m["aux"] > 0 for m in mets)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(base_leaves, leaves))
    assert base_moved == 0
    assert moved >= 2 * 3 * off.tree_bytes(state.params["decoder"]["stack0"])
    off.release_arenas()


@pytest.mark.parametrize("lms", [tb.LMSConfig(enabled=False), tb.LMSConfig(hbm_budget=600_000)],
                         ids=["resident", "planned"])
@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_round_trip(tmp_path, arch, lms):
    """A Trainer's state after 2 steps, saved, comes back from
    `restore_train_state` bitwise (the f32 router and the [L, E, d, f]
    experts among its leaves), resident or placed as the plan says (the
    stack's params and the AdamW state in the pinned arena); a Trainer
    resumed from it runs step 3 as the uninterrupted one does."""
    def tcfg(ckpt):
        return tb.TrainConfig(model=get_smoke_config(arch),
                              shape=tb.ShapeConfig("t", "train", 16, 2),
                              mesh=tb.MeshSpec(*MESH1), lms=lms,
                              ddl=tb.DDLConfig(mode="none"), learning_rate=5e-3,
                              warmup_steps=1, total_steps=6, checkpoint_dir=ckpt,
                              checkpoint_every=2)

    def leaves(state):
        return tree_leaves({"params": state.params, "opt": dict(state.opt._asdict())})
    trainer = Trainer(tcfg(str(tmp_path / "ck")), device="cpu")
    state, _ = trainer.train(steps=2)
    want = [t.clone() for t in leaves(state)]
    with trainer.ckpt.open() as reader:
        got = tsteps.restore_train_state(reader, trainer.model, trainer.tcfg, "cpu",
                                         plan=trainer.plan)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(leaves(got), want))
    del got, state
    _, whole = Trainer(tcfg(None), device="cpu").train(steps=3)
    _, resumed = Trainer(tcfg(str(tmp_path / "ck")), device="cpu").train(steps=3)
    assert resumed[-1]["step"] == 3
    assert {k: resumed[-1][k] for k in ("loss", "ce", "aux", "grad_norm")} == \
        {k: whole[-1][k] for k in ("loss", "ce", "aux", "grad_norm")}
    off.release_arenas()


# ---------------------------------------------------------------------------
# DDL and zero1 on 2 gloo ranks
# ---------------------------------------------------------------------------

def _ddl_batches(vocab):
    from repro_torch.data import SyntheticTokens
    data = SyntheticTokens(vocab, seed=3)
    return [data.batch(i, 0, 1, DDL_BATCH, DDL_SEQ) for i in range(DDL_STEPS)]


def _ddl_tcfg(arch, mode, lms=None):
    return tb.TrainConfig(model=get_smoke_config(arch),
                          shape=tb.ShapeConfig("t", "train", DDL_SEQ, DDL_BATCH),
                          mesh=tb.MeshSpec(*DDL_MESH), lms=lms or tb.LMSConfig(enabled=False),
                          ddl=tb.DDLConfig(mode=mode), learning_rate=LR, warmup_steps=0,
                          total_steps=10, checkpoint_dir=None)


def _ddl_rank(rank, world, out_dir):
    """Per arch, on this rank of the 1x2 mesh, 2 steps from the JAX
    package's initial state (written by the test): DDL's allreduce, zero1,
    and zero1 under a plan that puts the params and the flat optimizer
    shard on the host. -> ddl_<rank>.json: each run's metrics and the
    params' checksums (an f64 sum of each leaf)."""
    from repro_torch.data import local_rows
    from repro_torch.launch.mesh import make_mesh
    out = pathlib.Path(out_dir)
    init_gloo(rank, world, out)
    mesh = make_mesh(tb.MeshSpec(*DDL_MESH))
    res = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        model = Model(cfg)
        batches = [{k: torch.from_numpy(v) for k, v in
                    local_rows(b, mesh.dp_index, mesh.dp_size).items()}
                   for b in _ddl_batches(cfg.vocab_size)]

        def record(step, state):
            mets = []
            for b in batches:
                state, met = step(state, b)
                mets.append({k: float(met[k].item()) for k in ("loss", "ce", "aux",
                                                                "grad_norm")})
            sums = [float(t.double().sum()) for t in tree_leaves(state.params)]
            return {"metrics": mets, "checksums": sums}, state
        tcfg = _ddl_tcfg(arch, "allreduce")
        step = tsteps.build_train_step(model, tcfg, mesh=mesh)
        res[f"{arch}/allreduce"], _ = record(step, state_from_npz(out / f"init_{arch}.npz"))
        runs = {}
        for name, lms in (("zero1", None), ("zero1_planned", tb.LMSConfig(hbm_budget=1))):
            tcfg = _ddl_tcfg(arch, "zero1", lms)
            plan = None
            if lms is not None:
                res_ = {"params": "host", "grads": "device", "optimizer": "host",
                        "kvcache": "device"}
                plan = tp.MemoryPlan({"resid": "offload", "moe_hidden": "remat"}, res_,
                                     1, 1, 1, 1, True,
                                     swap_schedule=tp.make_swap_schedule(
                                         res_, cfg.num_layers, "train", prefetch_depth=2))
            state = tsteps.init_zero1_state(model, tcfg, 5, "cpu", world, plan=plan,
                                            data_index=mesh.index("data"))
            step = tsteps.build_zero1_train_step(model, tcfg, plan=plan, mesh=mesh)
            runs[name] = record(step, state)
        a, b = runs["zero1"][1], runs["zero1_planned"][1]
        bitwise = all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(
            [a.step, a.mu, a.nu, a.master] + tree_leaves(a.params),
            [b.step, b.mu, b.nu, b.master] + tree_leaves(b.params)))
        res[f"{arch}/zero1"] = runs["zero1"][0]
        res[f"{arch}/zero1_planned"] = dict(runs["zero1_planned"][0], bitwise=bitwise)
        off.release_arenas()
    (out / f"ddl_{rank}.json").write_text(json.dumps(res))


@pytest.fixture(scope="module")
def ddl_runs(ref, jm, tmp_path_factory):
    """The JAX package's initial states written, then the port's 2 ranks;
    -> (out dir, {arch: {mode: the JAX reference of step 1 from that
    mode's initial params: the mean of each rank's loss and the norm of
    the mean of their grads}}): allreduce starts from the JAX package's
    random params, zero1 from the port's init of seed 5 (its state's
    params), each carried to the other package bitwise."""
    jax, jnp = ref.jax, ref.jnp
    from repro_torch.data import local_rows
    out = tmp_path_factory.mktemp("moe_ddl")
    want = {}

    def step1(jcfg, jparams):
        model = ref.Model(jcfg)
        b = _ddl_batches(jcfg.vocab_size)[0]
        losses, grads = [], []
        for r in range(WORLD):
            rows = {k: jnp.asarray(v) for k, v in local_rows(b, r, WORLD).items()}
            (loss, _), g = jax.value_and_grad(lambda p: model.loss(p, rows), has_aux=True)(
                jparams)
            losses.append(float(loss))
            grads.append([np.asarray(x, np.float32) for x in jax.tree.leaves(g)])
        mean = [sum(gs) / WORLD for gs in zip(*grads)]
        return {"loss": float(np.mean(losses)),
                "grad_norm": float(np.sqrt(sum(float((m.astype(np.float64) ** 2).sum())
                                               for m in mean)))}
    for arch in ARCHS:
        jcfg = ref.get_smoke_config(arch)
        jparams, _ = random_params(ref, jcfg, seed=6)
        jstate = jm["steps"].TrainState(jnp.zeros((), jnp.int32), jparams,
                                        jm["adamw"].adamw_init(jparams))
        save_state(out / f"init_{arch}.npz", jax.tree.map(np.asarray, jstate))
        init = Model(get_smoke_config(arch)).init(5, "cpu")
        jinit = ref.jax.tree.map(
            lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16
                                  else jnp.float32), init, is_leaf=torch.is_tensor)
        want[arch] = {"allreduce": step1(jcfg, jparams), "zero1": step1(jcfg, jinit)}
    wait_all(start_ranks(ME, "_ddl_rank", out, WORLD), timeout=300)
    return out, want


def _rank_rows(out):
    return [json.loads((out / f"ddl_{r}.json").read_text()) for r in range(WORLD)]


@pytest.mark.parametrize("mode", ["allreduce", "zero1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ddl_and_zero1_on_2_ranks_match_jax(ddl_runs, arch, mode):
    """DDL's allreduce and zero1 on 2 gloo ranks (the expert leaves and
    the f32 router in DDL's buckets and in zero1's flat shard): step 1's
    loss is the mean of the JAX package's loss on each rank's rows from
    the same initial params, and its grad norm that of the mean of their
    grads; every metric finite,
    aux > 0, and the params the same on both ranks after 2 steps."""
    out, want = ddl_runs
    rows = [r[f"{arch}/{mode}"] for r in _rank_rows(out)]
    first = rows[0]["metrics"][0]
    np.testing.assert_allclose(first["loss"], want[arch][mode]["loss"], rtol=2e-3)
    np.testing.assert_allclose(first["grad_norm"], want[arch][mode]["grad_norm"], rtol=2e-2)
    assert all(np.isfinite(list(m.values())).all() and m["aux"] > 0
               for r in rows for m in r["metrics"])
    assert rows[0]["checksums"] == rows[1]["checksums"]
    assert rows[0]["metrics"] == rows[1]["metrics"]


@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_under_a_plan_equals_zero1_bitwise(ddl_runs, arch):
    """zero1 with the params (stack and rest) and the flat optimizer shard
    in pinned host memory equals zero1 resident bitwise on each rank:
    every metric, every param and the shard's mu, nu and master."""
    out, _ = ddl_runs
    for r in _rank_rows(out):
        planned, resident = r[f"{arch}/zero1_planned"], r[f"{arch}/zero1"]
        assert planned["bitwise"] is True
        assert planned["metrics"] == resident["metrics"]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _requests(cfg, synth):
    rng = np.random.default_rng(1)
    reqs = []
    for i, plen in enumerate(PROMPTS):
        req = synth(cfg, 1, plen, GEN, rng)[0]
        req.rid = i
        reqs.append(req)
    return reqs


def _serve_plans(ref, jm, arch):
    """(JAX serve plan, the port's), equal field by field."""
    jhw = conv(thw.H100_SXM, jm["hw"].HardwareSpec)
    jp = jm["plan"].plan(jm["plan"].PlanRequest(**_serve_req(
        jm["base"], ref.get_smoke_config(arch), MAX_LEN, SLOTS, SERVE_BUDGET, jhw)))
    tpl = tp.plan(tp.PlanRequest(**_serve_req(tb, get_smoke_config(arch), MAX_LEN, SLOTS,
                                              SERVE_BUDGET, thw.H100_SXM)))
    assert dataclasses.asdict(tpl) == dataclasses.asdict(jp)
    assert tpl.residency["params"] == "host"
    return jp, tpl


def _run_jax(ref, arch, jparams, plan=None):
    jcfg = ref.get_smoke_config(arch)
    eng = ref.ServeEngine(ref.Model(jcfg), ref.mesh(), slots=SLOTS, max_len=MAX_LEN, plan=plan,
                          params=jparams)
    rows = {}
    select = eng._select

    def record(req, row):
        rows.setdefault(req.rid, []).append(np.array(row, np.float32))
        return select(req, row)
    eng._select = record
    toks = eng.run(_requests(jcfg, ref.synth_requests))
    return toks, rows, eng.metrics()


def _run_port(arch, params, plan=None, forced=None, **geometry):
    """geometry: the page geometry, where not the plan's or the default.
    -> (tokens, rows, metrics, params swap bytes, dropped assignments)."""
    cfg = get_smoke_config(arch)
    eng = ServeEngine(Model(cfg), slots=SLOTS, max_len=MAX_LEN, plan=plan, params=params,
                      device="cpu", **geometry)
    rows = {}
    select = eng._select

    def record(req, row):
        rows.setdefault(req.rid, []).append(row.copy())
        if forced is not None:
            return int(forced[req.rid][len(req.tokens)])
        return select(req, row)
    eng._select = record
    before = off.swap_counters()
    moe.reset_dropped()
    reqs = _requests(cfg, synth_requests)
    toks = eng.run(reqs)
    moved = off.swap_counters().get("lms.swap_in_bytes.params", 0) - before.get(
        "lms.swap_in_bytes.params", 0)
    assert all(r.status == "ok" for r in reqs)
    return toks, rows, eng.metrics(), moved, moe.dropped()


@pytest.mark.parametrize("planned", [False, True], ids=["resident", "plan"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(jax_pricing, ref, jm, params, arch, planned):
    """The port's engine on the trace (6 requests on 4 slots, chunked
    prefill, slot decode), teacher-forced with the JAX engine's tokens in
    the same case: every logits row within 2**-5 of its largest |logit|,
    the engine's counts equal; capacity drops assignments (grok's decode
    on 4 slots has capacity 2 for 8). Under the serve plan (params on the
    host, streamed a layer at a time) the port's free-running run equals
    its resident run with the plan's page geometry bitwise, tokens, rows
    and drops (which requests share a decode tick, and so what the
    capacity drops, follows the pages the pool has), and the params' swap
    bytes are one sweep of the stack a prefill and a tick at least."""
    jparams, tparams = params[arch]
    jp, tpl = _serve_plans(ref, jm, arch) if planned else (None, None)
    jtoks, jrows, jmet = _run_jax(ref, arch, jparams, jp)
    placed = tsteps.place_params(tparams, tpl, "cpu") if planned else tparams
    toks, rows, met, _, dropped = _run_port(arch, placed, tpl, forced=jtoks)
    assert {k: v.tolist() for k, v in toks.items()} == {k: v.tolist() for k, v in jtoks.items()}
    for rid, want in jrows.items():
        assert len(rows[rid]) == len(want) == GEN
        for got, w in zip(rows[rid], want):
            within_max(got, w, 2.0 ** -5, f"request {rid}")
    for key in ("ticks", "decode_tokens"):
        assert met[key] == jmet[key], key
    assert dropped > 0
    if not planned:
        return
    own, own_rows, own_met, moved, own_dropped = _run_port(
        arch, tsteps.place_params(tparams, tpl, "cpu"), tpl)
    kv = tpl.kv_paging
    geometry = ({} if kv is None else dict(page_size=kv.page_size, device_pages=kv.device_pages,
                                           host_pages=kv.host_pages))
    res, res_rows, _, res_moved, res_dropped = _run_port(arch, tparams, **geometry)
    assert {k: v.tolist() for k, v in own.items()} == {k: v.tolist() for k, v in res.items()}
    assert all(np.array_equal(a, b) for rid in res_rows
               for a, b in zip(own_rows[rid], res_rows[rid]))
    assert own_dropped == res_dropped > 0 and res_moved == 0
    stack = off.tree_bytes(tparams["decoder"]["stack0"])
    assert moved >= stack * (len(PROMPTS) + int(own_met["ticks"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_run_static_under_a_serve_plan_is_bitwise_resident(jax_pricing, ref, jm, params, arch):
    """`run_static` on 4 prompts of 21 tokens: under the serve plan (params
    streamed, the cache emitted to the host and streamed back a layer at a
    time) bitwise the resident loop's tokens, with the same drops; its
    first token, from the whole-batch prefill, is the JAX run_static's
    where the JAX logits' top-2 margin is wide."""
    _, tparams = params[arch]
    _, tpl = _serve_plans(ref, jm, arch)
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    reqs = synth_requests(cfg, 4, 21, GEN, np.random.default_rng(2))
    moe.reset_dropped()
    _, want, _ = run_static(model, reqs, 21, GEN, params=tparams, device="cpu")
    want_dropped = moe.dropped()
    moe.reset_dropped()
    _, got, _ = run_static(model, reqs, 21, GEN, params=tsteps.place_params(tparams, tpl, "cpu"),
                           device="cpu", plan=tpl)
    assert np.array_equal(got, want) and moe.dropped() == want_dropped
    jparams = params[arch][0]
    jcfg = ref.get_smoke_config(arch)
    _, jtoks, _ = ref.launch_serve.run_static(
        ref.Model(jcfg), ref.mesh(), ref.synth_requests(jcfg, 4, 21, GEN,
                                                        np.random.default_rng(2)),
        21, GEN, params=jparams)
    assert np.array_equal(np.asarray(jtoks)[:, 0], want[:, 0])


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_take_the_moe_archs(capsys, tmp_path, arch):
    """`launch.serve --arch` (the engine and --static) and `launch.train
    --arch` run the MoE smoke configs on the CPU."""
    from repro_torch.launch import serve as lserve, train as ltrain
    base = ["--arch", arch, "--smoke", "--device", "cpu"]
    assert lserve.main(base + ["--requests", "4", "--slots", "2", "--prompt-len", "8",
                               "--gen", "4", "--page-size", "4", "--prefill-chunk", "4"]) == 0
    assert "served 4 requests" in capsys.readouterr().out
    assert lserve.main(base + ["--requests", "2", "--prompt-len", "8", "--gen", "4",
                               "--static"]) == 0
    assert "decode:" in capsys.readouterr().out
    assert ltrain.main(base + ["--steps", "2", "--batch", "2", "--seq", "16",
                               "--ckpt-dir", str(tmp_path / "ck")]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split("|")[1].split()[1]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    off.release_arenas()


# ---------------------------------------------------------------------------
# the blocked cross-entropy and its price
# ---------------------------------------------------------------------------

def _plain_cross_entropy(logits, labels, ignore_id=-1):
    """The form the blocked one replaced: the whole [.., V] logits in f32
    through autograd."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    mask = (labels != ignore_id).float()
    return ((lse - ll) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


@pytest.mark.parametrize("block", [5, 16, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_cross_entropy_matches_jax_and_the_plain_form(ref, monkeypatch, dtype, block):
    """`layers.cross_entropy` on logits [2, 19, 300] with ignored labels,
    a block of 5 (which does not divide 38 rows), 16, or more than every
    row: value and grad bitwise the plain form's on the CPU (each row's
    ops are the plain form's), and within 1e-6 relative (grads: 1e-6 of
    the largest) of the JAX formula's in f32, of its bf16 grad within
    one bf16 ulp of the largest."""
    jax, jnp = ref.jax, ref.jnp
    from repro.models.layers import cross_entropy as jce
    rng = np.random.default_rng(block)
    logits = (3 * rng.standard_normal((2, 19, 300))).astype(np.float32)
    labels = rng.integers(0, 300, (2, 19)).astype(np.int32)
    labels[0, :4] = -1
    labels[1, 7] = -1
    tdt = getattr(torch, dtype)
    a = torch.from_numpy(logits.copy()).to(tdt).requires_grad_()
    b = torch.from_numpy(logits.copy()).to(tdt).requires_grad_()
    tl = torch.from_numpy(labels)
    monkeypatch.setattr(layers, "LOSS_BLOCK", block)
    got = layers.cross_entropy(a, tl)
    got.backward()
    want = _plain_cross_entropy(b, tl)
    want.backward()
    assert got.dtype == torch.float32 and a.grad.dtype == tdt
    assert torch.equal(got, want) and torch.equal(a.grad, b.grad)
    jv, jg = jax.value_and_grad(lambda x: jce(x, jnp.asarray(labels)))(
        jnp.asarray(logits, getattr(jnp, dtype)))
    np.testing.assert_allclose(got.item(), float(jv), rtol=1e-6)
    if dtype == "float32":
        within_max(a.grad, jg, 1e-6, "grad")
    else:
        assert np.abs(f32(a.grad.float()) - f32(jg)).max() <= 2.0 ** (
            np.floor(np.log2(np.abs(f32(jg)).max())) - 7)
    assert torch.all(a.grad[0, :4] == 0) and torch.all(a.grad[1, 7] == 0)


def test_loss_work_bytes_is_priced_in_every_training_plan(monkeypatch):
    """`loss_work_bytes` counts the bf16 logits, their bf16 grad and
    LOSS_BLOCK_TERMS f32 [block, V] terms; a train plan takes the larger of
    it and the layers' transient: qwen3-moe-235b-a22b at 1 layer and 2 x
    2048 tokens under 16e9 peaks higher by it less 4 x the largest class,
    with the same placement as without it. Serve plans do not price it."""
    cfg = dataclasses.replace(get_config(ARCHS[0]), num_layers=1)
    shape, mesh = tb.ShapeConfig("t", "train", 2048, 2), tb.MeshSpec(*MESH1)
    work = tp.loss_work_bytes(cfg, shape, mesh)
    v = cfg.vocab_size
    assert work == 2 * 2 * 4096 * v + tp.LOSS_BLOCK_TERMS * layers.LOSS_BLOCK * v * 4
    req = tp.PlanRequest(cfg=cfg, shape=shape, mesh=mesh, lms=tb.LMSConfig(hbm_budget=16e9),
                         hw=thw.H100_SXM)
    got = tp.plan(req)
    with monkeypatch.context() as m:
        m.setattr(tp, "loss_work_bytes", lambda *a, **k: 0)
        base = tp.plan(req)
    largest = max(a.bytes_dev for a in tp.activation_classes(cfg, shape, mesh))
    assert (got.assignment, got.residency) == (base.assignment, base.residency)
    assert got.peak_bytes - base.peak_bytes == work - 4 * largest > 0
    sreq = tp.PlanRequest(**_serve_req(tb, cfg, 160, 4, 16e9, thw.H100_SXM))
    with monkeypatch.context() as m:
        m.setattr(tp, "loss_work_bytes", lambda *a, **k: 10**12)
        assert tp.plan(sreq).peak_bytes == tp.plan(
            tp.PlanRequest(**_serve_req(tb, cfg, 160, 4, 16e9, thw.H100_SXM))).peak_bytes


def test_model_loss_takes_the_blocked_cross_entropy(monkeypatch):
    """`Model.loss` of a MoE and of a dense smoke config gives the same
    loss and grads with a block of 3 rows (which do not divide the 20) as
    with the default block."""
    for arch in (ARCHS[0], "qwen2.5-14b"):
        cfg = get_smoke_config(arch)
        model = Model(cfg)
        params = model.init(0, "cpu")
        rng = np.random.default_rng(5)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32))
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}

        def run():
            leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
            from repro_torch.tree import tree_unflatten
            loss, _ = model.loss(tree_unflatten(params, leaves), batch)
            return loss, torch.autograd.grad(loss, leaves)
        want, wg = run()
        monkeypatch.setattr(layers, "LOSS_BLOCK", 3)
        got, gg = run()
        monkeypatch.undo()
        assert torch.equal(got, want) and all(torch.equal(a, b) for a, b in zip(gg, wg))
