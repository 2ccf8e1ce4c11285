"""The port's LMS (`repro_torch.core.lms`, the layer-streaming executor in
`models/transformer.py`, the streamed optimizer sweep and the state
placement in `train/steps.py`) against the JAX package, on the CPU at
smoke size.

Tolerances. The planner and the cost model are the same arithmetic on
both sides: plans equal field by field, notes included. The executor's
loss and grads and 3 train steps against the JAX package's streamed step
take `tests/test_torch_train.py`'s bounds for the bf16 model (loss within
1e-2 relative and grads within 2**-4 of each leaf's largest |value|;
per step loss and grad norm within 2e-3 relative; master weights within
2 lr N, median 0.01 lr N, 99th percentile 0.1 lr N). The port's streamed
steps against its own resident steps: bitwise (the same ops on the same
values; the optimizer's math is elementwise, so slicing it by layer or
chunk changes nothing). The executor's tests run on the smoke config of
each dense decoder ported (qwen2.5-14b, olmo-1b: norm subtrees with no
leaves and a tied embedding, starcoder2-7b, qwen2-72b). Inputs are made
from a seed with numpy.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from tests.test_torch_ref import (jax_pricing, jax_ref,  # noqa: F401 (fixtures)
                                  jax_ref_scope, random_params)
from tests.test_torch_train import _check_masters, _jleaves, within_max

from repro_torch import hw as thw
from repro_torch.config import base as tb
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.core.lms import costmodel as tcost, offload as off, planner as tp
from repro_torch.core.lms import policies
from repro_torch.data import SyntheticTokens
from repro_torch.launch import train as launch
from repro_torch.models.model import Model
from repro_torch.obs import get_obs
from repro_torch.optim import adamw
from repro_torch.train import steps as tsteps
from repro_torch.train.trainer import Trainer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

ARCH = "qwen2.5-14b"
DENSE_ARCHS = ("qwen2.5-14b", "olmo-1b", "starcoder2-7b", "qwen2-72b")
FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "obs_report.json"
MESH1 = ((1, 1), ("data", "model"))
# at 2 x 16 tokens of the smoke config this budget streams the params and
# the optimizer state, offloads the residual stream and recomputes the rest
SMOKE_BUDGET = 600_000
OFFLOAD_ALL_BUT_MLP = {"resid": "offload", "attn_norm": "offload", "qkv": "offload",
                       "attn_out": "offload", "mlp_norm": "offload",
                       "mlp_hidden": "remat"}


@pytest.fixture(scope="module")
def ref():
    return jax_ref()


@pytest.fixture(scope="module")
def jm(ref):
    from repro import hw as jhw
    from repro.config import base as jbase
    from repro.configs import ARCH_IDS, get_config, get_smoke_config as jsmoke
    from repro.core.lms import costmodel as jcost, planner as jplan
    from repro.optim import adamw as jadamw
    from repro.train import steps as jsteps, trainer as jtrainer
    return dict(hw=jhw, base=jbase, arch_ids=ARCH_IDS, get_config=get_config,
                get_smoke_config=jsmoke, cost=jcost, plan=jplan, adamw=jadamw,
                steps=jsteps, trainer=jtrainer)


def conv(obj, cls):
    """A frozen dataclass as the other package's class of the same fields."""
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})


def _asdict(plan):
    return dataclasses.asdict(plan)


# ---------------------------------------------------------------------------
# the planner and the cost model
# ---------------------------------------------------------------------------

def test_config_fields_match(jm):
    """The dataclasses the planner reads have the JAX package's fields."""
    jb = jm["base"]
    for j, t in ((jb.ModelConfig, tb.ModelConfig), (jb.ShapeConfig, tb.ShapeConfig),
                 (jb.MeshSpec, tb.MeshSpec), (jb.LMSConfig, tb.LMSConfig),
                 (jm["hw"].HardwareSpec, thw.HardwareSpec)):
        assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(t)]


def _hardware(jm):
    """(JAX spec, port spec) pairs: the JAX package's TPU v5e and the
    port's H100, each built on both sides from the same field values."""
    jhw = jm["hw"]
    return [(jhw.TPU_V5E, conv(jhw.TPU_V5E, thw.HardwareSpec)),
            (conv(thw.H100_SXM, jhw.HardwareSpec), thw.H100_SXM)]


MESHES = (((1, 1), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 8, 4), ("pod", "data", "model")), ((8,), ("data",)))
LMS_KNOBS = ({}, {"hbm_budget": 16_000_000_000}, {"hbm_budget": 2_000_000_000},
             {"hbm_budget": 16_000_000_000, "offload_params": "never"},
             {"hbm_budget": 16_000_000_000, "offload_optimizer": "never"},
             {"hbm_budget": 4_000_000_000, "offload_activations": "never"},
             {"hbm_budget": 4_000_000_000, "remat": False},
             {"enabled": False})


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "olmo-1b", "starcoder2-7b", "qwen2-72b",
                                  "mamba2-1.3b", "grok-1-314b", "qwen3-moe-235b-a22b",
                                  "recurrentgemma-9b", "qwen2-vl-2b", "whisper-tiny"])
def test_plan_matches_jax(jax_pricing, jm, arch):
    """plan() on both sides, every JAX config at full size and smoke size
    (converted field by field into the port's ModelConfig), on both
    hardware models, at every JAX shape and a 2 x 2048 train shape, on
    four meshes, under eight LMS settings, with and without zero1 and
    with 1 and 4 microbatches: MemoryPlan (SwapSchedule inside) equal
    field by field, notes included."""
    jb, jp = jm["base"], jm["plan"]
    assert arch in jm["arch_ids"]
    shapes = list(jb.SHAPES.values()) + [jb.ShapeConfig("t", "train", 2048, 2)]
    n = 0
    for jcfg in (jm["get_config"](arch), jm["get_smoke_config"](arch)):
        tcfg = conv(jcfg, tb.ModelConfig)
        for jhw, thw_ in _hardware(jm):
            for shape in shapes:
                for mesh in MESHES:
                    for knobs in LMS_KNOBS:
                        for zero1, mb in ((False, 1), (True, 1), (False, 4)):
                            jl = jb.LMSConfig(**knobs)
                            want = jp.plan(jp.PlanRequest(
                                cfg=jcfg, shape=shape, mesh=jb.MeshSpec(*mesh), lms=jl,
                                hw=jhw, zero1=zero1, microbatches=mb))
                            got = tp.plan(tp.PlanRequest(
                                cfg=tcfg, shape=conv(shape, tb.ShapeConfig),
                                mesh=tb.MeshSpec(*mesh), lms=conv(jl, tb.LMSConfig),
                                hw=thw_, zero1=zero1, microbatches=mb))
                            assert _asdict(got) == _asdict(want), (arch, shape, mesh, knobs)
                            n += 1
    assert n == 2 * 2 * len(shapes) * len(MESHES) * len(LMS_KNOBS) * 3


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_serve_plan_matches_jax(jax_pricing, jm, kv_dtype):
    """The serve plans (paged pool sizing included) and the legacy
    wrappers, on both hardware models."""
    jb, jp = jm["base"], jm["plan"]
    for arch in ("qwen2.5-14b", "mamba2-1.3b", "recurrentgemma-9b", "qwen3-moe-235b-a22b"):
        jcfg = jm["get_config"](arch)
        tcfg = conv(jcfg, tb.ModelConfig)
        for jhw, thw_ in _hardware(jm):
            for slots, backlog, page, budget in ((8, None, 64, 0), (32, 64, 16, 8_000_000_000),
                                                 (4, 2, 128, 40_000_000_000)):
                shape = jb.ShapeConfig("d", "decode", 4096, 32)
                kw = dict(slots=slots, backlog_slots=backlog, page_size=page, kv_dtype=kv_dtype)
                want = jp.plan_serve_memory(jcfg, shape, jb.MeshSpec(*MESH1),
                                            jb.LMSConfig(hbm_budget=budget), jhw, **kw)
                got = tp.plan_serve_memory(tcfg, conv(shape, tb.ShapeConfig),
                                           tb.MeshSpec(*MESH1), tb.LMSConfig(hbm_budget=budget),
                                           thw_, **kw)
                assert _asdict(got) == _asdict(want)
            want = jp.plan_memory(jcfg, jb.SHAPES["train_4k"], jb.MeshSpec(*MESH1),
                                  jb.LMSConfig(), jhw, optimizer="sgdm")
            got = tp.plan_memory(tcfg, conv(jb.SHAPES["train_4k"], tb.ShapeConfig),
                                 tb.MeshSpec(*MESH1), tb.LMSConfig(), thw_, optimizer="sgdm")
            assert _asdict(got) == _asdict(want)


def _profiles(jm):
    """(JAX, port) calibration inputs: the committed obs report, a report
    with a measured activations class, and an audited live-bytes margin
    alone (the analysis report's shape)."""
    report = json.loads(FIXTURE.read_text())
    acts = json.loads(FIXTURE.read_text())
    acts["classes"]["activations"] = {"bytes": 1 << 30, "events": 8, "span_s": 0.1,
                                      "bytes_per_s": 1e10}
    acts["classes"]["params"]["span_s"] = 0.5
    analysis = {"steps": [{"name": "train", "plan_delta_bytes": 3 << 30},
                          {"name": "decode", "plan_delta_bytes": 1 << 20}]}
    out = [(report, report), (acts, acts)]
    for hw_j, hw_t in _hardware(jm):
        out.append((jm["cost"].CostModel.from_reports(None, analysis, hw=hw_j),
                    tcost.CostModel.from_reports(None, analysis, hw=hw_t)))
    return out


def test_calibrated_plan_matches_jax(jax_pricing, jm):
    """plan(profile=...) on both sides from the same calibration inputs:
    tuned prefetch depth, the live-bytes margin charged into the budget and
    the peak, the remat-or-swap choice at measured cost, the DDL bucket."""
    jb, jp = jm["base"], jm["plan"]
    for jprof, tprof in _profiles(jm):
        for arch in ("qwen2.5-14b", "qwen2-72b", "grok-1-314b"):
            jcfg = jm["get_config"](arch)
            for mesh in MESHES[:3]:
                for budget in (0, 16_000_000_000):
                    for jhw, thw_ in _hardware(jm):
                        want = jp.plan(jp.PlanRequest(
                            cfg=jcfg, shape=jb.SHAPES["train_4k"], mesh=jb.MeshSpec(*mesh),
                            lms=jb.LMSConfig(hbm_budget=budget), hw=jhw), profile=jprof)
                        got = tp.plan(tp.PlanRequest(
                            cfg=conv(jcfg, tb.ModelConfig),
                            shape=conv(jb.SHAPES["train_4k"], tb.ShapeConfig),
                            mesh=tb.MeshSpec(*mesh), lms=tb.LMSConfig(hbm_budget=budget),
                            hw=thw_), profile=tprof)
                        assert got.calibrated == want.calibrated
                        assert _asdict(got) == _asdict(want), (arch, mesh, budget)


def test_cost_model_matches_jax(jm):
    """CostModel on the fixture: what it loads and every price it makes."""
    jc = jm["cost"]
    for jhw, thw_ in _hardware(jm):
        a = jc.CostModel.load(str(FIXTURE), hw=jhw)
        b = tcost.CostModel.load(str(FIXTURE), hw=thw_)
        assert (a.class_bw, a.default_bw, a.overlap_frac, a.mean_step_s, a.source) == \
            (b.class_bw, b.default_bw, b.overlap_frac, b.mean_step_s, b.source)
        for m1, m2 in ((a, b), (jc.CostModel.from_hardware(jhw),
                                tcost.CostModel.from_hardware(thw_))):
            for cls in ("kvcache", "params", "activations"):
                assert m1.bw(cls) == m2.bw(cls)
                for nbytes, comp in ((1e6, 1e-3), (1e9, 0.01), (1e10, 0.0)):
                    assert m1.exposed_swap_s(nbytes, cls, comp) == m2.exposed_swap_s(nbytes, cls, comp)
            assert m1.hidden_frac() == m2.hidden_frac()
            assert m1.describe() == m2.describe()
            for L in (1, 7, 48, 80):
                for per, t in ((1e6, 1e-4), (5e8, 1e-3)):
                    assert m1.tune_prefetch_depth(L, per, t) == m2.tune_prefetch_depth(L, per, t)
            for t in (1e-6, 1e-3, 0.1):
                assert m1.tune_bucket_mb(t) == m2.tune_bucket_mb(t)
            for sb in (1e5, 1e8, 1e10):
                assert m1.tune_staging_depth(sb) == m2.tune_staging_depth(sb)
    analysis = {"steps": [{"name": "zero1_train", "plan_delta_bytes": 5},
                          {"name": "train", "plan_delta_bytes": 7}, {"name": "decode"}]}
    a = jc.CostModel.from_reports(json.loads(FIXTURE.read_text()), analysis)
    b = tcost.CostModel.from_reports(json.loads(FIXTURE.read_text()), analysis)
    assert a.step_deltas == b.step_deltas and a.live_margin("train") == b.live_margin("train") == 7
    for bad in ({"schema": 2}, {"schema": 1, "classes": {}}, [1]):
        with pytest.raises(ValueError):
            jc.validate_obs_report(bad)
        with pytest.raises(ValueError):
            tcost.validate_obs_report(bad)
    assert tcost.DISPATCH_TAX == jc.DISPATCH_TAX


def test_schedule_invariant_matches_jax(jm):
    """check_schedule_invariant raises in the same cases on both sides; the
    port raises NotImplementedError for the step auditor (step_fn)."""
    jp = jm["plan"]
    cases = [({"params": "host"}, "train", (), False, False),
             ({"params": "host", "optimizer": "host"}, "train", ("optimizer",), False, False),
             ({"grads": "host"}, "train", ("grads",), False, False),
             ({"kvcache": "host"}, "decode", (), True, False),
             ({"kvcache": "host"}, "decode", (), True, True),
             ({"params": "device"}, "train", (), False, False)]
    for res, kind, placement, serve, paging in cases:
        for drop in (False, True):
            def run(mod):
                sched = mod.make_swap_schedule(res, 4, kind, placement_only=placement)
                if drop and sched is not None:
                    sched = dataclasses.replace(sched, stream=())
                kv = (mod.KVPagingPlan(16, 1, 0, 4, 8, 8) if paging else None)
                try:
                    mod.check_schedule_invariant(res, sched, placement, serve=serve,
                                                 kv_paging=kv)
                    return None
                except AssertionError as e:
                    return str(e)
            assert run(tp) == run(jp), (res, drop)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tp.check_schedule_invariant({}, None, step_fn=lambda: None)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

def _cfg(layers=2, arch=ARCH, **kw):
    return dataclasses.replace(get_smoke_config(arch), num_layers=layers, **kw)


def _tcfg(layers=2, arch=ARCH, vocab=None, **kw):
    cfg = _cfg(layers, arch) if vocab is None else _cfg(layers, arch, vocab_size=vocab)
    return tb.TrainConfig(model=cfg, shape=tb.ShapeConfig("t", "train", 16, 2),
                          mesh=tb.MeshSpec(*MESH1), **{"warmup_steps": 1,
                                                       "learning_rate": 1e-2,
                                                       "total_steps": 10,
                                                       "checkpoint_dir": None, **kw})


def _plan(cfg, residency, depth=2, assignment=None):
    full = {"params": "device", "grads": "device", "optimizer": "device",
            "kvcache": "device", **residency}
    sched = tp.make_swap_schedule(full, cfg.num_layers, "train", prefetch_depth=depth)
    return tp.MemoryPlan(dict(assignment or {}), full, 1, 1, 1, 1, True, swap_schedule=sched)


def _batches(cfg, n=3, b=2, s=16, seed=3):
    data = SyntheticTokens(cfg.vocab_size, seed=seed)
    return [data.batch(i, 0, 1, b, s) for i in range(n)]


def _state_leaves(st):
    o = st.opt
    trees = [st.params] + ([o.mu, o.nu, o.master] if hasattr(o, "mu") else [o.momentum])
    return [st.step, o.step] + [leaf for t in trees for leaf in tree_leaves(t)]


def _run(tcfg, plan, batches, seed=5):
    model = Model(tcfg.model)
    state = tsteps.init_train_state(model, tcfg, seed, "cpu", plan=plan)
    step = tsteps.build_train_step(model, tcfg, spec=tsteps.StepSpec(plan=plan))
    mets = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        mets.append({k: v.item() for k, v in m.items()})
    return mets, state


def test_streamed_loss_and_grads_match_jax(jax_pricing, ref, jm, arch=ARCH):
    """The loss and its grads through the streamed stack (params from
    pinned host, the plan's policy) against jax.value_and_grad of the JAX
    package's streamed model loss with the same plan's policy and
    schedule, from the same random params."""
    jax = ref.jax
    jb, jp = jm["base"], jm["plan"]
    jcfg = ref.get_smoke_config(arch)
    shape = jb.ShapeConfig("t", "train", 16, 2)
    jplan = jp.plan(jp.PlanRequest(cfg=jcfg, shape=shape, mesh=jb.MeshSpec(*MESH1),
                                   lms=jb.LMSConfig(hbm_budget=SMOKE_BUDGET)))
    plan = tp.plan(tp.PlanRequest(cfg=_cfg(arch=arch), shape=conv(shape, tb.ShapeConfig),
                                  mesh=tb.MeshSpec(*MESH1),
                                  lms=tb.LMSConfig(hbm_budget=SMOKE_BUDGET)))
    assert _asdict(plan) == _asdict(jplan)
    assert plan.swap_schedule.stream == ("params", "optimizer")
    jparams, nparams = random_params(ref, jcfg, seed=9)
    b = _batches(_cfg(arch=arch), n=1)[0]
    jmodel = ref.Model(jcfg)

    def jloss(p):
        return jmodel.loss(p, {k: ref.jnp.asarray(v) for k, v in b.items()},
                           policy=jp.plan_to_policy(jplan), stream=jplan.swap_schedule)[0]
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)

    params = params_from_jax(nparams, "cpu")
    stack = params["decoder"]["stack0"]
    rest = {k: v for k, v in params.items() if k != "decoder"}
    leaves = tree_map(lambda p: p.detach().requires_grad_(), rest)
    gstack = tree_map(torch.zeros_like, stack)
    loss, _ = Model(_cfg(arch=arch)).loss({**leaves, "decoder": {"stack0": stack}},
                                 {k: torch.from_numpy(v) for k, v in b.items()},
                                 policy=tp.plan_to_policy(plan), stream=plan.swap_schedule,
                                 stack_grads=gstack)
    g = tree_unflatten(leaves, torch.autograd.grad(loss, tree_leaves(leaves)))
    grads = {**g, "decoder": {"stack0": gstack}}
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-2)
    for got, want in zip(tree_leaves(grads), _jleaves(jax.tree.map(np.asarray, jg))):
        within_max(got.float(), want, 2.0 ** -4)


@pytest.mark.parametrize("arch", DENSE_ARCHS[1:])
def test_streamed_loss_and_grads_match_jax_dense(jax_pricing, ref, jm, arch):
    """`test_streamed_loss_and_grads_match_jax` on each other dense smoke config."""
    test_streamed_loss_and_grads_match_jax(jax_pricing, ref, jm, arch)


def test_streamed_train_steps_match_jax(jax_pricing, ref, jm, arch=ARCH):
    """3 train steps under the smoke plan (params and optimizer streamed,
    the residual stream offloaded, the rest recomputed) on both sides from
    one state (JAX's, converted and placed as the plan says): loss, ce and
    grad norm each step, then the master weights and params."""
    jax, jnp = ref.jax, ref.jnp
    jb, jp, js = jm["base"], jm["plan"], jm["steps"]
    lr = 1e-3
    kw = dict(learning_rate=lr, warmup_steps=0, total_steps=10)
    jt = jb.TrainConfig(model=ref.get_smoke_config(arch),
                        shape=jb.ShapeConfig("t", "train", 16, 2), mesh=jb.MeshSpec(*MESH1),
                        lms=jb.LMSConfig(hbm_budget=SMOKE_BUDGET), **kw)
    tt = _tcfg(arch=arch, lms=tb.LMSConfig(hbm_budget=SMOKE_BUDGET), **kw)
    req = dict(mesh=jb.MeshSpec(*MESH1))
    jplan = jp.plan(jp.PlanRequest(cfg=jt.model, shape=jt.shape, lms=jt.lms, **req))
    plan = tp.plan(tp.PlanRequest(cfg=tt.model, shape=tt.shape, mesh=tt.mesh, lms=tt.lms))
    assert _asdict(plan) == _asdict(jplan)
    jparams, _ = random_params(ref, jt.model, seed=5)
    jstate = js.TrainState(jnp.zeros((), jnp.int32), jparams,
                           jm["adamw"].adamw_init(jparams))
    state = tsteps.place_train_state(
        train_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu"), plan, "cpu")
    jstep, _, _ = js.build_train_step(ref.Model(jt.model), jt, ref.mesh(), plan=jplan,
                                      donate=False)
    step = tsteps.build_train_step(Model(tt.model), tt, plan=plan)
    for i, b in enumerate(_batches(tt.model)):
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, met = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=2e-3,
                                       err_msg=f"{k}, step {i + 1}")
    _check_masters(state, jstate, lr, 3)


@pytest.mark.parametrize("arch", DENSE_ARCHS[1:])
def test_streamed_train_steps_match_jax_dense(jax_pricing, ref, jm, arch):
    """`test_streamed_train_steps_match_jax` on each other dense smoke config."""
    test_streamed_train_steps_match_jax(jax_pricing, ref, jm, arch)


@pytest.mark.parametrize("arch,depth,optimizer",
                         [pytest.param(ARCH, d, o, id=f"{d}-{o}") for d in (1, 2)
                          for o in ("adamw", "sgdm")]
                         + [pytest.param("olmo-1b", 2, "adamw", id="olmo-1b-2-adamw")])
def test_streamed_steps_equal_resident_bitwise(arch, depth, optimizer):
    """The port's streamed steps against its resident steps from one seed,
    3 steps, 4 layers: params and optimizer streamed (and the optimizer
    alone), with the lms_ab policy (five classes offloaded, mlp_hidden
    recomputed) and with full recompute. Every metric and every leaf of
    the state: bitwise. olmo-1b (norm subtrees with no leaves, a tied
    embedding) with a vocabulary of 2**14, so its tied table (2**20
    elements) updates in the sweep's 16 rest chunks."""
    vocab = 1 << 14 if arch == "olmo-1b" else None
    tcfg = _tcfg(layers=4, arch=arch, vocab=vocab, optimizer=optimizer)
    if vocab:
        assert tsteps._rest_chunks(vocab * tcfg.model.d_model) == 16
    batches = _batches(tcfg.model)
    base, base_state = _run(tcfg, None, batches)
    for residency in ({"params": "host", "optimizer": "host"}, {"optimizer": "host"}):
        for assignment in (OFFLOAD_ALL_BUT_MLP, {}):
            plan = _plan(tcfg.model, residency, depth, assignment)
            mets, state = _run(tcfg, plan, batches)
            assert mets == base, (residency, assignment)
            for a, b in zip(_state_leaves(base_state), _state_leaves(state)):
                assert a.dtype == b.dtype and torch.equal(a, b), (residency, assignment)


def test_streamed_rest_chunking_exact():
    """Unstacked leaves of >= 2**20 elements update in 16 flat chunks of
    their state (the fp32 embedding state never comes in whole), the small
    ones in one; the sweep equals the resident update bitwise, and the
    optimizer's swap events count one a layer and one a chunk."""
    rng = np.random.default_rng(0)

    def f32(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    params = {"embed": {"w": f32(4096, 256)}, "decoder": {"stack0": {"w": f32(2, 8, 8)}},
              "final_norm": {"scale": f32(8)}}
    grads = tree_map(lambda p: f32(*p.shape), params)
    kw = dict(lr=torch.tensor(0.1), beta1=0.9, beta2=0.95, weight_decay=0.1)
    sched = tp.make_swap_schedule({"optimizer": "host"}, 2, "train")

    def clone(t):
        return tree_map(lambda x: x.clone(), t)
    with torch.no_grad():
        gr, _ = adamw.clip_by_global_norm(clone(grads), 1.0)
        rp, rs = adamw.adamw_update(gr, adamw.adamw_init(params), clone(params), **kw)
        gs, _ = adamw.clip_by_global_norm(clone(grads), 1.0)
        before = off.swap_counters()
        sp, ss = tsteps._streamed_opt_update("adamw", gs, adamw.adamw_init(params),
                                             clone(params), schedule=sched,
                                             params_host=False, device=torch.device("cpu"),
                                             **kw)
    after = off.swap_counters()
    assert tsteps._rest_chunks(4096 * 256) == 16 and tsteps._rest_chunks(8) == 1
    for key in ("lms.swap_in_events.optimizer", "lms.swap_out_events.optimizer"):
        assert after[key] - before.get(key, 0) == 2 + 16 + 1
    n = sum(t.numel() for t in tree_leaves(params))
    assert after["lms.swap_in_bytes.optimizer"] - before.get(
        "lms.swap_in_bytes.optimizer", 0) == 12 * n
    for a, b in zip([x for t in (rp, rs.mu, rs.nu, rs.master) for x in tree_leaves(t)],
                    [x for t in (sp, ss.mu, ss.nu, ss.master) for x in tree_leaves(t)]):
        assert torch.equal(a, b)
    assert int(ss.step) == int(rs.step) == 1


def test_init_train_state_placed_equals_resident():
    """init_train_state(plan=) builds, one layer at a time, the state
    init_train_state builds whole: bitwise, for either optimizer."""
    for optimizer in ("adamw", "sgdm"):
        tcfg = _tcfg(layers=3, optimizer=optimizer)
        model = Model(tcfg.model)
        a = tsteps.init_train_state(model, tcfg, 11, "cpu")
        b = tsteps.init_train_state(model, tcfg, 11, "cpu",
                                    plan=_plan(tcfg.model, {"params": "host",
                                                            "optimizer": "host"}))
        for x, y in zip(_state_leaves(a), _state_leaves(b)):
            assert x.dtype == y.dtype and torch.equal(x, y)


def _pack_kinds(monkeypatch):
    """Record, for each tensor the frames' pack hook sees, the handle kind
    it gives (and the tagged class of a "tag" handle)."""
    seen = []
    pack = policies.LayerFrame._pack

    def spy(self, t):
        h = pack(self, t)
        if isinstance(h, torch.Tensor):
            seen.append(("resident", None))
        elif h[0] == "tag":
            seen.append(("tag", self.tags[h[1]].name))
        else:
            seen.append((h[0], None))
        return h
    monkeypatch.setattr(policies.LayerFrame, "_pack", spy)
    return seen


def _counter_delta(before, prefix):
    reg = get_obs().registry
    return {n[len(prefix):]: reg.counter(n).value - before.get(n, 0)
            for n in reg.names() if n.startswith(prefix)}


def test_policy_keeps_exactly_the_assigned_classes(monkeypatch):
    """Under each assignment the frames keep (on the device, or offloaded)
    exactly the tagged classes it saves or offloads, L times the bytes of
    `activation_classes` each (attn_out excepted: the planner prices it at
    the q/k/v width, (H + 2K) D, the tensor is [B, S, H, D]), and the pack
    hooks hand out tag handles only for those classes; the loss and grads
    are the resident ones."""
    cfg = _cfg(layers=2)
    shape = tb.ShapeConfig("t", "train", 16, 2)
    acts = {a.name: a.bytes_dev for a in tp.activation_classes(cfg, shape, tb.MeshSpec(*MESH1))}
    b = _batches(cfg, n=1)[0]
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    model = Model(cfg)
    params = model.init(2, "cpu")
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss0, _ = model.loss(leaves, batch)
    g0 = torch.autograd.grad(loss0, tree_leaves(leaves))
    names = ("resid", "attn_norm", "qkv", "attn_out", "mlp_norm", "mlp_hidden")
    attn_out_bytes = 2 * 16 * cfg.num_heads * cfg.head_dim * 2
    assert policies.policy_from_preset("none") is None
    assert policies.policy_from_preset("full") == policies.build_policy({})
    assert policies.policy_from_preset("save_all").everything
    assert policies.policy_from_preset("offload") == policies.build_policy(
        {"resid": "offload", "mlp_hidden": "offload", "qkv": "offload"})
    with pytest.raises(ValueError):
        policies.build_policy({"qkv": "swap"})
    seen = _pack_kinds(monkeypatch)
    for assignment in (OFFLOAD_ALL_BUT_MLP, {n: "save" for n in names},
                       {"resid": "offload", "qkv": "save", "mlp_hidden": "offload"}, {}):
        seen.clear()
        reg = get_obs().registry
        before = {n: reg.counter(n).value for n in reg.names()}
        rest = {k: v for k, v in params.items() if k != "decoder"}
        rl = tree_map(lambda p: p.detach().requires_grad_(), rest)
        gstack = tree_map(torch.zeros_like, params["decoder"]["stack0"])
        loss, _ = model.loss({**rl, "decoder": params["decoder"]}, batch,
                             policy=policies.build_policy(assignment), stack_grads=gstack)
        g = tree_unflatten(rl, torch.autograd.grad(loss, tree_leaves(rl)))
        assert torch.equal(loss, loss0)
        assert all(torch.equal(x, y) for x, y in
                   zip(tree_leaves({**g, "decoder": {"stack0": gstack}}), g0))
        kept = {"save": _counter_delta(before, "lms.save_bytes."),
                "offload": _counter_delta(before, "lms.offload_bytes.")}
        # the layer input is kept whatever the policy says: the replay
        # starts from it (the JAX scan saves its carry the same way)
        want = {"save": {}, "offload": {}}
        for n in names:
            d = assignment.get(n, "remat")
            if n == "resid" and d == "remat":
                d = "save"
            if d != "remat":
                want[d][n] = cfg.num_layers * (attn_out_bytes if n == "attn_out" else acts[n])
        assert {k: {n: v for n, v in d.items() if v} for k, d in kept.items()} == want
        handed = {name for kind, name in seen if kind == "tag"}
        assert handed <= {n for d in want.values() for n in d}
        assert {kind for kind, _ in seen} <= {"tag", "resident", "drop"}


def test_swap_counters_count_what_moved():
    """After one step under a plan that streams params and the optimizer
    and offloads five classes, the swap counters hold what the executor
    moved: the stack's params in twice (forward and backward), the rest
    in host memory beside it in once (the batch's embedding rows, the final
    norm and the head, one event each), every param out once (the sweep's
    write-back), the whole optimizer state in and out once, each offloaded
    activation out and in once, one event a layer (a slice, an
    activation). Against the plan's `swap_schedule.swap_bytes`: the
    optimizer's equals it; the params' prices 2 bytes a param and leaves
    the write-back out."""
    tcfg = _tcfg(layers=4)
    cfg = tcfg.model
    shape = tcfg.shape
    plan = _plan(cfg, {"params": "host", "optimizer": "host"}, 2, OFFLOAD_ALL_BUT_MLP)
    priced = tp.plan(tp.PlanRequest(cfg=cfg, shape=shape, mesh=tcfg.mesh,
                                    lms=tb.LMSConfig(hbm_budget=1)))
    model = Model(cfg)
    state = tsteps.init_train_state(model, tcfg, 0, "cpu", plan=plan)
    step = tsteps.build_train_step(model, tcfg, plan=plan)
    before = off.swap_counters()
    b = _batches(cfg, n=1)[0]
    step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    moved = {k: v - before.get(k, 0) for k, v in off.swap_counters().items()}
    stack_bytes = off.tree_bytes(state.params["decoder"]["stack0"])
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    acts = {a.name: a.bytes_dev for a in tp.activation_classes(cfg, shape, tcfg.mesh)}
    act_bytes = cfg.num_layers * (acts["resid"] + acts["attn_norm"] + acts["qkv"]
                                  + acts["mlp_norm"] + 2 * 16 * cfg.num_heads * cfg.head_dim * 2)
    rows = b["tokens"].size * cfg.d_model * 4
    head = off.tree_bytes(state.params["embed"].get("lm_head", state.params["embed"]))
    norm = state.params["final_norm"]
    assert moved["lms.swap_in_bytes.params"] == (2 * stack_bytes + rows + head
                                                 + off.tree_bytes(norm))
    assert moved["lms.swap_in_events.params"] == 2 * cfg.num_layers + 2 + len(norm)
    assert moved["lms.swap_out_bytes.params"] == off.tree_bytes(state.params)
    assert moved["lms.swap_in_bytes.optimizer"] == moved["lms.swap_out_bytes.optimizer"] \
        == 12 * n_params
    assert moved["lms.swap_in_bytes.activations"] == moved["lms.swap_out_bytes.activations"] \
        == act_bytes
    assert moved["lms.swap_out_events.activations"] == cfg.num_layers * 7   # q, k, v apart
    assert dict(priced.swap_schedule.swap_bytes) == {
        "optimizer": moved["lms.swap_in_bytes.optimizer"] + moved["lms.swap_out_bytes.optimizer"],
        "params": 2 * 2 * n_params}
    # the plan prices 2 bytes a param, the stack's norm scales are f32
    stack_params = sum(t.numel() for t in tree_leaves(state.params["decoder"]))
    assert stack_bytes > 2 * stack_params and stack_params < n_params


# ---------------------------------------------------------------------------
# the trainer, the CLI, and what is not ported yet
# ---------------------------------------------------------------------------

def test_trainer_matches_jax_trainer_under_a_plan(jax_pricing, ref, jm, tmp_path):
    """Trainer(LMSConfig(hbm_budget=SMOKE_BUDGET)) on both sides: the same
    plan field by field, and from JAX's initial state (placed as the plan
    says) per step the same loss, ce, grad norm and lr within the train
    step's bounds."""
    jax = ref.jax
    jb = jm["base"]
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3)
    jt = jb.TrainConfig(model=ref.get_smoke_config(ARCH),
                        shape=jb.ShapeConfig("t", "train", 16, 4), mesh=jb.MeshSpec(*MESH1),
                        lms=jb.LMSConfig(hbm_budget=SMOKE_BUDGET),
                        checkpoint_dir=str(tmp_path), **kw)
    tt = dataclasses.replace(_tcfg(lms=tb.LMSConfig(hbm_budget=SMOKE_BUDGET), **kw),
                             shape=tb.ShapeConfig("t", "train", 16, 4))
    jtrainer = jm["trainer"].Trainer(jt)
    trainer = Trainer(tt, device="cpu")
    assert _asdict(trainer.plan) == _asdict(jtrainer.plan)
    assert trainer.plan.swap_schedule.stream == ("params", "optimizer")
    jinit = jax.tree.map(np.asarray, jtrainer.init_state())
    _, jhist = jtrainer.train(steps=3)
    trainer.init_state = lambda: tsteps.place_train_state(
        train_state_from_jax(jinit, "cpu"), trainer.plan, "cpu")
    _, hist = trainer.train(steps=3)
    for row, jrow in zip(hist, jhist):
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(row[k], jrow[k], rtol=2e-3, err_msg=k)
        np.testing.assert_allclose(row["lr"], jrow["lr"], rtol=1e-6)


ARGS = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
        "--seq", "16"]


def test_launch_train_with_lms_on_cpu(capsys, tmp_path):
    """The CLI trains with LMS on (no --no-lms) and finite losses; with a
    calibration profile the plan's summary is printed, with --no-lms the
    trainer has no plan."""
    assert launch.main(ARGS + ["--profile", str(FIXTURE),
                               "--ckpt-dir", str(tmp_path / "profiled")]) == 0
    out = capsys.readouterr().out
    assert "LMS plan:" in out and "calibrated: yes" in out
    losses = [float(line.split("|")[1].split()[1]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert launch.main(ARGS + ["--ckpt-dir", str(tmp_path / "planned")]) == 0
    assert "final loss: " in capsys.readouterr().out


def test_what_is_not_ported_raises():
    """Grads on the host and LMS + DDL build now (tests/test_torch_lms_ddl.py
    runs them), and so does LMS with microbatches
    (tests/test_torch_microbatches.py), and the Mamba-2 stack under a plan
    (tests/test_torch_ssm_serve.py runs it); params on the host with the
    optimizer on the device (with microbatches too): "not ported yet".
    Serve plans build (tests/test_torch_serve_plan.py runs them)."""
    from repro_torch.launch.mesh import Mesh
    tcfg = _tcfg()
    model = Model(tcfg.model)
    sink = _plan(tcfg.model, {"grads": "host", "optimizer": "host"})
    assert tsteps._grads_host(sink)
    tsteps.build_train_step(model, tcfg, plan=sink)
    with pytest.raises(NotImplementedError, match="optimizer state on the device"):
        tsteps.build_train_step(model, tcfg, plan=_plan(tcfg.model, {"params": "host"}))
    plan = _plan(tcfg.model, {"optimizer": "host"})
    two = tb.MeshSpec((2, 1, 1), ("pod", "data", "model"))
    tsteps.build_train_step(model, dataclasses.replace(tcfg, mesh=two), plan=sink,
                            mesh=Mesh(two, rank=0))
    tsteps.build_train_step(model, dataclasses.replace(tcfg, microbatches=2), plan=plan)
    with pytest.raises(NotImplementedError, match="optimizer state on the device"):
        tsteps.build_train_step(model, dataclasses.replace(tcfg, microbatches=2),
                                plan=_plan(tcfg.model, {"params": "host"}))
    mamba = Model(get_smoke_config("mamba2-1.3b"))
    assert callable(tsteps.build_train_step(mamba, dataclasses.replace(tcfg, model=mamba.cfg),
                                            plan=plan))
    spec = tsteps.StepSpec(plan=plan)
    for build in (tsteps.build_prefill_step, tsteps.build_decode_step,
                  tsteps.build_slot_decode_step):
        fn, _ = build(model, tb.ShapeConfig("d", "decode", 16, 2), spec)
        assert callable(fn)


@pytest.mark.parametrize("arch", [ARCH, "olmo-1b"])
def test_params_host_plan_places_the_rest_in_the_arena(arch):
    """Under a plan that puts params on the host every param leaf lies in
    the one pinned arena, the unstacked rest's (embedding, final norm, head
    or the tied table) too, and the arena's bytes are `_state_layout`'s;
    the values are `model.init`'s; a streamed step leaves no rest leaf with
    an autograd grad (its grads come from the model's sinks) and equals
    the resident step bitwise."""
    tcfg = _tcfg(arch=arch)
    model = Model(tcfg.model)
    plan = _plan(tcfg.model, {"params": "host", "optimizer": "host"})
    state = tsteps.init_train_state(model, tcfg, 0, "cpu", plan=plan)
    arena = off._ARENAS[-1]
    lo, hi = arena.buffer.data_ptr(), arena.buffer.data_ptr() + arena.buffer.numel()
    assert all(lo <= t.data_ptr() < hi for t in tree_leaves(state.params))
    paths = [(path, d.shape, tsteps.DTYPES[d.dtype]) for path, d in
             tsteps._def_paths(model.param_defs())]
    assert arena.offset == tsteps._state_layout(paths, "adamw", True, True)[0]
    want = model.init(0, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state.params), tree_leaves(want)))
    resident = tsteps.init_train_state(model, tcfg, 0, "cpu")
    b = {k: torch.from_numpy(v) for k, v in _batches(tcfg.model, n=1)[0].items()}
    state, met = tsteps.build_train_step(model, tcfg, plan=plan)(state, b)
    resident, rmet = tsteps.build_train_step(model, tcfg)(resident, b)
    assert all(t.grad is None for t in tree_leaves(state.params))
    assert {k: v.item() for k, v in met.items()} == {k: v.item() for k, v in rmet.items()}
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state.params),
                                                 tree_leaves(resident.params)))


def test_rows_grad_is_autograds_table_grad_in_any_range():
    """The embedding's grad in its rows' form (`models/rest.RowsGrad`, what
    the model's sink gets for a table in host memory): its dense form is
    autograd's grad of `table[tokens]` bitwise, repeated tokens included,
    and every flat range of it is the same elements, made from the rows
    that fall there alone."""
    from repro_torch.models.rest import RowsGrad
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(37, 8, generator=gen).requires_grad_()
    tokens = torch.randint(0, 37, (3, 11), generator=gen, dtype=torch.int32)
    tokens[0, :4] = 5                      # a row read four times
    g = torch.randn(3, 11, 8, generator=gen)
    want, = torch.autograd.grad(table[tokens], table, g)
    rows = RowsGrad(table.shape, tokens, g)
    assert torch.equal(rows.dense(), want)
    flat = want.reshape(-1)
    for a, b in ((0, 296), (3, 5), (37, 90), (40, 41), (290, 296), (0, 1)):
        assert torch.equal(rows.flat_range(a, b), flat[a:b]), (a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_grad_is_autograds_head_grad_in_any_range(monkeypatch, dtype):
    """An untied head's grad in its factors' form (`models/rest.HeadGrad`,
    what the model's sink gets for a head in host memory): blocks of
    HEAD_ROWS rows, its dense form and every flat range of it are
    autograd's grad of `x @ head` bitwise, and `head_input_grad` is x's."""
    from repro_torch.models import rest
    monkeypatch.setattr(rest, "HEAD_ROWS", 8)
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 9, 36, generator=gen).to(dt).requires_grad_()
    head = torch.randn(36, 50, generator=gen).to(dt).requires_grad_()
    g = torch.randn(2, 9, 50, generator=gen).to(dt)
    want_x, want = torch.autograd.grad(x @ head, (x, head), g)
    got = rest.HeadGrad(head.shape, x.detach(), g)
    assert torch.equal(got.dense(), want)
    assert torch.equal(rest.head_input_grad(g, head.detach()), want_x)
    flat = want.reshape(-1)
    for a, b in ((0, 1800), (3, 5), (395, 420), (399, 401), (1790, 1800), (0, 1), (450, 1203)):
        assert torch.equal(got.flat_range(a, b), flat[a:b]), (a, b)


def test_state_is_freed_without_the_garbage_collector():
    """After a streamed run the host state goes as soon as its last
    reference does: nothing on the path (the executor's closures, the tree
    helpers) keeps it in a reference cycle that only the garbage collector
    would break. On the card that memory is tens of GB of pinned host
    memory the next phase needs."""
    import gc
    tcfg = _tcfg(lms=tb.LMSConfig(hbm_budget=SMOKE_BUDGET))
    gc.collect()
    gc.disable()
    try:
        trainer = Trainer(tcfg, device="cpu")
        assert trainer.plan.swap_schedule.streams_params
        trainer.train(steps=2)
        arena = off._ARENAS[-1]
        ptr = arena.buffer.untyped_storage().data_ptr()
        off.release_arenas()
        del trainer
        alive = [o for o in gc.get_objects()
                 if type(o) is torch.Tensor and o.untyped_storage().data_ptr() == ptr]
    finally:
        gc.enable()
    assert not alive


def test_reserved_arena_is_reused_and_zeroed():
    """States placed one after another in a reserved arena: each takes it
    from its start, comes out as a fresh state would (the optimizer's zeros
    included, though the arena held a trained state), and `pinned_bytes`
    counts what the state in use takes."""
    tcfg = _tcfg(layers=2)
    model = Model(tcfg.model)
    plan = _plan(tcfg.model, {"params": "host", "optimizer": "host"})
    need = tsteps._state_layout(
        [(p, d.shape, tsteps.DTYPES[d.dtype]) for p, d in tsteps._def_paths(model.param_defs())],
        "adamw", True, True)[0]
    off.release_arenas()
    arena = off.reserve_pinned(need + (1 << 20), "cpu")
    try:
        fresh = _state_leaves(tsteps.init_train_state(model, tcfg, 3, "cpu"))
        state = tsteps.init_train_state(model, tcfg, 3, "cpu", plan=plan)
        assert off._ARENAS == [arena] and off.pinned_bytes() == need
        step = tsteps.build_train_step(model, tcfg, plan=plan)
        b = _batches(tcfg.model, n=1)[0]
        step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        del state
        off.release_arenas()
        assert off._ARENAS == [arena] and off.pinned_bytes() == 0 and arena.dirty
        again = _state_leaves(tsteps.init_train_state(model, tcfg, 3, "cpu", plan=plan))
        assert off._ARENAS == [arena]
        assert all(torch.equal(x, y) for x, y in zip(fresh, again))
    finally:
        arena.reserved = False
        off.release_arenas()
    assert off._ARENAS == []
