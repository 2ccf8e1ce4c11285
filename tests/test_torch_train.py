"""The port's one-device training path against the JAX package, on the
CPU: AdamW, momentum SGD and global-norm clipping, the LR schedules, the
synthetic data stream, the loss and its grads through the decoder with and
without remat, the train step (with and without microbatches), the
Trainer and the training CLI, on the qwen2.5-14b smoke config (2 layers,
d_model 64) with states converted from the JAX side; the loss, the train
step and the CLI also on the other dense smoke configs (olmo-1b: MHA,
LayerNorm without params, tied embeddings; starcoder2-7b: LayerNorm with
a bias, GELU with biases; qwen2-72b: 8 query heads of 8).

Tolerances. The optimizer, the schedules and clipping are the same f32
expressions on both sides: within 1e-6 relative (bf16 leaves within one
bf16 ulp). The data stream is numpy on both sides: bitwise. The loss
through the decoder in f32 agrees within 1e-5 relative and its grads
within 1e-4 of each leaf's largest |value| (sums in other orders, through
softmax and two norms). The model itself runs in bf16 (the embedding rows
are cast to bf16 on both sides), and the two frameworks round bf16
intermediates at different places: its loss agrees within 1e-2 relative
and its grads within 2**-4 of each leaf's largest |value|. A tied
embedding's grad sums its two uses (the rows taken and the head), and
the head's share is rounded to the bf16 table's type on both sides: in f32
an element whose share lies at a bf16 rounding boundary moves by one bf16
ulp of it, so that leaf is held within 2**-8 of its largest |value|, its
99th percentile within 1e-4; in bf16 the model's bounds hold it. A train step
of that model then gives losses and grad norms within 2e-3 relative (at
most 5e-4 measured), and after N Adam steps with rate lr each master
weight within 2 lr N of JAX's (at step 1 Adam moves a weight by +-lr
wherever |g| >> eps, so a gradient element near 0 whose sign differs by a
rounding moves it by 2 lr; at most 0.86 of that measured), the median
within 0.01 lr N and the 99th percentile within 0.1 lr N (measured 0.0015
and 0.029 lr N: bf16 grads differ by bf16 roundings, which Adam carries
into the later steps' updates).
"""
import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_ref import (jax_ref, jax_ref_scope,  # noqa: F401 (autouse fixture)
                                  random_params)

from repro_torch.config.base import (LMSConfig, MeshSpec, ShapeConfig,
                                     TrainConfig)
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.data import DataLoader, MMapTokens, SyntheticTokens
from repro_torch.launch import train as launch
from repro_torch.models import layers
from repro_torch.models import transformer as tr
from repro_torch.models.model import Model
from repro_torch.optim import adamw, schedule
from repro_torch.train.steps import _microbatch_split, build_train_step
from repro_torch.train.trainer import Trainer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

ARCH = "qwen2.5-14b"
DENSE = ("olmo-1b", "starcoder2-7b", "qwen2-72b")
MESH = ((1, 1), ("data", "model"))


def f32(x):
    return np.asarray(x).astype(np.float32)


def bf16_ulp(x):
    """One bf16 ulp at each |x| (8 significand bits), floored at tiny |x|."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.maximum(2.0 ** (e - 7), 2.0 ** -126)


def within_max(got, want, tol, what=""):
    """max |got - want| <= tol * max |want|."""
    got, want = f32(got), f32(want)
    err = np.abs(got - want).max()
    bound = tol * max(np.abs(want).max(), 1e-30)
    assert err <= bound, f"{what}: max |diff| {err} > {bound}"


def same_leaves(got, want, what=""):
    """Trees leaf by leaf: f32 leaves within 1e-6 relative (+1e-12), bf16
    leaves within one bf16 ulp."""
    for g, w in zip(tree_leaves(got), _jleaves(want)):
        w = np.asarray(w)
        g = g.detach()
        if g.dtype == torch.bfloat16:
            assert np.all(np.abs(f32(g.float()) - f32(w)) <= bf16_ulp(f32(w))), what
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-12, err_msg=what)


def _jleaves(tree):
    """A nested dict's leaves in the port's order (keys sorted, as jax's)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _jleaves(tree[k])]
    return [tree]


@pytest.fixture(scope="module")
def ref():
    return jax_ref()


@pytest.fixture(scope="module")
def jmods(ref):
    from repro.config import base as jbase
    from repro.data import pipeline as jdata
    from repro.optim import adamw as jadamw, schedule as jschedule
    from repro.train import steps as jsteps, trainer as jtrainer
    return dict(base=jbase, data=jdata, adamw=jadamw, schedule=jschedule,
                steps=jsteps, trainer=jtrainer)


def _tcfgs(jmods, arch=ARCH, **kw):
    """The same TrainConfig on both sides: (JAX, port). One device, LMS off."""
    jb = jmods["base"]
    cfg, jcfg = get_smoke_config(arch), jax_ref().get_smoke_config(arch)
    shape = dict(name="t", kind="train", seq_len=kw.pop("seq", 16),
                 global_batch=kw.pop("batch", 4))
    jt = jb.TrainConfig(model=jcfg, shape=jb.ShapeConfig(**shape), mesh=jb.MeshSpec(*MESH),
                        lms=jb.LMSConfig(enabled=False), **kw)
    tt = TrainConfig(model=cfg, shape=ShapeConfig(**shape), mesh=MeshSpec(*MESH),
                     lms=LMSConfig(enabled=False), **kw)
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
    return jt, tt


# ---------------------------------------------------------------------------
# optimizer, clipping, schedules
# ---------------------------------------------------------------------------

def _random_tree(seed):
    """A param-like tree: a stacked bf16 leaf, an f32 leaf larger than one
    update slice's worth of its rows, an f32 vector."""
    rng = np.random.default_rng(seed)
    return {"stack": {"w": rng.standard_normal((2, 8, 6)).astype(np.float32)},
            "emb": rng.standard_normal((40, 7)).astype(np.float32),
            "scale": (1 + 0.1 * rng.standard_normal(7)).astype(np.float32)}


def _as(tree, ref, dtypes):
    """The numpy tree as JAX arrays, of dtypes[key] or f32."""
    return {k: _as(v, ref, dtypes) if isinstance(v, dict) else
            ref.jnp.asarray(v, dtypes.get(k, "float32")) for k, v in tree.items()}


@pytest.mark.parametrize("opt", ["adamw", "sgdm"])
def test_optimizer_matches_jax_over_3_steps(ref, jmods, opt, monkeypatch):
    """adamw_update / sgdm_update against JAX's on a random tree (bf16 and
    f32 leaves) over 3 steps with per-step grads and rates: params and
    every state leaf. The port updates in place, slice by slice; a slice
    smaller than a leaf must not change a bit of the result."""
    monkeypatch.setattr(adamw, "SLICE", 64)
    jax, jnp = ref.jax, ref.jnp
    jinit, jupdate = jmods["adamw"].OPTIMIZERS[opt]
    init, update = adamw.OPTIMIZERS[opt]
    dtypes = {"w": "bfloat16"}
    jparams = _as(_random_tree(0), ref, dtypes)
    jstate = jinit(jparams)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    state = init(params)
    kw = dict(beta1=0.9, beta2=0.95, weight_decay=0.1)
    for i in range(3):
        g = _random_tree(10 + i)
        jg = _as(g, ref, dtypes)
        lr = np.float32(1e-2 * (i + 1))
        jparams, jstate = jupdate(jg, jstate, jparams, lr=jnp.float32(lr), **kw)
        with torch.no_grad():
            params, state = update(params_from_jax(jax.tree.map(np.asarray, jg), "cpu"),
                                   state, params, lr=torch.tensor(lr), **kw)
        same_leaves(params, jparams, f"{opt} params, step {i + 1}")
        assert int(state.step) == int(jstate.step) == i + 1
        for field in state._fields[1:]:
            same_leaves(getattr(state, field), getattr(jstate, field), f"{opt} {field}")


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(ref, jmods, max_norm, monkeypatch):
    """global_norm, clip_scale and clip_by_global_norm (clipping, then not)
    against JAX's; the port clips in place and rounds each leaf back to its
    dtype, as clip_leaf does."""
    monkeypatch.setattr(adamw, "SLICE", 64)
    jax = ref.jax
    ja = jmods["adamw"]
    jg = _as(_random_tree(3), ref, {"w": "bfloat16"})
    g = params_from_jax(jax.tree.map(np.asarray, jg), "cpu")
    np.testing.assert_allclose(adamw.global_norm(g).item(), float(ja.global_norm(jg)),
                               rtol=1e-6)
    jclipped, jgn = ja.clip_by_global_norm(jg, max_norm)
    clipped, gn = adamw.clip_by_global_norm(g, max_norm)
    assert clipped is g                                # in place
    np.testing.assert_allclose(gn.item(), float(jgn), rtol=1e-6)
    np.testing.assert_allclose(adamw.clip_scale(gn, max_norm).item(),
                               float(ja.clip_scale(jgn, max_norm)), rtol=1e-6)
    same_leaves(clipped, jclipped, f"clipped to {max_norm}")
    assert clipped["stack"]["w"].dtype == torch.bfloat16


def test_schedules_match_jax(ref, jmods):
    """warmup_cosine (warmup, cosine, past the end) and constant at steps
    0..30, f32 within 1e-6 relative."""
    jnp = ref.jnp
    js = jmods["schedule"]
    kw = dict(base_lr=3e-4, warmup_steps=5, total_steps=25)
    for step in range(31):
        want = js.warmup_cosine(jnp.asarray(step, jnp.int32), **kw)
        got = schedule.warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, err_msg=str(step))
        np.testing.assert_allclose(
            schedule.constant(torch.tensor(step), **kw).item(),
            float(js.constant(jnp.asarray(step), **kw)), rtol=0)
    assert schedule.warmup_cosine(torch.tensor(0), **kw).item() == 0.0
    assert set(schedule.SCHEDULES) == set(js.SCHEDULES)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_data_stream_matches_jax_bitwise(jmods, tmp_path):
    """SyntheticTokens batches for several shards and steps, a DataLoader's
    stream before and after snapshot/restore, and MMapTokens over one file:
    equal to the JAX package's bit for bit."""
    jd = jmods["data"]
    src, jsrc = SyntheticTokens(256, seed=7), jd.SyntheticTokens(256, seed=7)
    assert np.array_equal(src.perm, jsrc.perm)
    for args in ((0, 0, 1, 4, 16), (3, 1, 2, 2, 33), (5, 0, 4, 1, 8)):
        for key in ("tokens", "labels"):
            assert np.array_equal(src.batch(*args)[key], jsrc.batch(*args)[key]), args

    kw = dict(shard=1, num_shards=2, batch_per_shard=3, seq_len=12)
    mine, theirs = DataLoader(src, **kw), jd.DataLoader(jsrc, **kw)
    for _ in range(3):
        a, b = next(mine), next(theirs)
        assert all(np.array_equal(a[k], b[k]) for k in ("tokens", "labels"))
    snap, jsnap = mine.snapshot(), theirs.snapshot()
    assert snap == jsnap == {"epoch": 0, "step_in_epoch": 3, "seed": 0}
    ahead = [next(mine) for _ in range(2)]
    mine.restore(snap)
    theirs.restore(jsnap)
    for want in ahead:
        a, b = next(mine), next(theirs)
        assert all(np.array_equal(a[k], want[k]) and np.array_equal(b[k], want[k])
                   for k in ("tokens", "labels"))
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 256, 1000).astype(np.int32).tofile(path)
    mm, jmm = MMapTokens(str(path), 256), jd.MMapTokens(str(path), 256)
    for step in (0, 4, 30):
        assert all(np.array_equal(mm.batch(step, 1, 2, 3, 9)[k], jmm.batch(step, 1, 2, 3, 9)[k])
                   for k in ("tokens", "labels"))


# ---------------------------------------------------------------------------
# loss and grads
# ---------------------------------------------------------------------------

def _tokens(cfg, b=2, s=32, seed=21):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return toks, labels


def _grads(loss_fn, params):
    """-> (loss, grads tree) through torch autograd over every leaf."""
    leaves = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    return loss.detach(), tree_unflatten(params, grads)


@pytest.mark.parametrize("arch,no_remat", [pytest.param(ARCH, False, id="False"),
                                           pytest.param(ARCH, True, id="True"),
                                           pytest.param("olmo-1b", False, id="olmo-1b-False")])
def test_decoder_loss_and_grads_match_jax_f32(ref, arch, no_remat):
    """The loss through the decoder stack in f32 (f32 params, the embedding
    rows taken uncast): embed rows -> apply_decoder (each layer
    checkpointed unless no_remat) -> final norm -> head -> cross-entropy,
    and its grads over every leaf, against jax.value_and_grad of the same
    composition of the JAX package's functions. Blockwise attention in
    chunks of 16 over 32 tokens."""
    jax, jnp = ref.jax, ref.jnp
    from repro.models import layers as jl, transformer as jtr
    cfg = get_smoke_config(arch)
    jcfg = ref.get_smoke_config(arch)
    jparams, _ = random_params(ref, jcfg, seed=2)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    toks, labels = _tokens(cfg)
    jm = ref.Model(jcfg, attn_chunk=16)
    model = Model(cfg, attn_chunk=16)

    def jloss(p):
        x = p["embed"]["embedding"][jnp.asarray(toks)]
        x, _ = jtr.apply_decoder(jcfg, p["decoder"], x, jm._ctx({}, toks.shape[1]),
                                 no_remat=no_remat)
        x = jl.apply_norm(jcfg, p["final_norm"], x)
        return jl.cross_entropy(jl.lm_logits(jcfg, p["embed"], x), jnp.asarray(labels))

    def loss(p):
        x = p["embed"]["embedding"][torch.from_numpy(toks).long()]
        x, _ = tr.apply_decoder(cfg, p["decoder"], x, model._ctx(toks.shape[1], "cpu"),
                                no_remat=no_remat)
        x = layers.apply_norm(cfg, p["final_norm"], x)
        return layers.cross_entropy(layers.lm_logits(cfg, p["embed"], x),
                                    torch.from_numpy(labels))
    jl_, jg = jax.value_and_grad(jloss)(jparams)
    l_, g = _grads(loss, params)
    np.testing.assert_allclose(l_.item(), float(jl_), rtol=1e-5)
    for name, got, want in zip(_names(g), tree_leaves(g), _jleaves(jg)):
        assert got.dtype == torch.float32
        if name == "/embed/embedding" and cfg.tie_embeddings:
            # the head's share of a tied table's grad is rounded to the bf16
            # table's type on both sides (JAX casts the table to bf16 for the
            # head), so an f32 sum on either side of a rounding boundary
            # moves an element by one bf16 ulp of that share: 2**-8 of the
            # largest |value| at most, and the 99th percentile within 1e-4
            within_max(got, want, 2.0 ** -8, name)
            diff = np.abs(f32(got) - f32(want))
            assert np.percentile(diff, 99) <= 1e-4 * np.abs(f32(want)).max(), name
        else:
            within_max(got, want, 1e-4, name)


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{prefix}/{k}")]
    return [prefix]


@pytest.mark.parametrize("arch,no_remat", [pytest.param(ARCH, False, id="False"),
                                           pytest.param(ARCH, True, id="True")]
                         + [pytest.param(a, False, id=f"{a}-False") for a in DENSE])
def test_model_loss_and_grads_match_jax_bf16(ref, arch, no_remat):
    """Model.loss (bf16 params and activations) with and without remat, and
    its grads over every leaf (bf16 leaves get bf16 grads, f32 leaves f32),
    against jax.value_and_grad of the JAX Model.loss; remat and no_remat
    give the same loss and grads in the port."""
    jax, jnp = ref.jax, ref.jnp
    cfg = get_smoke_config(arch)
    jcfg = ref.get_smoke_config(arch)
    jparams, nparams = random_params(ref, jcfg, seed=3)
    params = params_from_jax(nparams, "cpu")
    toks, labels = _tokens(cfg, seed=22)
    jm = ref.Model(jcfg, attn_chunk=16)
    model = Model(cfg, attn_chunk=16)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jm.loss(p, jbatch, no_remat=no_remat), has_aux=True)(jparams)
    loss, g = _grads(lambda p: model.loss(p, batch, no_remat=no_remat)[0], params)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-2)
    for name, got, want, p in zip(_names(g), tree_leaves(g), _jleaves(jg),
                                  tree_leaves(params)):
        assert got.dtype == p.dtype, name
        within_max(got.float(), want, 2.0 ** -4, name)
    other, g2 = _grads(lambda p: model.loss(p, batch, no_remat=not no_remat)[0], params)
    assert torch.equal(other, loss)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g), tree_leaves(g2)))


def test_remat_policy_is_not_ported_yet():
    """LMS policies run the dense stack (tests/test_torch_lms.py) and now
    the Mamba-2 stack too: under a policy that recomputes every activation,
    and under one that keeps its two tagged classes (`ssd_xz` offloaded,
    `ssd_state` saved), the loss and every grad equal the checkpointed
    resident run's bitwise (tests/test_torch_ssm_serve.py holds the
    streamed step)."""
    from repro_torch.core.lms.policies import Policy
    cfg = get_smoke_config("mamba2-1.3b")
    model = Model(cfg)
    params = model.init(0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)))
    batch = {"tokens": toks, "labels": toks}
    want, gwant = _grads(lambda p: model.loss(p, batch)[0], params)
    stack = params["decoder"]["stack0"]
    for policy in (Policy(), Policy(saved=frozenset({"ssd_state"}),
                                    offloaded=frozenset({"ssd_xz"}))):
        grads = tree_map(torch.zeros_like, stack)
        leaves = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
        got = model.loss(leaves, batch, policy=policy, stack_grads=grads)[0]
        # the stack's grads go to `grads` (the executor's sink), not autograd
        g = torch.autograd.grad(got, tree_leaves(leaves), allow_unused=True)
        assert torch.equal(got.detach(), want)
        for a, b in zip(g, tree_leaves(gwant)):
            assert a is None or torch.equal(a, b)
        for a, b in zip(tree_leaves(grads), tree_leaves(gwant["decoder"]["stack0"])):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the train step and the trainer
# ---------------------------------------------------------------------------

def _check_masters(state, jstate, lr, n):
    """Every master weight within 2 lr n of JAX's, the median within 0.01
    lr n and the 99th percentile within 0.1 lr n (see the module's note)."""
    ref = jax_ref()
    diff = np.concatenate([
        np.abs(g.numpy() - f32(w)).ravel() for g, w in zip(
            tree_leaves(state.opt.master),
            _jleaves(ref.jax.tree.map(np.asarray, jstate.opt.master)))])
    unit = lr * n
    assert diff.max() <= 2 * unit + 1e-6, diff.max() / unit
    assert np.median(diff) <= 0.01 * unit, np.median(diff) / unit
    assert np.percentile(diff, 99) <= 0.1 * unit, np.percentile(diff, 99) / unit
    # each param is its master copy cast to the param's dtype
    for p, mp in zip(tree_leaves(state.params), tree_leaves(state.opt.master)):
        assert torch.equal(p, mp.to(p.dtype))


@pytest.mark.parametrize("arch,m", [pytest.param(ARCH, 1, id="1"), pytest.param(ARCH, 2, id="2")]
                         + [pytest.param(a, 1, id=f"{a}-1") for a in DENSE])
def test_train_step_matches_jax_over_3_steps(ref, jmods, arch, m):
    """build_train_step against the JAX package's on a 1x1 mesh, from one
    state (random params, converted by train_state_from_jax), over 3 steps
    of the synthetic stream with m microbatches: loss, ce, grad norm and
    lr each step, then the master weights and params."""
    jax, jnp = ref.jax, ref.jnp
    lr = 1e-3
    jt, tt = _tcfgs(jmods, arch, learning_rate=lr, warmup_steps=0, total_steps=10,
                    microbatches=m)
    jparams, _ = random_params(ref, jt.model, seed=5)
    js = jmods["steps"]
    jstate = js.TrainState(jnp.zeros((), jnp.int32), jparams,
                           jmods["adamw"].adamw_init(jparams))
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    jstep, _, _ = js.build_train_step(ref.Model(jt.model), jt, ref.mesh())
    step = build_train_step(Model(tt.model), tt)
    data = SyntheticTokens(tt.model.vocab_size, seed=3)
    for i in range(3):
        b = data.batch(i, 0, 1, 4, 16)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, met = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert set(met) == set(jmet) == {"loss", "grad_norm", "lr", "ce", "aux"}
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=2e-3,
                                       err_msg=f"{k}, step {i + 1}")
        np.testing.assert_allclose(met["lr"].item(), float(jmet["lr"]), rtol=1e-6)
        assert met["aux"].item() == float(jmet["aux"]) == 0.0
        assert int(state.step) == int(jstate.step) == i + 1
    _check_masters(state, jstate, lr, 3)


def test_train_step_rejects_what_is_not_ported(jmods):
    _, tt = _tcfgs(jmods)
    model = Model(tt.model)
    # zero1 builds now (its own step: tests/test_torch_zero1.py); so does
    # the replicated step under tensor parallelism (tests/test_torch_tp_*.py),
    # but zero1 under it does not
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.steps import build_zero1_train_step
    zero1 = dataclasses.replace(tt, ddl=dataclasses.replace(tt.ddl, mode="zero1"))
    build_zero1_train_step(model, zero1)
    tp_mesh = MeshSpec((1, 2), ("data", "model"))
    assert callable(build_train_step(model, dataclasses.replace(tt, mesh=tp_mesh),
                                     mesh=Mesh(tp_mesh, rank=0)))
    with pytest.raises(NotImplementedError, match="zero1 under tensor parallelism"):
        build_zero1_train_step(model, dataclasses.replace(zero1, mesh=tp_mesh))
    # a mesh of several devices needs one process per device
    # (tests/test_torch_ddl_train.py, tests/test_torch_tp_train.py)
    for dims in ((2, 1), (1, 2)):
        with pytest.raises(ValueError, match="mesh of 2 devices"):
            build_train_step(model, dataclasses.replace(tt, mesh=MeshSpec(dims, ("data", "model"))))
    from repro_torch.core.lms.planner import MemoryPlan
    from repro_torch.train import steps as tsteps
    # grads on the host with the optimizer on the device: no streamed sweep
    # to read sunk grads back, so the grads stay on the device (as in the
    # JAX package) and the step builds; params on the host with the
    # optimizer on the device is not ported yet
    grads_host = MemoryPlan({}, {"params": "device", "grads": "host", "optimizer": "device",
                                 "kvcache": "device"}, 1, 1, 1, 1, True)
    assert not tsteps._grads_host(grads_host)
    build_train_step(model, tt, plan=grads_host)
    params_host = MemoryPlan({}, {"params": "host", "grads": "device", "optimizer": "device",
                                  "kvcache": "device"}, 1, 1, 1, 1, True)
    with pytest.raises(NotImplementedError, match="optimizer state on the device"):
        build_train_step(model, tt, plan=params_host)
    with pytest.raises(ValueError, match="does not divide"):
        _microbatch_split({"tokens": torch.zeros((3, 4))}, 2)


def test_trainer_matches_jax_trainer(ref, jmods, tmp_path):
    """The port's Trainer.train against the JAX package's, both with LMS
    off on one device, from JAX's initial state handed to the port's
    trainer: the same synthetic batches, and per step the same loss, ce,
    grad norm and lr within the train step's bounds; with log_every 2 the
    rows come in the same order; the history series and step histogram
    fill."""
    jax = ref.jax
    jt, tt = _tcfgs(jmods, learning_rate=1e-3, warmup_steps=1, total_steps=3, log_every=2,
                    checkpoint_dir=str(tmp_path))
    jtrainer = jmods["trainer"].Trainer(jt)
    jinit = jax.tree.map(np.asarray, jtrainer.init_state())
    _, jhist = jtrainer.train(steps=3)
    trainer = Trainer(dataclasses.replace(tt, checkpoint_dir=None), device="cpu")
    trainer.init_state = lambda: train_state_from_jax(jinit, "cpu")
    seen = []
    state, hist = trainer.train(steps=3, on_step=lambda s, row: seen.append(s))
    assert seen == [1, 2, 3] and [r["step"] for r in hist] == [1, 2, 3]
    for row, jrow in zip(hist, jhist):
        assert set(row) == set(jrow)
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(row[k], jrow[k], rtol=2e-3, err_msg=k)
        np.testing.assert_allclose(row["lr"], jrow["lr"], rtol=1e-6)
        assert row["aux"] == jrow["aux"] == 0.0
    assert hist[0]["lr"] == 0.0 and int(state.step) == 3
    assert len(trainer.obs.registry.series("train.history")) == 3
    assert trainer.obs.registry.histogram("train.step_s").count == 3


def test_trainer_rejects_lms_and_needs_a_device_here(jmods):
    """LMS trains on one device (tests/test_torch_lms.py), with microbatches
    too (tests/test_torch_microbatches.py); a tensor-parallel mesh trains
    on its ranks (tests/test_torch_tp_lms.py), with LMS or without, and in
    one process it raises for the ranks it lacks; zero1 under it is not
    ported yet."""
    _, tt = _tcfgs(jmods, checkpoint_dir=None)
    trainer = Trainer(dataclasses.replace(tt, lms=LMSConfig(), microbatches=2), device="cpu")
    assert trainer.plan is not None
    tp_mesh = MeshSpec((1, 2), ("data", "model"))
    for lms in (LMSConfig(), LMSConfig(enabled=False)):
        with pytest.raises(ValueError, match="mesh of 2 devices"):
            Trainer(dataclasses.replace(tt, lms=lms, microbatches=2, mesh=tp_mesh),
                    device="cpu")
    with pytest.raises(NotImplementedError, match="zero1 under tensor parallelism"):
        from repro_torch.train.steps import build_zero1_train_step
        build_zero1_train_step(Model(tt.model), dataclasses.replace(
            tt, mesh=tp_mesh, ddl=dataclasses.replace(tt.ddl, mode="zero1")))
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here; the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(tt)


def test_train_state_from_jax_is_exact(ref, jmods):
    jax = ref.jax
    jt, tt = _tcfgs(jmods)
    jstate = jmods["steps"].init_train_state(ref.Model(jt.model), jt, jax.random.key(0))
    nstate = jax.tree.map(np.asarray, jstate)
    state = train_state_from_jax(nstate, "cpu")
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    for tree, jtree in ((state.params, nstate.params), (state.opt.mu, nstate.opt.mu),
                        (state.opt.master, nstate.opt.master)):
        for g, w in zip(tree_leaves(tree), _jleaves(jtree)):
            assert np.array_equal(g.float().numpy(), f32(w))
    assert tree_leaves(state.opt.master)[0].dtype == torch.float32


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

ARGS = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
        "--seq", "16"]


def test_launch_train_on_cpu(capsys, tmp_path, monkeypatch, arch=ARCH):
    """The CLI trains 3 steps of `--arch <id> --smoke` and prints the JAX
    launcher's step lines, its final-loss line and the metrics summary
    (of a fresh process-wide registry); --log writes the history."""
    from repro_torch.obs import trace
    monkeypatch.setattr(trace, "_default", None)
    log = tmp_path / "hist.json"
    args = ARGS[:1] + [arch] + ARGS[2:]
    assert launch.main(args + ["--no-lms", "--log", str(log),
                               "--ckpt-dir", str(tmp_path / "ckpt")]) == 0
    out = capsys.readouterr().out.splitlines()
    steps = [line for line in out if line.startswith("step ")]
    assert [line.split("|")[0].split()[1] for line in steps] == ["1", "2", "3"]
    assert any(line.startswith("final loss: ") for line in out)
    assert "train.history: 3 rows" in out
    import json
    hist = json.loads(log.read_text())
    assert [r["step"] for r in hist] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in hist)


@pytest.mark.parametrize("arch", DENSE)
def test_launch_train_on_cpu_dense(capsys, tmp_path, monkeypatch, arch):
    """`test_launch_train_on_cpu` with `--arch` each other dense config."""
    test_launch_train_on_cpu(capsys, tmp_path, monkeypatch, arch)


@pytest.mark.parametrize("flags", [["--mesh", "2x1", "--microbatches", "2", "--ckpt-dir", "c"],
                                   ["--no-lms", "--ddl-mode", "zero1", "--mesh", "1x1x2"],
                                   ["--no-lms", "--mesh", "1x1x2"],
                                   ["--no-lms", "--supervise"],
                                   ["--no-lms", "--fault-step", "1"],
                                   ["--no-lms", "--heartbeat-dir", "hb"],
                                   ["--microbatches", "2", "--supervise"],
                                   ["--no-lms", "--spike-action", "stop"],
                                   ["--no-lms", "--ckpt-every", "5"],
                                   ["--no-lms", "--mesh", "2x1", "--microbatches", "2",
                                    "--trace", "t.json"]])
def test_launch_train_rejects_what_is_not_ported(flags):
    """zero1 under tensor parallelism (a model axis above 1) is what the
    CLI does not run yet, and it is rejected for that alone beside any
    other flags, before any rank starts: tensor parallelism
    (tests/test_torch_tp_lms.py runs it under torchrun), LMS on a mesh of
    several ranks (tests/test_torch_lms_ddl.py), microbatches with LMS or
    on a mesh (tests/test_torch_microbatches.py), zero1 without tensor
    parallelism (tests/test_torch_zero1.py), and the checkpoint,
    supervision, drill, heartbeat, telemetry and export flags
    (tests/test_torch_runtime.py, test_torch_supervisor.py) are ported
    and named nowhere in the error."""
    with pytest.raises(NotImplementedError) as err:
        launch.main(ARGS + flags + ["--mesh", "1x2", "--ddl-mode", "zero1"])
    assert str(err.value) == ("zero1 under tensor parallelism (a 'model' axis above 1) "
                              "is not ported yet")
