"""The resident overlapped backward's reductions on the DDL queue, on the
CPU: the train step with the overlapped backward (m = 1, keep "full",
compress_dcn off and on; m = 2, the sharded accumulator) and the zero1 step
with it, whose hooks hand each layer's grads to `ReductionQueue` instead of
reducing them inside the backward.

- Queued against inline, bitwise: each variant on 2 and 4 gloo ranks, at
  1 and 2 layers, with each layer recomputed in the backward (remat) and
  without, 3 steps from one init, once as built and once with
  `ReductionQueue.put` patched to reduce the layer at once, in the
  backward (`_inline_put`): the metrics and every state leaf bit for bit
  (the same buckets, the same sums in the same order).
- On the queue: exactly L puts a pass (the recompute reruns no
  reduction), every layer reduced on the `ddl-reduce` thread, and no
  collective on the main thread between the step's first put and its
  drain (a spy on `Mesh.psum`, `psum_scatter` and `all_gather`); the
  inline runs reduce on the main thread.
- Against the JAX package's `build_train_step` / `build_zero1_train_step`
  on the (2, 2) ("pod", "data") mesh of 4 emulated devices, from one random
  state, at the tolerances of tests/test_torch_ddl_train.py and
  tests/test_torch_zero1.py, for their reasons: loss, ce and grad norm
  within 2e-3 relative; after 3 steps every master weight within 2 lr N of
  JAX's, the median within 0.01 lr N, the 99th percentile within 0.1 lr N.
- Failures: a reduction that raises surfaces from the step, and the next
  step equals a fresh run's; a backward that raises after some puts leaves
  no open queue and no worker behind, and the next step equals a fresh
  run's.

Inputs: the qwen2.5-14b smoke config (d_model 64, bf16 but for the f32
embedding table), cut to 1 layer or kept at its 2; 3 steps of 8 x 16
tokens of the synthetic stream, each rank on its own rows.
"""
import dataclasses
import json
import pathlib
import threading

import numpy as np
import pytest
import torch

from tests.test_torch_ddl import bits, init_gloo, start_jax, start_ranks, wait_all
from tests.test_torch_ddl_train import _rel, _wait_for, flat_tree, save_state, state_from_npz
from tests.test_torch_ref import jax_ref, jax_ref_scope  # noqa: F401 (autouse fixture)
from tests.test_torch_zero1 import _jax_state, load_zero1, save_zero1

from repro_torch.config import base as tb
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import Model
from repro_torch.tree import tree_leaves

ARCH = "qwen2.5-14b"
STEPS, BATCH, SEQ, LR = 3, 8, 16, 1e-3
# the ("pod", "data") mesh of each world: 4 ranks on (2, 2); on 2 ranks the
# full-mode variants take 2 pods (the pod hop), the sharded ones 2 data ranks
MESH4 = ((2, 2), ("pod", "data"))
MESH2 = {"full": ((2, 1), ("pod", "data")), "shard": ((1, 2), ("pod", "data"))}
# name -> (ddl mode, compress_dcn, microbatches, keep)
VARIANTS = {"full": ("allreduce", False, 1, "full"),
            "full_compress": ("allreduce", True, 1, "full"),
            "sharded_accumulator": ("allreduce", True, 2, "shard"),
            "zero1": ("zero1", True, 1, "shard")}
CASES = [(world, name, layers, remat) for world in (2, 4) for name in VARIANTS
         for layers in (1, 2) for remat in (True, False)]
FAILURE_VARIANTS = ("full_compress", "zero1")
ME = "tests.test_torch_ddl_queue"


def _case_id(case):
    world, name, layers, remat = case
    return f"{world}ranks-{name}-{layers}layers-remat_{'on' if remat else 'off'}"


def _batches(vocab):
    from repro_torch.data import SyntheticTokens
    data = SyntheticTokens(vocab, seed=3)
    return [data.batch(i, 0, 1, BATCH, SEQ) for i in range(STEPS)]


def _inline_put(self, i, grads, dst):
    """ReductionQueue.put with the layer reduced at once, in the backward
    (a test-only stand-in for the worker thread)."""
    self._step.count += 1
    self._reduce_into(i, grads, dst, self._step.squares, self._step.accumulate)


class _NoRemat(Model):
    """The model with no recompute boundary around its layers."""

    def loss(self, params, batch, **kw):
        return super().loss(params, batch, no_remat=True, **kw)


# ---------------------------------------------------------------------------
# the JAX side: each variant at 2 layers on the (2, 2) mesh
# ---------------------------------------------------------------------------

def _jax_tcfg(jb, cfg, name):
    mode, c, m, _ = VARIANTS[name]
    return jb.TrainConfig(
        model=cfg, shape=jb.ShapeConfig("t", "train", SEQ, BATCH), mesh=jb.MeshSpec(*MESH4),
        lms=jb.LMSConfig(enabled=False),
        ddl=jb.DDLConfig(mode=mode, compress_dcn=c, overlap_grads=True),
        learning_rate=LR, warmup_steps=0, total_steps=10, microbatches=m)


def _jax_side(out_dir):
    from tests.test_torch_ref import random_params
    ref = jax_ref()
    jax, jnp = ref.jax, ref.jnp
    from repro.config import base as jb
    from repro.launch.mesh import make_mesh
    from repro.optim.adamw import adamw_init
    from repro.train import steps as js
    out = pathlib.Path(out_dir)
    cfg = ref.get_smoke_config(ARCH)
    jparams, _ = random_params(ref, cfg, seed=11)
    init = js.TrainState(jnp.zeros((), jnp.int32), jparams, adamw_init(jparams))
    save_state(out / "init.npz", jax.tree.map(np.asarray, init))
    zinit = _jax_state(ref, jparams, True, 2)
    save_zero1(out / "init_zero1.npz", jax.tree.map(np.asarray, zinit))
    mesh = make_mesh(jb.MeshSpec(*MESH4))
    res = {}
    for name in VARIANTS:
        tcfg = _jax_tcfg(jb, cfg, name)
        if name == "zero1":
            step, state_sh, batch_sh, _ = js.build_zero1_train_step(ref.Model(cfg), tcfg, mesh,
                                                                    donate=False)
            state = jax.device_put(zinit, state_sh)
        else:
            step, state_sh, batch_sh = js.build_train_step(ref.Model(cfg), tcfg, mesh,
                                                           donate=False, overlap_grads=True)
            state = jax.device_put(init, state_sh)
        for i, b in enumerate(_batches(cfg.vocab_size)):
            state, met = step(state, jax.device_put(
                {k: jnp.asarray(v) for k, v in b.items()}, batch_sh))
            for k in ("loss", "ce", "grad_norm", "lr"):
                res[f"{name}/{k}/{i}"] = np.float32(met[k])
        if name == "zero1":
            res["zero1/master"] = np.asarray(state.master)
        else:
            res.update({f"{name}/master/{k}": v for k, v in
                        flat_tree(jax.tree.map(np.asarray, state.opt.master)).items()})
    np.savez(out / "jax_steps.npz", **res)


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------

def _tcfg(name, mesh, layers=2):
    mode, c, m, _ = VARIANTS[name]
    cfg = dataclasses.replace(get_smoke_config(ARCH), num_layers=layers)
    return tb.TrainConfig(model=cfg, shape=tb.ShapeConfig("t", "train", SEQ, BATCH),
                          mesh=tb.MeshSpec(*mesh), lms=tb.LMSConfig(enabled=False),
                          ddl=tb.DDLConfig(mode=mode, compress_dcn=c, overlap_grads=True),
                          learning_rate=LR, warmup_steps=0, total_steps=10, microbatches=m,
                          checkpoint_dir=None)


def _build(model, tcfg, mesh):
    from repro_torch.train import steps as tsteps
    if tcfg.ddl.mode == "zero1":
        return tsteps.build_zero1_train_step(model, tcfg, mesh=mesh)
    return tsteps.build_train_step(model, tcfg, mesh=mesh)


def _init(model, tcfg, mesh):
    from repro_torch.train import steps as tsteps
    if tcfg.ddl.mode == "zero1":
        return tsteps.init_zero1_state(model, tcfg, 5, "cpu", mesh.size("data"),
                                       data_index=mesh.index("data"))
    return tsteps.init_train_state(model, tcfg, 5, "cpu")


def _leaves(state):
    """Every tensor of a TrainState or Zero1State, in a fixed order."""
    if hasattr(state, "opt"):
        o = state.opt
        return [state.step, o.step] + [x for t in (state.params, o.mu, o.nu, o.master)
                                       for x in tree_leaves(t)]
    return [state.step, state.mu, state.nu, state.master] + tree_leaves(state.params)


def _same_bits(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape and np.array_equal(
        bits(x.float().numpy()), bits(y.float().numpy())) for x, y in zip(a, b))


class _Spy:
    """Records, for the port's ranks: the puts of each step, the thread of
    every layer's reduction (`GradReduceHook.reduce`), and every collective
    with its thread and whether the step's queue window was open (from its
    first put to its drain)."""

    def __init__(self):
        from repro_torch.core.ddl import overlap
        from repro_torch.launch.mesh import Mesh
        self.put_impl = overlap.ReductionQueue.put
        self.saved = {"put": overlap.ReductionQueue.put, "drain": overlap.ReductionQueue.drain,
                      "reduce": overlap.GradReduceHook.reduce,
                      **{n: getattr(Mesh, n) for n in ("psum", "psum_scatter", "all_gather")}}
        self.puts, self.reduce_threads, self.collectives = 0, [], []
        self.window = False
        spy = self

        def put(q, i, grads, dst):
            spy.puts += 1
            spy.window = True
            return spy.put_impl(q, i, grads, dst)

        def drain(q, layers):
            spy.window = False
            return spy.saved["drain"](q, layers)

        def reduce(hook, ct):
            spy.reduce_threads.append(threading.current_thread().name)
            return spy.saved["reduce"](hook, ct)

        def collective(name):
            def run(mesh, *a, **k):
                spy.collectives.append((name, threading.current_thread().name, spy.window))
                return spy.saved[name](mesh, *a, **k)
            return run
        overlap.ReductionQueue.put, overlap.ReductionQueue.drain = put, drain
        overlap.GradReduceHook.reduce = reduce
        for n in ("psum", "psum_scatter", "all_gather"):
            setattr(Mesh, n, collective(n))

    def inline(self, on: bool):
        self.put_impl = _inline_put if on else self.saved["put"]

    def reset(self):
        self.puts, self.reduce_threads, self.collectives = 0, [], []
        self.window = False


def _run(spy, model, tcfg, mesh, batches, *, inline=False, state=None):
    """A step a batch from the port's init (or `state`) -> (metrics, state,
    facts of the run: puts a step, the reductions' threads, the
    collectives' threads in and out of the queue window)."""
    spy.inline(inline)
    step = _build(model, tcfg, mesh)
    state = _init(model, tcfg, mesh) if state is None else state
    mets, puts = [], []
    spy.reset()
    for b in batches:
        before = spy.puts
        state, met = step(state, b)
        puts.append(spy.puts - before)
        mets.append({k: v.item() for k, v in met.items()})
    main = threading.main_thread().name
    facts = {"puts": puts, "reduce_threads": sorted(set(spy.reduce_threads)),
             "reductions": len(spy.reduce_threads),
             "main_in_window": sum(t == main and w for _, t, w in spy.collectives),
             "worker_collectives": sum(t == "ddl-reduce" for _, t, _ in spy.collectives),
             "main_collectives": sum(t == main for _, t, _ in spy.collectives),
             "queue_idle": step.queue._step is None,
             "workers_alive": sum(t.name == "ddl-reduce" for t in threading.enumerate())}
    spy.inline(False)
    return mets, state, facts


def _local(mesh, batches):
    from repro_torch.data import local_rows
    return [{k: torch.from_numpy(v) for k, v in local_rows(b, mesh.dp_index,
                                                          mesh.dp_size).items()}
            for b in batches]


def _queued_vs_inline(spy, world):
    """Every case of `world` ranks: queued and inline from one init."""
    from repro_torch.launch.mesh import make_mesh
    res = {}
    meshes = {}
    for w, name, layers, remat in CASES:
        if w != world:
            continue
        spec = MESH4 if world == 4 else MESH2[VARIANTS[name][3]]
        if spec not in meshes:
            meshes[spec] = make_mesh(tb.MeshSpec(*spec))
        mesh = meshes[spec]
        tcfg = _tcfg(name, spec, layers)
        model = (Model if remat else _NoRemat)(tcfg.model)
        batches = _local(mesh, _batches(tcfg.model.vocab_size))
        q_mets, q_state, q_facts = _run(spy, model, tcfg, mesh, batches)
        i_mets, i_state, i_facts = _run(spy, model, tcfg, mesh, batches, inline=True)
        res[_case_id((w, name, layers, remat))] = {
            "bitwise": q_mets == i_mets and _same_bits(_leaves(q_state), _leaves(i_state)),
            "finite": all(np.isfinite(m["loss"]) for m in q_mets),
            "queued": q_facts, "inline": i_facts}
    return res


def _port_main(rank, world, out_dir):
    """This rank's cases (the queued-vs-inline matrix; on 4 ranks the
    steps from JAX's init, on 2 the failure drills) into
    port_<world>_<rank>.json."""
    from repro_torch.convert import zero1_state_from_jax
    from repro_torch.launch.mesh import make_mesh
    out = pathlib.Path(out_dir) / f"world{world}"
    init_gloo(rank, world, out)
    spy = _Spy()
    res = {"cases": _queued_vs_inline(spy, world)}
    if world == 4:
        mesh = make_mesh(tb.MeshSpec(*MESH4))
        cfg = get_smoke_config(ARCH)
        batches = _local(mesh, _batches(cfg.vocab_size))
        _wait_for(out.parent / "init_zero1.npz")
        steps = {}
        for name in VARIANTS:
            tcfg = _tcfg(name, MESH4)
            state = (zero1_state_from_jax(load_zero1(out.parent / "init_zero1.npz"), "cpu",
                                          mesh.index("data"), 2)
                     if name == "zero1" else state_from_npz(out.parent / "init.npz"))
            mets, state, _ = _run(spy, Model(cfg), tcfg, mesh, batches, state=state)
            for i, m in enumerate(mets):
                steps.update({f"{name}/{k}/{i}": m[k] for k in ("loss", "ce", "grad_norm", "lr")})
            if name == "zero1":
                steps["zero1/master"] = state.master.numpy()
            else:
                steps.update({f"{name}/master/{k}": v
                              for k, v in flat_tree(state.opt.master).items()})
            steps.update({f"{name}/params/{k}": v for k, v in flat_tree(state.params).items()})
        np.savez(out.parent / f"port_steps_{rank}.npz", **steps)
    else:
        res["failures"] = {name: _failures(spy, name) for name in FAILURE_VARIANTS}
    (out.parent / f"port_{world}_{rank}.json").write_text(json.dumps(res))


def _failures(spy, name):
    """(1) a reduction raising at the first layer put, on every rank, then
    the next step; (2) a backward raising at layer 0's put, after layer 1
    was put, then the next step: each against a fresh run's step 1."""
    from repro_torch.core.ddl import overlap
    from repro_torch.launch.mesh import make_mesh
    spec = MESH2[VARIANTS[name][3]]
    mesh = make_mesh(tb.MeshSpec(*spec))
    tcfg = _tcfg(name, spec)
    model = Model(tcfg.model)
    batches = _local(mesh, _batches(tcfg.model.vocab_size))[:1]
    fresh_mets, fresh_state, _ = _run(spy, model, tcfg, mesh, batches)
    out = {}

    reduce_into = overlap.ReductionQueue._reduce_into

    def failing_reduce(q, i, *a, **k):
        raise ValueError(f"reduction of layer {i}")

    def failing_put(q, i, grads, dst):
        if i == 0:
            raise ValueError("backward of layer 0")
        return spy.saved["put"](q, i, grads, dst)

    for drill in ("reduction", "backward"):
        step = _build(model, tcfg, mesh)
        state = _init(model, tcfg, mesh)
        before = _leaves(state)
        before = [t.clone() for t in before]
        if drill == "reduction":
            overlap.ReductionQueue._reduce_into = failing_reduce
        else:
            spy.put_impl = failing_put
        err = None
        try:
            step(state, batches[0])
        except ValueError as e:
            err = str(e)
        finally:
            overlap.ReductionQueue._reduce_into = reduce_into
            spy.inline(False)
        left = {"queue_idle": step.queue._step is None,
                "workers_alive": sum(t.name == "ddl-reduce" for t in threading.enumerate()),
                "state_untouched": _same_bits(before, _leaves(state))}
        mets, state, facts = _run(spy, model, tcfg, mesh, batches, state=state)
        out[drill] = {"error": err, **left, "next_equals_fresh": mets == fresh_mets
                      and _same_bits(_leaves(state), _leaves(fresh_state)),
                      "next_puts": facts["puts"]}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX side (4 emulated devices), 4 ranks and 2 ranks, at once."""
    out = tmp_path_factory.mktemp("ddl_queue")
    for world in (2, 4):
        (out / f"world{world}").mkdir()
    procs = (start_jax(ME, "_jax_side", out, devices=4)
             + start_ranks(ME, "_port_main", out, 4) + start_ranks(ME, "_port_main", out, 2))
    wait_all(procs, timeout=420)
    return out


def _ranks(out, world):
    return [json.loads((out / f"port_{world}_{r}.json").read_text()) for r in range(world)]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_queued_equals_inline_bitwise(runs, case):
    """The step with its reductions on the queue against the same step
    reducing each layer inline in the backward, 3 steps from one init:
    metrics and every state leaf bit for bit on every rank."""
    for r, res in enumerate(_ranks(runs, case[0])):
        got = res["cases"][_case_id(case)]
        assert got["bitwise"] and got["finite"], (r, got)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_reductions_run_on_the_queue_thread(runs, case):
    """Exactly L puts a pass (L x m a step; remat reruns no reduction),
    every layer reduced on the ddl-reduce thread and none inline, no
    collective on the main thread between the first put and the drain, the
    queue drained and its worker gone after each step; the inline run
    reduces every layer on the main thread."""
    world, name, layers, _ = case
    m = VARIANTS[name][2]
    for r, res in enumerate(_ranks(runs, world)):
        q, i = res["cases"][_case_id(case)]["queued"], res["cases"][_case_id(case)]["inline"]
        assert q["puts"] == i["puts"] == [layers * m] * STEPS, (r, q, i)
        assert q["reduce_threads"] == ["ddl-reduce"] and q["reductions"] == layers * m * STEPS
        assert q["main_in_window"] == 0 and q["worker_collectives"] > 0, (r, q)
        assert q["main_collectives"] > 0          # the rest's and the metrics'
        assert q["queue_idle"] and q["workers_alive"] == 0, (r, q)
        assert i["reduce_threads"] == [threading.main_thread().name], (r, i)
        assert i["worker_collectives"] == 0 and i["reductions"] == layers * m * STEPS


def _masters(res, name):
    if name == "zero1":
        return [res["zero1/master"]]
    return [res[k] for k in sorted(res) if k.startswith(f"{name}/master/")]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_queued_step_matches_jax(runs, name):
    """The queued step on 4 ranks of the (2, 2) mesh from JAX's initial
    state against the JAX package's step (overlapped backward): per step
    loss, ce, grad norm and lr; after 3 steps the master weights; every
    rank's params and masters the same."""
    jres = dict(np.load(runs / "jax_steps.npz"))
    ranks = [dict(np.load(runs / f"port_steps_{r}.npz")) for r in range(4)]
    for i in range(STEPS):
        for k, tol in (("loss", 2e-3), ("ce", 2e-3), ("grad_norm", 2e-3), ("lr", 1e-6)):
            key = f"{name}/{k}/{i}"
            for r in range(4):
                assert _rel(ranks[r][key], jres[key]) <= tol, (key, r, ranks[r][key], jres[key])
    if name == "zero1":
        # each rank holds its block of the global flat master
        got = np.concatenate([ranks[r]["zero1/master"] for r in (0, 1)])
        diff = np.abs(got - jres["zero1/master"])
    else:
        diff = np.concatenate([np.abs(a - b).ravel() for a, b in
                               zip(_masters(ranks[0], name), _masters(jres, name))])
    unit = LR * STEPS
    assert diff.max() <= 2 * unit + 1e-6, diff.max() / unit
    assert np.median(diff) <= 0.01 * unit, np.median(diff) / unit
    assert np.percentile(diff, 99) <= 0.1 * unit, np.percentile(diff, 99) / unit
    for k in ranks[0]:
        if k.startswith(f"{name}/params/"):
            for r in range(1, 4):
                assert np.array_equal(bits(ranks[r][k]), bits(ranks[0][k])), (k, r)


@pytest.mark.parametrize("name", FAILURE_VARIANTS)
def test_reduction_error_surfaces_and_next_step_is_clean(runs, name):
    """A reduction raising on every rank surfaces from the step, with the
    state untouched and the queue closed; the next step equals a fresh
    run's first step bit for bit."""
    for r, res in enumerate(_ranks(runs, 2)):
        got = res["failures"][name]["reduction"]
        assert got["error"] and "reduction of layer 1" in got["error"], (r, got)
        assert got["queue_idle"] and got["workers_alive"] == 0 and got["state_untouched"]
        assert got["next_equals_fresh"] and got["next_puts"] == [2], (r, got)


@pytest.mark.parametrize("name", FAILURE_VARIANTS)
def test_backward_error_leaves_no_open_queue(runs, name):
    """A backward raising after layer 1 was put: the step raises the
    backward's error, abandons the queue (no open step, no worker left,
    the state untouched), and the next step equals a fresh run's first
    step bit for bit."""
    for r, res in enumerate(_ranks(runs, 2)):
        got = res["failures"][name]["backward"]
        assert got["error"] == "backward of layer 0", (r, got)
        assert got["queue_idle"] and got["workers_alive"] == 0 and got["state_untouched"]
        assert got["next_equals_fresh"] and got["next_puts"] == [2], (r, got)
