"""The JAX reference for the port's parity tests (`jax_ref`, `random_params`),
and the tests of the weight converter and of the port's import boundary.

`jax_ref()` imports the JAX package on the CPU. Two things keep it
importable on the jax this suite runs with: `repro.compat` imports
`jax.sharding.TransferToMemoryKind`, which newer jax releases dropped, so a
stand-in returning the matching `jax.memory.Space` is installed first; and
newer XLA:CPU exposes a `pinned_host` memory kind, so `REPRO_MEMORY_KINDS=0`
keeps the JAX pool's host arena an ordinary array, as the JAX package's own
CPU runs assume. Both happen inside `jax_ref()` on its first call, never
while a test file is imported, so collecting this file changes nothing for
the JAX package's own test files. When a test file that used it is done,
the `jax_ref_scope` fixture undoes both and unloads the `repro` modules
`jax_ref()` brought in, so JAX test files that run later in the same
worker pass or fail as they would without the port's tests.

Inputs are made from a seed with numpy and fed to both sides.
"""
import ast
import math
import os
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]


_ENV_KEYS = ("JAX_PLATFORMS", "REPRO_MEMORY_KINDS")
# while jax_ref() is in force: its namespace, and what it changed
_state = {}


def jax_ref():
    """Import the JAX package on the CPU; -> a namespace of its modules."""
    if "ref" in _state:
        return _state["ref"]
    modules = set(sys.modules)
    env = {k: os.environ.get(k) for k in _ENV_KEYS}
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["REPRO_MEMORY_KINDS"] = "0"
    import jax
    import jax.sharding

    shimmed = not hasattr(jax.sharding, "TransferToMemoryKind")
    if shimmed:
        def transfer_to_memory_kind(kind):
            return (jax.memory.Space.Host if "host" in kind
                    else jax.memory.Space.Device)
        jax.sharding.TransferToMemoryKind = transfer_to_memory_kind
    _state.update(modules=modules, env=env, shimmed=shimmed)

    import jax.numpy as jnp
    from repro.config.base import MeshSpec
    from repro.configs import get_smoke_config
    from repro.kernels.flash_attention import decode_kernel, kernel as fa_kernel
    from repro.kernels.flash_attention import ref as fa_ref
    from repro.kernels.quantize import kernel as q_kernel, ref as q_ref
    from repro.launch import serve as launch_serve
    from repro.launch.mesh import make_mesh
    from repro.models import attention, kvquant, layers, paging
    from repro.models.model import Model
    from repro.serve import ServeEngine, synth_requests
    _state["ref"] = types.SimpleNamespace(
        jax=jax, jnp=jnp, get_smoke_config=get_smoke_config,
        decode_kernel=decode_kernel, fa_kernel=fa_kernel, fa_ref=fa_ref,
        launch_serve=launch_serve, q_kernel=q_kernel,
        q_ref=q_ref, attention=attention, kvquant=kvquant, layers=layers,
        paging=paging, Model=Model, ServeEngine=ServeEngine,
        synth_requests=synth_requests,
        mesh=lambda: make_mesh(MeshSpec((1, 1), ("data", "model"))))
    return _state["ref"]


def forget_jax_ref():
    """Undo jax_ref(): drop the stand-in, restore the environment, and
    unload every `repro` module imported since (detached from its parent
    package too, so `from repro import x` cannot find it either)."""
    if "modules" not in _state:
        return
    import jax.sharding
    if _state["shimmed"]:
        del jax.sharding.TransferToMemoryKind
    for key, val in _state["env"].items():
        if val is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = val
    for name in [m for m in sys.modules
                 if (m == "repro" or m.startswith("repro."))
                 and m not in _state["modules"]]:
        mod = sys.modules.pop(name)
        parent, _, child = name.rpartition(".")
        if getattr(sys.modules.get(parent), child, None) is mod:
            delattr(sys.modules[parent], child)
    _state.clear()


@pytest.fixture(scope="module", autouse=True)
def jax_ref_scope():
    """Autouse in every file that calls jax_ref(): undo it after the file."""
    yield
    forget_jax_ref()


@pytest.fixture
def jax_pricing(monkeypatch):
    """The port's planner without the working sets it prices where the
    JAX package's prices none (`planner.ssd_scan_work_bytes`,
    `planner.whole_prefill_bytes`, `planner.loss_work_bytes`), for a test
    that holds a plan to the JAX package's field by field."""
    from repro_torch.core.lms import planner
    monkeypatch.setattr(planner, "ssd_scan_work_bytes", lambda *a, **k: 0)
    monkeypatch.setattr(planner, "whole_prefill_bytes", lambda *a, **k: 0)
    monkeypatch.setattr(planner, "loss_work_bytes", lambda *a, **k: 0)


def random_params(ref, cfg, seed: int):
    """Random params for the JAX model of `cfg`, as (JAX tree, numpy tree).

    Weights are drawn with std 0.125 (about 1/sqrt(fan_in) at smoke width)
    rather than the init's 0.02, so attention is sharp and a wrong position,
    page or head shows in the output; biases are nonzero and norm scales
    vary around 1, so every parameter is exercised."""
    rng = np.random.default_rng(seed)
    defs = ref.Model(cfg).param_defs()
    is_def = lambda x: isinstance(x, ref.layers.ParamDef)

    def make(d):
        if d.init == "ones":
            a = 1.0 + 0.1 * rng.standard_normal(d.shape)
        elif d.init == "zeros":
            a = 0.1 * rng.standard_normal(d.shape)
        elif d.dtype == "float32":          # the embedding table
            a = rng.standard_normal(d.shape)
        else:
            a = 0.125 * rng.standard_normal(d.shape)
        return ref.jnp.asarray(a.astype(np.float32), dtype=d.dtype)

    jparams = ref.jax.tree.map(make, defs, is_leaf=is_def)
    return jparams, ref.jax.tree.map(np.asarray, jparams)


def smoke_cfg():
    from repro_torch.configs import get_smoke_config
    return get_smoke_config("qwen2.5-14b")


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    """Every registered config and its smoke config has the JAX package's
    fields; the JAX registry's other ids raise "not ported yet"."""
    import dataclasses
    from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
    ref = jax_ref()
    from repro.configs import get_config as jget_config
    assert ARCH_IDS == ("qwen2.5-14b", "olmo-1b", "starcoder2-7b", "qwen2-72b",
                        "mamba2-1.3b", "qwen3-moe-235b-a22b", "grok-1-314b")
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget_config(arch))
        assert (dataclasses.asdict(get_smoke_config(arch))
                == dataclasses.asdict(ref.get_smoke_config(arch)))
    for arch in ("recurrentgemma-9b", "qwen2-vl-2b", "whisper-tiny"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            get_config(arch)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "olmo-1b", "starcoder2-7b", "qwen2-72b",
                                  "mamba2-1.3b"])
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_param_defs_match_reference(arch, smoke):
    """The port's param defs (norms, MLP, attention, embedding: every
    ParamDef's shape, axes, init, scale and dtype) equal the JAX package's
    for every registered config, key for key; the published sizes of the
    dense configs."""
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import layers
    from repro_torch.models.model import Model
    ref = jax_ref()
    from repro.configs import get_config as jget_config
    cfg = (get_smoke_config if smoke else get_config)(arch)
    jcfg = (ref.get_smoke_config if smoke else jget_config)(arch)
    is_def = lambda x: isinstance(x, ref.layers.ParamDef)  # noqa: E731

    def fields(tree, leaf):
        if isinstance(tree, dict):
            return {k: fields(v, leaf) for k, v in tree.items()}
        assert leaf(tree), type(tree)
        return dataclasses.astuple(tree)
    for got, want in ((layers.norm_defs(cfg, cfg.d_model), ref.layers.norm_defs(jcfg,
                                                                                jcfg.d_model)),
                      (Model(cfg).param_defs(), ref.Model(jcfg).param_defs())):
        assert fields(got, layers.is_def) == fields(want, is_def)
    if cfg.family != "dense":
        return
    assert fields(layers.mlp_defs(cfg), layers.is_def) == fields(ref.layers.mlp_defs(jcfg),
                                                                 is_def)
    if not smoke:
        count = sum(math.prod(d.shape) for _, d in _def_leaves(Model(cfg).param_defs()))
        assert count == cfg.param_count()
        if arch == "olmo-1b":
            assert count == 1_176_764_416
        if arch == "qwen2-72b":     # the embedding, the head and the final norm
            rest = cfg.vocab_size * cfg.d_model * 2 + cfg.d_model
            assert rest == 2_491_424_768
            assert count - rest == cfg.num_layers * 877_684_736


def _def_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [pd for k, v in tree.items() for pd in _def_leaves(v, prefix + (k,))]
    return [(prefix, tree)]


def test_converter_is_exact_and_keeps_the_tree():
    from repro_torch.convert import params_from_jax
    from repro_torch.models.layers import DTYPES
    from repro_torch.tree import tree_map
    from repro_torch.models.model import Model
    ref = jax_ref()
    cfg = smoke_cfg()
    _, nparams = random_params(ref, cfg, seed=3)
    tparams = params_from_jax(nparams, "cpu")
    want = []
    tree_map(lambda d: want.append((d.shape, DTYPES[d.dtype])),
                  Model(cfg).param_defs())
    got = []

    def walk(t, n):
        if isinstance(t, dict):
            assert set(t) == set(n)
            for k in t:
                walk(t[k], n[k])
            return
        got.append((tuple(t.shape), t.dtype))
        back = t.float().numpy()
        assert np.array_equal(back, np.asarray(n).astype(np.float32))
    walk(tparams, nparams)
    assert sorted(map(str, got)) == sorted(map(str, want))


def test_converter_and_trees_keep_empty_subtrees():
    """olmo-1b's LayerNorms have no params (`{}` subtrees, as in the JAX
    package): `params_from_jax` and `train_state_from_jax` keep them, and
    `tree_unflatten` of a tree's own leaves, and `tree_map`, give them
    back; the leaves are exact."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_jax, train_state_from_jax
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
    ref = jax_ref()
    from repro.optim.adamw import adamw_init
    from repro.train.steps import TrainState
    jcfg = ref.get_smoke_config("olmo-1b")
    jparams, nparams = random_params(ref, jcfg, seed=4)
    params = params_from_jax(nparams, "cpu")

    def structure(t):
        return {k: structure(v) for k, v in t.items()} if isinstance(t, dict) else None
    want = structure(Model(get_smoke_config("olmo-1b")).param_defs())
    assert want["final_norm"] == {} and want["decoder"]["stack0"]["attn_0"]["ln2"] == {}
    assert structure(params) == structure(nparams) == want
    assert structure(tree_unflatten(params, tree_leaves(params))) == want
    assert structure(tree_map(lambda t: t, params)) == want
    jstate = ref.jax.tree.map(np.asarray, TrainState(ref.jnp.zeros((), ref.jnp.int32), jparams,
                                                     adamw_init(jparams)))
    state = train_state_from_jax(jstate, "cpu")
    for tree, jtree in ((state.params, jstate.params), (state.opt.mu, jstate.opt.mu),
                        (state.opt.master, jstate.opt.master)):
        assert structure(tree) == want
        for g, w in zip(tree_leaves(tree), ref.jax.tree.leaves(jtree)):
            assert np.array_equal(g.float().numpy(), np.asarray(w).astype(np.float32))


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
            elif node.level:
                yield "."          # relative imports are not used


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO).as_posix()
     for p in (REPO / "src" / "repro_torch").rglob("*.py")]
    + ["chip_smoke.py"]))
def test_port_imports_no_jax_and_no_reference(path):
    for mod in _imports(REPO / path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "."), (path, mod)


def test_engine_without_device_raises_here():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here; the default device is the card")
    from repro_torch.models.model import Model
    from repro_torch.serve import ServeEngine
    from repro_torch.launch import serve as launch
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(Model(smoke_cfg()), slots=2, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.main(["--arch", "qwen2.5-14b", "--smoke"])
