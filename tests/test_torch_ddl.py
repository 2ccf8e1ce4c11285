"""The port's DDL pieces against the JAX package, on the CPU: the dequantize
kernel's plain version and dispatch, compress/decompress, pack/unpack and
bucketing, the topology time model, and on 4 gloo ranks against the JAX
package on a (2, 2) ("pod", "data") mesh of emulated devices: the
hierarchical schedule on a flat bucket, the compressed pod all-reduce with
and without error feedback, the tree reduction (a leaf scattered along
dim 0, one along dim 1, one with no dimension divisible by |data|, a bf16
leaf; with and without compression and EF; the flat baseline) and the
bucketed reduction of the overlapped backward's hook.

Tolerances. Dequantize, compress and decompress are bitwise: the same f32
products, casts and (for the scale) the multiply by the f32 reciprocal of
127 that XLA compiles `amax / 127.0` into. The topology model is the same
float arithmetic: equal floats. The collectives are bitwise too: every sum
in the DDL schedule adds two ranks' values (|data| = |pod| = 2), or sums
the pods from an f32 zero in pod order, and a sum of two floats does not
depend on its order. Only the flat baseline adds four ranks' values in one
all-reduce, whose order XLA and gloo choose each their own: it is held to
1e-6 of the largest |value|.

Each side runs in its own processes: JAX with
XLA_FLAGS=--xla_force_host_platform_device_count=4, the port as 4
processes that join one gloo group through a file under the test's
tmp_path (no TCP port, so parallel test workers cannot collide).
"""
import dataclasses
import datetime
import importlib
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tests.test_torch_ref import jax_ref, jax_ref_scope  # noqa: F401 (autouse fixture)

from repro_torch import hw
from repro_torch.config.base import DDLConfig, MeshSpec
from repro_torch.core.ddl import allreduce, topology
from repro_torch.kernels.quantize import dequantize, dequantize_ref, dequantize_sum_rows_ref

# the module (the package exports its function `compress` under that name)
comp = importlib.import_module("repro_torch.core.ddl.compress")
REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
MESH = ((2, 2), ("pod", "data"))


def bits(a):
    """An array's bit pattern, for bitwise comparison (f32 or bf16 as f32)."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.float32))
    return a.view(np.int32)


# ---------------------------------------------------------------------------
# processes: the JAX side on emulated devices, the port's ranks over gloo
# ---------------------------------------------------------------------------

def _env(devices=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO / "src"), str(REPO)])
    env["OMP_NUM_THREADS"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return env


def start_jax(module: str, fn: str, out_dir, devices: int):
    """Start `module.fn(out_dir)` in a fresh Python with `devices` emulated
    JAX devices."""
    code = f"import sys; from {module} import {fn} as f; f(sys.argv[1])"
    return [subprocess.Popen([sys.executable, "-c", code, str(out_dir)], cwd=REPO,
                             env=_env(devices), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)]


def start_ranks(module: str, fn: str, out_dir, world: int):
    """Start `module.fn(rank, world, out_dir)` in `world` fresh Pythons."""
    code = (f"import sys; from {module} import {fn} as f; "
            "f(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])")
    return [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), str(out_dir)],
                             cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True) for r in range(world)]


def wait_all(procs, timeout: float):
    """Wait for every process, each within what is left of `timeout`
    seconds; on a failure or the timeout kill them all and fail."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            outs.append(out)
            assert p.returncode == 0, f"process failed (rc {p.returncode}):\n{out}\n{err}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def init_gloo(rank: int, world: int, out_dir):
    """Join the gloo group of `world` ranks through a file in out_dir."""
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"file://{pathlib.Path(out_dir) / 'pg'}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))


# ---------------------------------------------------------------------------
# dequantize, compress, packing, topology (one process)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    return jax_ref()


def _codes(rows, cols, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (rows, cols)).astype(np.int8)
    s = (rng.uniform(1e-3, 3, rows) * rng.choice([1, 1e-20, 1e20], rows)).astype(np.float32)
    s[0] = 1.0                      # an all-zero row's scale
    q[0] = 0
    return q, s


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols", [(37, 64), (5, 1024), (3, 7), (130, 48)])
def test_dequantize_matches_jax_bitwise(ref, rows, cols, out_dtype):
    """dequantize_ref and dequantize on CPU tensors against the JAX
    package's dequantize_fwd (interpret mode) and, for f32, its
    dequantize_ref, at ragged shapes and scales of very different sizes."""
    jnp = ref.jnp
    q, s = _codes(rows, cols, seed=rows * cols)
    tdt = getattr(torch, out_dtype)
    want = ref.q_kernel.dequantize_fwd(jnp.asarray(q), jnp.asarray(s),
                                       out_dtype=getattr(jnp, out_dtype), interpret=True)
    tq, ts = torch.from_numpy(q), torch.from_numpy(s)
    for got in (dequantize_ref(tq, ts, tdt), dequantize(tq, ts, tdt)):
        assert got.dtype == tdt and tuple(got.shape) == (rows, cols)
        assert np.array_equal(bits(got.float()), bits(np.asarray(want, np.float32)))
    if out_dtype == "float32":
        assert np.array_equal(bits(dequantize(tq, ts)), bits(ref.q_ref.dequantize_ref(q, s)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 1000, 3 * 1024, 5000])
def test_compress_decompress_match_jax_bitwise(ref, n, dtype):
    """compress against jax.jit(compress) (codes and scales), decompress
    against the JAX decompress, for n not a multiple of the 1024-element
    row too (the last row padded with zeros)."""
    jax, jnp = ref.jax, ref.jnp
    from repro.core.ddl.compress import compress as jcompress, decompress as jdecompress
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jax.jit(jcompress)(jx)
    q, s = comp.compress(tx)
    assert q.dtype == torch.int8 and tuple(q.shape) == (-(-n // 1024), 1024)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(bits(s), bits(js))
    for out in ("float32", "bfloat16"):
        want = jax.jit(jdecompress, static_argnums=(2, 3))(jq, js, n, getattr(jnp, out))
        got = comp.decompress(q, s, n, getattr(torch, out))
        assert got.dtype == getattr(torch, out) and got.shape == (n,)
        assert np.array_equal(bits(got.float()), bits(np.asarray(want, np.float32)))


class _Pods:
    """A mesh of len(parts) pods in one process: all_gather returns every
    pod's codes (int8) or scales (f32), as the pod hop's gather would."""

    def __init__(self, parts):
        self.parts = parts

    def size(self, axis):
        return len(self.parts)

    def all_gather(self, t, axis):
        return torch.cat([q if t.dtype == torch.int8 else s for q, s in self.parts])


def _pod_hops(ref, xs):
    """The compressed pod hop over two pods' flat f32 gradients xs [2, n]
    in both packages, emulated in one process: the JAX package's
    `compressed_allreduce_pod` jitted under vmap over the pod axis, and the
    port's with a two-pod stand-in for the mesh. -> (port's sum on each
    pod, JAX's [2, n], the port's (codes, scales) of each pod)."""
    jax, jnp = ref.jax, ref.jnp
    from repro.core.ddl.compress import compressed_allreduce_pod as jax_pod_hop
    want = np.asarray(jax.jit(jax.vmap(lambda x: jax_pod_hop(x, "pod")[0],
                                       axis_name="pod"))(jnp.asarray(xs)))
    mesh = _Pods([comp.compress(torch.from_numpy(x)) for x in xs])
    got = [comp.compressed_allreduce_pod(torch.from_numpy(x), "pod", mesh=mesh)[0].numpy()
           for x in xs]
    return got, want, mesh.parts


def test_pod_hop_hides_a_nan_gradient_in_both_packages(ref):
    """A NaN in one pod's gradient does not survive the compressed pod hop
    in either package: its row quantizes to scale 1 with code 0 for the
    NaN (the other values rounded to integers), so the sum is finite, and
    so is the grad norm taken after the reduction: it hides the step that
    made the NaN. An infinity does not hide: its row quantizes to scale inf
    with codes 0, and 0 * inf dequantizes to NaN over the whole 1024-value
    row, in both packages. The port agrees with the JAX package within the
    FMA bound of test_compressed_collectives_match_jax, NaN for NaN."""
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((2, 3000)).astype(np.float32)
    xs[0, 5] = np.nan                      # pod 0, row 0 of 1024
    xs[1, 1500] = np.nan                   # pod 1, row 1
    got, want, parts = _pod_hops(ref, xs)
    assert np.array_equal(bits(got[0]), bits(got[1]))        # both pods hold the same sum
    for total in (got[0], want[0], want[1]):
        assert np.isfinite(total).all() and np.isfinite(np.linalg.norm(total))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2.0 ** -21 * np.abs(want[0]).max())
    (q0, s0), (q1, s1) = parts
    assert s0[0] == 1.0 and q0[0, 5] == 0 and s1[1] == 1.0 and q1[1, 1500 - 1024] == 0
    assert np.array_equal(bits(got[0][:1024]),                 # pod 0's NaN row at scale 1
                          bits(q0[0].float().numpy() + comp.decompress(q1, s1, 1024).numpy()))

    xs[0, 2500] = np.inf                   # pod 0, row 2: the infinity poisons its row
    got, want, parts = _pod_hops(ref, xs)
    q0, s0 = parts[0]
    assert s0[2] == float("inf") and not q0[2].any()
    for total in (got[0], want[0]):
        assert np.isnan(total[2048:]).all() and np.isfinite(total[:2048]).all()
        assert np.isnan(np.linalg.norm(total))
    np.testing.assert_allclose(got[0], want[0], rtol=0,
                               atol=2.0 ** -21 * np.abs(want[0][:2048]).max())


@pytest.mark.parametrize("pods", [2, 4])
@pytest.mark.parametrize("n", [3000, 5000])
def test_pod_sum_matches_the_composition_and_jax(ref, pods, n):
    """`dequantize_sum_rows`' plain version on `pods` pods' codes and scales
    (n not a multiple of the 1024-element row) against the pod hop's loop
    as it was composed (an f32 zero, then each pod's `decompress` added in
    pod order): bitwise; the port's pod hop, which calls it, gives the same
    bits on every pod. Against the JAX package's `compressed_allreduce_pod`
    (jitted under vmap over the pod axis), where XLA:CPU contracts each
    product into its add as an FMA (ROADMAP 3.7): the two chains of `pods`
    products and adds each round every step to within half an ulp of a
    partial sum no larger than sum_p |q_p s_p|, so they lie within pods
    ulps (2**-23 relative) of that sum, element by element."""
    jax, jnp = ref.jax, ref.jnp
    from repro.core.ddl.compress import compressed_allreduce_pod as jax_pod_hop
    rng = np.random.default_rng(pods * n)
    xs = (rng.standard_normal((pods, n)) * rng.uniform(0.1, 10, (pods, 1))).astype(np.float32)
    parts = [comp.compress(torch.from_numpy(x)) for x in xs]
    qg = torch.stack([q for q, _ in parts])
    sg = torch.stack([s for _, s in parts])
    got = dequantize_sum_rows_ref(qg, sg, n)
    total = torch.zeros(n)
    for q, s in parts:
        total = total + comp.decompress(q, s, n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert np.array_equal(bits(got), bits(total))
    mesh = _Pods(parts)
    for x in xs:
        hop, _ = comp.compressed_allreduce_pod(torch.from_numpy(x), "pod", mesh=mesh)
        assert np.array_equal(bits(hop), bits(got))
    want = np.asarray(jax.jit(jax.vmap(lambda x: jax_pod_hop(x, "pod")[0],
                                       axis_name="pod"))(jnp.asarray(xs)))
    terms = sum(np.abs(comp.decompress(q, s, n).numpy()) for q, s in parts)
    for w in want:
        assert np.all(np.abs(got.numpy() - w) <= pods * 2.0 ** -23 * terms)


class _Echo:
    """A mesh of `pods` pods in one process whose all_gather gives this
    pod's tensor for every pod."""

    def __init__(self, pods):
        self.pods = pods

    def size(self, axis):
        return self.pods

    def all_gather(self, t, axis):
        return torch.cat([t] * self.pods)


def test_pod_hop_makes_one_pod_sum_launch_a_slice(monkeypatch):
    """The compressed pod hop with its int8 entries routed as on the card
    (`on_cpu` False, the plain versions standing in for the kernels) and
    2048-element slices: a shard of 5000 elements (3 slices) launches the
    quantizer and the pod sum once a slice and the dequantizer never; with
    error feedback the dequantizer once a slice too. The mean and the new
    EF are the plain run's, bitwise."""
    from tests.test_torch_kernels import _QuantizeExtension
    from repro_torch.kernels import _build
    from repro_torch.kernels.quantize import ops as q_ops
    monkeypatch.setattr(allreduce, "POD_SLICE", 2048)
    rng = np.random.default_rng(2)
    shard = torch.from_numpy(rng.standard_normal(5000).astype(np.float32))
    ef = torch.from_numpy(rng.standard_normal(5000).astype(np.float32) * 1e-2)
    kw = dict(mesh=_Echo(2), pod_axis="pod", compress_dcn=True, mean_over=2)

    def reduce(with_ef):
        out = torch.empty(5000)
        new_ef = allreduce._pod_reduce_(shard, out, error_feedback=ef if with_ef else None, **kw)
        return out, new_ef
    plain = [reduce(False), reduce(True)]
    ext = _QuantizeExtension()
    monkeypatch.setattr(_build, "extension", lambda: ext)
    monkeypatch.setattr(q_ops, "on_cpu", lambda *tensors: False)
    launchers = (q_ops.quantize_cuda, q_ops.dequantize_sum_rows_cuda, q_ops.dequantize_cuda)
    for with_ef, (want, want_ef) in zip((False, True), plain):
        for launcher in launchers:
            monkeypatch.setattr(launcher, "launches", 0)
        out, new_ef = reduce(with_ef)
        assert [launcher.launches for launcher in launchers] == [3, 3, 3 if with_ef else 0]
        assert np.array_equal(bits(out), bits(want))
        assert (new_ef is None) == (want_ef is None)
        if with_ef:
            assert np.array_equal(bits(new_ef), bits(want_ef))
    assert [e[0] for e in ext.launches].count("dequantize_sum_rows") == 6


def test_compress_in_pod_slices_equals_the_whole_leaf():
    """The pod hop compresses a shard in POD_SLICE = 2**24-element slices:
    2**24 is a multiple of the row, so the slices' codes and scales are the
    whole shard's, here on a shard of 2**24 + 3000 elements."""
    assert allreduce.POD_SLICE == 1 << 24 and allreduce.POD_SLICE % comp._ROW == 0
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(allreduce.POD_SLICE + 3000).astype(np.float32))
    q, s = comp.compress(x)
    parts = [comp.compress(x[i:i + allreduce.POD_SLICE])
             for i in range(0, x.numel(), allreduce.POD_SLICE)]
    assert torch.equal(q, torch.cat([p[0] for p in parts]))
    assert torch.equal(s, torch.cat([p[1] for p in parts]))
    n = x.numel()
    whole = comp.decompress(q, s, n)
    sliced = torch.cat([comp.decompress(pq, ps, min(allreduce.POD_SLICE, n - i))
                        for (pq, ps), i in zip(parts, range(0, n, allreduce.POD_SLICE))])
    assert torch.equal(whole, sliced)


def _mixed_tree(lib):
    """A tree of mixed dtypes with a scalar leaf, on either side."""
    if lib == "torch":
        return {"w": torch.arange(15.0).reshape(5, 3),
                "b": {"scale": torch.tensor(3.5),
                      "h": torch.arange(6.0).reshape(2, 3).to(torch.bfloat16)},
                "v": torch.arange(4.0).to(torch.float16)}
    jnp = lib
    return {"w": jnp.arange(15.0, dtype=jnp.float32).reshape(5, 3),
            "b": {"scale": jnp.float32(3.5),
                  "h": jnp.arange(6.0, dtype=jnp.bfloat16).reshape(2, 3)},
            "v": jnp.arange(4.0, dtype=jnp.float16)}


def test_pack_unpack_and_buckets_match_jax(ref):
    """pack_spec/pack/unpack on a tree of mixed dtypes with a scalar leaf
    and padding (the cases of the JAX package's DDL tests): the same flat
    f32 vector as JAX's, and back to the same leaves; make_buckets gives
    JAX's buckets for its edge cases and for random sizes."""
    from repro.core.ddl import allreduce as jall
    tree, jtree = _mixed_tree("torch"), _mixed_tree(ref.jnp)
    spec, jspec = allreduce.pack_spec(tree, pad_to=8), jall.pack_spec(jtree, pad_to=8)
    assert (spec.total, spec.padded, spec.sizes) == (jspec.total, jspec.padded, jspec.sizes)
    assert spec.total == 15 + 1 + 6 + 4 and spec.padded % 8 == 0
    flat = allreduce.pack(tree, spec)
    assert flat.dtype == torch.float32 and flat.shape == (spec.padded,)
    assert np.array_equal(bits(flat), bits(jall.pack(jtree, jspec)))
    out = allreduce.unpack(flat, spec)
    for path in (("w",), ("b", "scale"), ("b", "h"), ("v",)):
        a, b = tree, out
        for k in path:
            a, b = a[k], b[k]
        assert b.dtype == a.dtype and b.shape == a.shape and torch.equal(a, b), path
    mb = allreduce.make_buckets
    assert mb([], 1024) == [] and mb([10 ** 9], 1024) == [[0]]
    assert mb([10 ** 9, 1, 1], 1024) == [[0], [1, 2]]
    assert mb([1, 1, 1, 10, 1], 3) == [[0, 1, 2], [3], [4]]
    rng = np.random.default_rng(1)
    for _ in range(20):
        sizes = [int(s) for s in rng.integers(1, 50, rng.integers(0, 30))]
        cap = int(rng.integers(1, 120))
        assert mb(sizes, cap) == jall.make_buckets(sizes, cap)


def test_topology_model_matches_jax(ref):
    """The ring time model over the port's H100 spec against the JAX
    package's over a JAX HardwareSpec holding the same values: equal floats;
    the hierarchical schedule beats the flat ring and compression shortens
    it, as the paper's Fig. 1 argues."""
    from repro import hw as jhw
    from repro.core.ddl import topology as jtop
    spec = jhw.HardwareSpec(**dataclasses.asdict(hw.H100_SXM))
    assert topology.AXIS_FABRIC == jtop.AXIS_FABRIC
    for nbytes in (1e6, 1e8, 4e8, 1e9):
        for data, pods in ((8, 1), (8, 2), (16, 2), (1, 4)):
            for c in (False, True):
                assert (topology.ddl_allreduce_time(nbytes, data, pods, c)
                        == jtop.ddl_allreduce_time(nbytes, data, pods, c, hw=spec))
            assert (topology.flat_allreduce_time(nbytes, (pods, data))
                    == jtop.flat_allreduce_time(nbytes, (pods, data), hw=spec))
        assert (topology.ddl_allreduce_time(nbytes, data=8, pods=2)
                < topology.flat_allreduce_time(nbytes, (2, 8)))
        assert (topology.ddl_allreduce_time(nbytes, 8, 2, compress_dcn=True)
                < topology.ddl_allreduce_time(nbytes, 8, 2))
    assert set(topology.fabrics()) == {"ici", "dcn", "host"}


# ---------------------------------------------------------------------------
# the collectives on 4 ranks against the JAX (2, 2) mesh
# ---------------------------------------------------------------------------

def _collective_inputs():
    """Per-rank inputs [WORLD, ...] from a numpy seed: rank r's are [r]."""
    rng = np.random.default_rng(7)

    def per_rank(*shape, scale=1.0):
        spread = rng.uniform(0.5, 4.0, (WORLD,) + (1,) * len(shape))
        return (rng.standard_normal((WORLD,) + shape) * spread * scale).astype(np.float32)
    return {
        "flat": per_rank(6000), "flat_ef": per_rank(3000, scale=0.01),
        "pod": per_rank(2500), "pod_ef": per_rank(2500, scale=0.01),
        # a: scattered along dim 0; b: along dim 1; c: no dim divisible by
        # |data| (plain psum); d: a bf16 leaf
        "tree/a": per_rank(6, 10), "tree/b": per_rank(3, 8), "tree/c": per_rank(5),
        "tree/d": per_rank(4, 6),
        # error feedback of each leaf's shard, flat: the JAX package's
        # ddl_reduce_leaf adds it to the flattened shard (a buffer of the
        # shard's shape, as its init_error_feedback makes, fails to
        # broadcast there; the port takes either)
        "tree_ef/a": per_rank(30, scale=0.01), "tree_ef/b": per_rank(12, scale=0.01),
        "tree_ef/c": per_rank(5, scale=0.01), "tree_ef/d": per_rank(12, scale=0.01),
        # bucket_mb=1 (262144 f32): a alone, then b and c together (13
        # elements, padded to |data|)
        "bucket/a": per_rank(600, 520), "bucket/b": per_rank(7), "bucket/c": per_rank(2, 3),
    }


TREE_KEYS = ("a", "b", "c", "d")
BUCKET_KEYS = ("a", "b", "c")
# case -> (DDLConfig kwargs) for the tree cases
TREE_CASES = {"tree_off": dict(), "tree_on": dict(compress_dcn=True),
              "tree_ef": dict(compress_dcn=True), "tree_flat": dict(topology_aware=False)}
BUCKET_CASES = {"bucketed_off": dict(bucket_mb=1),
                "bucketed_on": dict(bucket_mb=1, compress_dcn=True)}
# the port's cases with the pod hop cut into 2048-element slices, held to
# the JAX package's whole-leaf results
SLICED = {"tree_on_sliced": "tree_on", "bucketed_on_sliced": "bucketed_on"}


def _jax_collectives(out_dir):
    """The JAX package's side: every case on the (2, 2) mesh, each device's
    result stacked [WORLD, ...] into jax.npz."""
    from tests.test_torch_ref import jax_ref
    ref = jax_ref()
    jax, jnp = ref.jax, ref.jnp
    from jax.sharding import PartitionSpec as P
    from repro import compat
    from repro.config.base import DDLConfig as JDDL
    from repro.core.ddl import allreduce as jall, overlap as jov
    from repro.core.ddl.compress import compressed_allreduce_pod
    mesh = compat.make_mesh(*MESH)
    inp = _collective_inputs()
    dp = P(("pod", "data"))

    def run(fn, args):
        """fn(*per-device args) -> dict of arrays, on every device."""
        def body(*a):
            out = fn(*[x[0] for x in a])
            return {k: v[None] for k, v in out.items()}
        sm = compat.shard_map(body, mesh=mesh, in_specs=tuple(dp for _ in args),
                              out_specs=dp, check_vma=False, axis_names={"pod", "data"})
        return {k: np.asarray(v, np.float32) for k, v in jax.jit(sm)(*args).items()}

    res = {}
    kw = dict(data_axis="data", pod_axis="pod")
    for c in (False, True):
        out = run(lambda x: {"full": jall.hierarchical_allreduce_flat(
            x, compress_dcn=c, mean_over=4, **kw)[0]}, [jnp.asarray(inp["flat"])])
        res[f"hier_{'on' if c else 'off'}/full"] = out["full"]
    out = run(lambda x, e: dict(zip(("full", "ef"), jall.hierarchical_allreduce_flat(
        x, compress_dcn=True, error_feedback=e, mean_over=4, **kw))),
        [jnp.asarray(inp["flat"]), jnp.asarray(inp["flat_ef"])])
    res.update({f"hier_ef/{k}": v for k, v in out.items()})
    out = run(lambda x: {"sum": compressed_allreduce_pod(x, "pod")[0]},
              [jnp.asarray(inp["pod"])])
    res["pod/sum"] = out["sum"]
    out = run(lambda x, e: dict(zip(("sum", "ef"), compressed_allreduce_pod(
        x, "pod", error_feedback=e))), [jnp.asarray(inp["pod"]), jnp.asarray(inp["pod_ef"])])
    res.update({f"pod_ef/{k}": v for k, v in out.items()})

    def tree_in(prefix, keys):
        return [jnp.asarray(inp[f"{prefix}/{k}"],
                            jnp.bfloat16 if (prefix, k) == ("tree", "d") else jnp.float32)
                for k in keys]
    for case, cfg in TREE_CASES.items():
        ef = case == "tree_ef"

        def f(*a, cfg=cfg, ef=ef):
            tree = dict(zip(TREE_KEYS, a[:4]))
            red, new_ef = jall.ddl_reduce_tree(
                tree, JDDL(**cfg), data_size=2, pod_size=2,
                error_feedback=list(a[4:]) if ef else None, **kw)
            out = {k: red[k] for k in TREE_KEYS}
            if ef:
                out.update({f"ef_{k}": e for k, e in zip(TREE_KEYS, new_ef)})
            return out
        args = tree_in("tree", TREE_KEYS) + (tree_in("tree_ef", TREE_KEYS) if ef else [])
        res.update({f"{case}/{k}": v for k, v in run(f, args).items()})
    for case, cfg in BUCKET_CASES.items():
        def f(*a, cfg=cfg):
            return jov.reduce_tree_bucketed(dict(zip(BUCKET_KEYS, a)), JDDL(**cfg),
                                            data_size=2, pod_size=2, keep="full", **kw)
        res.update({f"{case}/{k}": v for k, v in run(f, tree_in("bucket", BUCKET_KEYS)).items()})
    np.savez(pathlib.Path(out_dir) / "jax.npz", **res)


def _port_collectives(rank, world, out_dir):
    """The port's side on one rank: every case, this rank's results into
    port_<rank>.npz."""
    from repro_torch.core.ddl import overlap
    from repro_torch.launch.mesh import make_mesh
    init_gloo(rank, world, out_dir)
    mesh = make_mesh(MeshSpec(*MESH))
    assert mesh.dp_index == rank and mesh.coords == {"pod": rank // 2, "data": rank % 2}
    inp = {k: torch.from_numpy(v[rank]) for k, v in _collective_inputs().items()}
    kw = dict(mesh=mesh, data_axis="data", pod_axis="pod")
    res = {}
    for c in (False, True):
        full, _ = allreduce.hierarchical_allreduce_flat(inp["flat"], compress_dcn=c,
                                                        mean_over=4, **kw)
        res[f"hier_{'on' if c else 'off'}/full"] = full
    full, ef = allreduce.hierarchical_allreduce_flat(
        inp["flat"], compress_dcn=True, error_feedback=inp["flat_ef"], mean_over=4, **kw)
    res.update({"hier_ef/full": full, "hier_ef/ef": ef})
    res["pod/sum"] = comp.compressed_allreduce_pod(inp["pod"], "pod", mesh=mesh)[0]
    s, ef = comp.compressed_allreduce_pod(inp["pod"], "pod", mesh=mesh,
                                          error_feedback=inp["pod_ef"])
    res.update({"pod_ef/sum": s, "pod_ef/ef": ef})

    def tree_in(prefix, keys):
        """Fresh leaves: ddl_reduce_tree reduces in place."""
        return {k: inp[f"{prefix}/{k}"].to(torch.bfloat16 if (prefix, k) == ("tree", "d")
                                           else torch.float32, copy=True) for k in keys}
    cases = dict(TREE_CASES, tree_on_sliced=TREE_CASES["tree_on"])
    for case, cfg in cases.items():
        ef = case == "tree_ef"
        allreduce.POD_SLICE = 2048 if case in SLICED else 1 << 24
        red, new_ef = allreduce.ddl_reduce_tree(
            tree_in("tree", TREE_KEYS), DDLConfig(**cfg), data_size=2, pod_size=2,
            error_feedback=list(tree_in("tree_ef", TREE_KEYS).values()) if ef else None,
            **kw)
        res.update({f"{case}/{k}": red[k] for k in TREE_KEYS})
        if ef:
            res.update({f"{case}/ef_{k}": e for k, e in zip(TREE_KEYS, new_ef)})
    cases = dict(BUCKET_CASES, bucketed_on_sliced=BUCKET_CASES["bucketed_on"])
    for case, cfg in cases.items():
        allreduce.POD_SLICE = 2048 if case in SLICED else 1 << 24
        red = overlap.reduce_tree_bucketed(tree_in("bucket", BUCKET_KEYS), DDLConfig(**cfg),
                                           data_size=2, pod_size=2, **kw)
        res.update({f"{case}/{k}": red[k] for k in BUCKET_KEYS})
    np.savez(pathlib.Path(out_dir) / f"port_{rank}.npz",
             **{k: v.float().numpy() for k, v in res.items()})


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    """Both sides' results: (JAX's {name: [WORLD, ...]}, [each rank's
    {name: array}])."""
    out = tmp_path_factory.mktemp("ddl_collectives")
    me = "tests.test_torch_ddl"
    procs = (start_jax(me, "_jax_collectives", out, devices=WORLD)
             + start_ranks(me, "_port_collectives", out, WORLD))
    wait_all(procs, timeout=240)
    jres = dict(np.load(out / "jax.npz"))
    ranks = [dict(np.load(out / f"port_{r}.npz")) for r in range(WORLD)]
    return jres, ranks


# the uncompressed schedule: sums of two ranks' values, bitwise; leaf c
# takes the plain psum even with compression on, and its EF passes through
BITWISE = (["hier_off/full"] + [f"tree_off/{k}" for k in TREE_KEYS]
           + [f"bucketed_off/{k}" for k in BUCKET_KEYS] + ["tree_on/c", "tree_ef/c",
                                                          "tree_ef/ef_c"])
# the compressed pod hop: sums of dequantized pods, and error feedback
COMPRESSED = (["hier_on/full", "hier_ef/full", "pod/sum", "pod_ef/sum"]
              + [f"{c}/{k}" for c in ("tree_on", "tree_ef") for k in "abd"]
              + [f"bucketed_on/{k}" for k in BUCKET_KEYS])
FEEDBACK = ["hier_ef/ef", "pod_ef/ef"] + [f"tree_ef/ef_{k}" for k in "abd"]


@pytest.mark.parametrize("name", BITWISE)
def test_collectives_match_jax_bitwise(collectives, name):
    """Each rank's result of the uncompressed DDL schedule equals the JAX
    device's at the same mesh coordinate, bit for bit."""
    jres, ranks = collectives
    for r in range(WORLD):
        assert ranks[r][name].shape == jres[name][r].shape, name
        assert np.array_equal(bits(ranks[r][name]), bits(jres[name][r])), (name, r)


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("name", COMPRESSED + FEEDBACK)
def test_compressed_collectives_match_jax(collectives, name):
    """The compressed pod hop against the JAX package's. The codes and
    scales are bitwise (test_compress_decompress_match_jax_bitwise), but
    XLA:CPU contracts a dequantize product into the add of the pod sum
    that follows it (and into the subtraction of the error feedback) as a
    fused multiply-add, which rounds once where the port's plain
    expression rounds the product first. That moves an element by at most
    an ulp of the larger of the product and the result: held within
    2**-21 of the largest |sum| (the products are of its size); error
    feedback x - q*s is ~1/254 of x, so within 2**-15 of its largest
    |value|; a bf16 leaf within one bf16 ulp of each element."""
    jres, ranks = collectives
    for r in range(WORLD):
        got, want = ranks[r][name], jres[name][r]
        assert got.shape == want.shape, name
        if name.endswith("/d"):
            assert np.all(np.abs(got - want) <= _bf16_ulp(want)), (name, r)
            continue
        tol = (2.0 ** -15 if name in FEEDBACK else 2.0 ** -21) * np.abs(want).max()
        err = np.abs(got - want).max()
        assert err <= tol, (name, r, err, tol)


@pytest.mark.parametrize("sliced,whole", sorted(SLICED.items()))
def test_pod_hop_in_slices_is_the_whole_leaf(collectives, sliced, whole):
    """The port with the pod hop cut into 2048-element slices against the
    same reduction in one piece: bitwise."""
    _, ranks = collectives
    keys = TREE_KEYS if whole.startswith("tree") else BUCKET_KEYS
    for r in range(WORLD):
        for k in keys:
            assert np.array_equal(bits(ranks[r][f"{sliced}/{k}"]),
                                  bits(ranks[r][f"{whole}/{k}"])), (sliced, k, r)


def test_flat_baseline_matches_jax(collectives):
    """topology_aware=False: one sum over all four ranks, in an order each
    side chooses; within 1e-6 of the largest |value| (bf16 leaf: 1 ulp)."""
    jres, ranks = collectives
    for k in TREE_KEYS:
        want = jres[f"tree_flat/{k}"]
        tol = (2.0 ** -8 if k == "d" else 1e-6) * np.abs(want).max()
        for r in range(WORLD):
            np.testing.assert_allclose(ranks[r][f"tree_flat/{k}"], want[r], rtol=0, atol=tol)


def test_collectives_leave_replicas_in_sync(collectives):
    """Every mean over the mesh is the same on every rank, bit for bit (as
    the replicas' grads must be, or their params drift apart). The pod
    hop alone sums over `pod` only, and error feedback is each rank's own
    residual."""
    _, ranks = collectives
    for name in ranks[0]:
        if name.startswith("pod") or "/ef" in name:
            continue
        for r in range(1, WORLD):
            assert np.array_equal(bits(ranks[r][name]), bits(ranks[0][name])), (name, r)
