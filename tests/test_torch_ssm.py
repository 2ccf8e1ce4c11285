"""The port's Mamba-2 forward and loss path against the JAX package: the
SSD chunked scan's plain version, the SSM block, the gated RMSNorm, the
cross-entropy, and `Model.forward`/`loss` on the mamba2-1.3b smoke config
(2 layers, d_model 64, 8 SSM heads of 16, state 16, chunk 16) and on the
qwen2.5-14b smoke config, with params converted from the JAX side.

Tolerances. The scan runs in f32 and agrees within 1e-5 of the largest
|y|: both sides take the chunk's prefix sums of dt * A in another order
(torch.cumsum, jnp.cumsum), so each decay exp(cum_i - cum_j) carries an
error of a few f32 ulps of |cum|; at these sizes the measured difference
is under 2e-6 of max |y|. f32 functions agree within 1e-5. The model runs
in bf16 and the two frameworks round bf16 intermediates at different
places, so logits are held within 2**-5 of the largest |value| (the
convention of test_torch_model.py) and the loss within 1%.

The CUDA kernel itself runs only on the card (`python3 chip_smoke.py`);
here its launcher's checks are tested, which run before any build.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_ref import (jax_ref, jax_ref_scope,  # noqa: F401 (autouse fixture)
                                  random_params)

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref, ssd_scan_ref
from repro_torch.models import layers, ssm
from repro_torch.models.model import Model
from repro_torch.tree import tree_map

ARCH = "mamba2-1.3b"


def f32(x):
    return np.asarray(x).astype(np.float32)


def within_max(got, want, tol, what=""):
    """max |got - want| <= tol * max |want|."""
    got, want = f32(got), f32(want)
    err = np.abs(got - want).max()
    bound = tol * max(np.abs(want).max(), 1e-6)
    assert err <= bound, f"{what}: max |diff| {err} > {bound}"


def bf16_ulp_of_max(want):
    """One bf16 ulp (8 significand bits) at the largest |want|."""
    top = max(float(np.abs(f32(want)).max()), 1e-30)
    return 2.0 ** (np.floor(np.log2(top)) - 7)


def scan_inputs(b, l, h, p, g, n, seed):
    """Inputs with the model's ranges: dt = softplus(normal) > 0 and
    A = -uniform[1, 16], as exp of the `ssm_a` init gives it."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -rng.uniform(1.0, 16.0, h).astype(np.float32)
    B = rng.standard_normal((b, l, g, n)).astype(np.float32)
    C = rng.standard_normal((b, l, g, n)).astype(np.float32)
    return x, dt, A, B, C


def trained_dt(b, l, h, seed):
    """dt in a trained Mamba-2's range: a level per (batch row, head), log-
    uniform on [1e-3, 1e-1] (the range Mamba-2 draws dt_bias from), times
    exp(N(0, 0.5**2)) per position. Over a chunk of 16 the state then keeps
    exp(cum_last) ~ 1e-3 .. 1 of itself, where softplus(normal) keeps < 1e-5."""
    rng = np.random.default_rng(seed)
    level = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, 1, h)))
    return (level * np.exp(0.5 * rng.standard_normal((b, l, h)))).astype(np.float32)


def scan_without_decayed_state(x, dt, A, B, C, chunk):
    """The scan with a planted fault: each chunk hands on its own
    contribution S alone, the older state exp(cum_last) * h dropped.
    Chunk c's rows are the scan's over chunks c-1 and c from a zero state.
    -> (y, the last chunk's S: the faulty h_final)."""
    q = min(chunk, x.shape[1])
    ys = []
    for c0 in range(0, x.shape[1], q):
        a, e = max(c0 - q, 0), c0 + q
        ys.append(ssd_scan_ref(x[:, a:e], dt[:, a:e], A, B[:, a:e], C[:, a:e],
                               chunk=q)[0][:, c0 - a:])
    h = ssd_scan_ref(x[:, c0:], dt[:, c0:], A, B[:, c0:], C[:, c0:], chunk=q)[1]
    return torch.cat(ys, dim=1), h


@pytest.fixture(scope="module")
def ref():
    return jax_ref()


@pytest.fixture(scope="module")
def jssd(ref):
    from repro.kernels.ssd_scan import kernel, ref as sref
    return kernel, sref


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l,chunk,g", [
    (64, 16, 1),    # l a multiple of the chunk
    (64, 16, 2),
    (40, 16, 1),    # a ragged last chunk
    (40, 16, 2),
    (10, 16, 1),    # l < chunk: the chunk is l
    (10, 16, 2),
])
def test_ssd_scan_plain_matches_jax_f32(ref, jssd, l, chunk, g):
    kernel, sref = jssd
    ins = scan_inputs(2, l, 4, 16, g, 16, seed=l + g)
    y, h_final = ssd_scan_ref(*map(torch.from_numpy, ins), chunk=chunk)
    jins = [ref.jnp.asarray(a) for a in ins]
    jy_kernel = kernel.ssd_scan_fwd(*jins, chunk=chunk, interpret=True)
    jy, jh = sref.ssd_scan_ref(*jins, chunk=chunk)
    assert y.shape == (2, l, 4, 16) and y.dtype == torch.float32
    assert h_final.shape == (2, 4, 16, 16) and h_final.dtype == torch.float32
    within_max(y, jy_kernel, 1e-5, "y vs ssd_scan_fwd(interpret=True)")
    within_max(y, jy, 1e-5, "y vs ssd_scan_ref")
    within_max(h_final, jh, 1e-5, "h_final vs ssd_scan_ref")


@pytest.mark.parametrize("l,chunk,g", [
    (64, 16, 1),    # four whole chunks
    (64, 16, 2),
    (40, 16, 1),    # two whole chunks and a ragged one
    (40, 16, 2),
])
def test_ssd_scan_plain_carries_state_across_chunks(ref, jssd, l, chunk, g):
    """With dt in a trained model's range the state carried into each chunk
    shows in y and h_final, and the port still agrees with ssd_scan_fwd
    (interpret=True) and ssd_scan_ref within 1e-5 of max |y| (|h_final|).
    The scan with exp(cum_last) * h dropped from what each chunk hands on
    lies above 1e-2 of it, so the tolerance sees that term (with
    softplus(normal) dt it is ~0, and such a fault passes the cases above)."""
    kernel, sref = jssd
    x, _, A, B, C = scan_inputs(2, l, 4, 16, g, 16, seed=100 + l + g)
    ins = (x, trained_dt(2, l, 4, seed=200 + l + g), A, B, C)
    tins = [torch.from_numpy(a) for a in ins]
    y, h_final = ssd_scan_ref(*tins, chunk=chunk)
    jins = [ref.jnp.asarray(a) for a in ins]
    jy_kernel = kernel.ssd_scan_fwd(*jins, chunk=chunk, interpret=True)
    jy, jh = sref.ssd_scan_ref(*jins, chunk=chunk)
    within_max(y, jy_kernel, 1e-5, "y vs ssd_scan_fwd(interpret=True)")
    within_max(y, jy, 1e-5, "y vs ssd_scan_ref")
    within_max(h_final, jh, 1e-5, "h_final vs ssd_scan_ref")
    y_bad, h_bad = scan_without_decayed_state(*tins, chunk)
    assert np.abs(f32(y_bad) - f32(jy)).max() > 1e-2 * np.abs(f32(jy)).max()
    assert np.abs(f32(h_bad) - f32(jh)).max() > 1e-2 * np.abs(f32(jh)).max()


def test_ssd_scan_plain_keeps_bf16_and_an_initial_state(ref, jssd):
    """bf16 inputs come back as bf16 (the f32 result rounded once), and h0
    carries into the first chunk, as in the JAX oracle."""
    _, sref = jssd
    ins = scan_inputs(1, 24, 2, 16, 1, 16, seed=7)
    h0 = np.random.default_rng(8).standard_normal((1, 2, 16, 16)).astype(np.float32)
    bf = [torch.from_numpy(a) for a in ins]
    bf[0], bf[3], bf[4] = (t.bfloat16() for t in (bf[0], bf[3], bf[4]))
    y, hf = ssd_scan_ref(*bf, chunk=16, h0=torch.from_numpy(h0))
    jins = [ref.jnp.asarray(a, ref.jnp.bfloat16 if i in (0, 3, 4) else None)
            for i, a in enumerate(ins)]
    jy, jh = sref.ssd_scan_ref(*jins, chunk=16, h0=ref.jnp.asarray(h0))
    assert y.dtype == torch.bfloat16
    # one bf16 ulp of the largest |y|: the two f32 results round apart at most there
    assert np.abs(y.float().numpy() - f32(jy)).max() <= bf16_ulp_of_max(jy)
    within_max(hf, jh, 1e-5, "h_final")


# ---------------------------------------------------------------------------
# the plain model of the tensor-core route
# ---------------------------------------------------------------------------

CHUNKED_CASES = [
    # (l, chunk, g, dt)
    (40, 16, 1, "softplus"),    # a ragged last chunk
    (10, 16, 1, "softplus"),    # l < chunk
    (64, 16, 2, "softplus"),    # 2 groups
    (64, 16, 1, "trained"),     # the state carried across chunks shows
    (40, 16, 2, "trained"),
    (100, 32, 1, "trained"),
]


def _chunked_inputs(l, chunk, g, dt_kind):
    x, dt, A, B, C = scan_inputs(2, l, 4, 16, g, 16, seed=l + g)
    if dt_kind == "trained":
        dt = trained_dt(2, l, 4, seed=300 + l)
    return x, dt, A, B, C


def _per_head_max(y):
    """max |y| over each (batch row, head): [b, h]."""
    return np.abs(f32(y)).max(axis=(1, 3))


@pytest.mark.parametrize("l,chunk,g,dt_kind", CHUNKED_CASES)
def test_ssd_scan_chunked_model_matches_jax_f32(ref, jssd, l, chunk, g, dt_kind):
    """The three-step model of the tensor-core route (ssd_scan_chunked_ref,
    with its hi + lo operands) in f32 against the JAX ssd_scan_ref and
    ssd_scan_fwd(interpret=True): within 2e-5 of each (batch, head)'s max
    |y| (the hi + lo pair keeps ~16 bits of the three f32 operands: ~1e-5
    of the terms, which cancel only partly)."""
    kernel, sref = jssd
    ins = _chunked_inputs(l, chunk, g, dt_kind)
    y = ssd_scan_chunked_ref(*map(torch.from_numpy, ins), chunk=chunk)
    jins = [ref.jnp.asarray(a) for a in ins]
    assert y.shape == (2, l, 4, 16) and y.dtype == torch.float32
    for name, want in (("ssd_scan_fwd(interpret=True)",
                        kernel.ssd_scan_fwd(*jins, chunk=chunk, interpret=True)),
                       ("ssd_scan_ref", sref.ssd_scan_ref(*jins, chunk=chunk)[0])):
        err = np.abs(f32(y) - f32(want)).max(axis=(1, 3))
        assert np.all(err <= 2e-5 * _per_head_max(want)), f"vs {name}: {err}"


@pytest.mark.parametrize("l,chunk,g,dt_kind", CHUNKED_CASES)
def test_ssd_scan_chunked_model_bf16_within_one_ulp(ref, jssd, l, chunk, g, dt_kind):
    """bf16 x, B and C (exact in a bf16 product), as the tensor-core route
    takes them. Against the JAX scan in f32 on the same values: the model
    before y's rounding within 0.01 of one bf16 ulp of each (batch, head)'s
    max |y| (chip_smoke's unit); its bf16 y within one unit of it and of
    the JAX scan's own bf16 y (each rounds once, 0.5 of the unit). With
    each f32 operand rounded once to bf16 instead of split, the model lies
    more than 0.1 of the unit away: the split is what keeps the rule."""
    kernel, sref = jssd
    x, dt, A, B, C = _chunked_inputs(l, chunk, g, dt_kind)
    x, B, C = (f32(torch.from_numpy(a).bfloat16().float()) for a in (x, B, C))
    jnp = ref.jnp
    want = f32(sref.ssd_scan_ref(*map(jnp.asarray, (x, dt, A, B, C)), chunk=chunk)[0])
    want_bf16 = f32(sref.ssd_scan_ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt),
                                      jnp.asarray(A), jnp.asarray(B, jnp.bfloat16),
                                      jnp.asarray(C, jnp.bfloat16), chunk=chunk)[0])
    unit = 2.0 ** (np.floor(np.log2(np.maximum(_per_head_max(want), 1e-30))) - 7)
    t = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    for i in (0, 3, 4):
        t[i] = t[i].bfloat16()

    def units(got, against):
        return (np.abs(f32(got) - against).max(axis=(1, 3)) / unit).max()
    split = ssd_scan_chunked_ref(*t, chunk=chunk, out_f32=True)
    y = ssd_scan_chunked_ref(*t, chunk=chunk)
    single = ssd_scan_chunked_ref(*t, chunk=chunk, operands="bf16", out_f32=True)
    assert y.dtype == torch.bfloat16 and split.dtype == torch.float32
    assert units(split, want) <= 0.01
    assert units(y.float(), want) <= 1.0
    assert units(y.float(), want_bf16) <= 1.0
    assert units(single, want) > 0.1


def test_ssd_scan_chunked_model_rejects_unknown_operands():
    ins = [torch.from_numpy(a) for a in scan_inputs(1, 8, 2, 16, 1, 16, seed=5)]
    with pytest.raises(ValueError, match="operands"):
        ssd_scan_chunked_ref(*ins, chunk=4, operands="tf32")


# ---------------------------------------------------------------------------
# the routes of the CUDA launcher, with the extension stubbed
# ---------------------------------------------------------------------------

class _ScanExtension:
    """Stands in for the built extension's scan entries: records each
    launch (entry, workspace shapes and dtypes) and computes into y what
    the entry's kernels compute: the chunked model on the tensor-core
    entry, the plain scan on the CUDA-core one."""

    def __init__(self):
        self.launches = []

    def ssd_scan_mma(self, x, dt, A, B, C, y, states, decays, chunk, h_final):
        self.launches.append({"entry": "ssd_scan_mma", "states": tuple(states.shape),
                              "decays": tuple(decays.shape),
                              "dtypes": (states.dtype, decays.dtype), "chunk": chunk,
                              "h_final": tuple(h_final.shape)})
        out, h = ssd_scan_chunked_ref(x, dt, A, B, C, chunk=chunk, final_state=True)
        y.copy_(out)
        if h_final.numel():
            h_final.copy_(h)

    def ssd_scan(self, x, dt, A, B, C, y, chunk, h_final):
        self.launches.append({"entry": "ssd_scan", "chunk": chunk,
                              "h_final": tuple(h_final.shape)})
        out, h = ssd_scan_ref(x, dt, A, B, C, chunk=chunk)
        y.copy_(out)
        if h_final.numel():
            h_final.copy_(h)


@pytest.fixture
def scan_extension(monkeypatch):
    """CPU tensors routed as CUDA ones: `on_cpu` says False and the
    extension is the stand-in above."""
    from repro_torch.kernels import _build
    ext = _ScanExtension()
    monkeypatch.setattr(_build, "extension", lambda: ext)
    monkeypatch.setattr(ssd_ops, "on_cpu", lambda *tensors: False)
    return ext


def _scan_counts():
    f = ssd_ops.ssd_scan_cuda
    return f.launches, f.tensor_core_launches, f.cuda_core_launches


def _model_views(b, l, h, p, g, n, dtype, seed, offset=0):
    """x, B and C as views into one [b, l, h*p + 2*g*n] buffer, as apply_ssm
    hands them over (`offset` elements into it), with dt and A."""
    x, dt, A, B, C = scan_inputs(b, l, h, p, g, n, seed)
    di = h * p
    buf = torch.from_numpy(np.concatenate(
        [x.reshape(b, l, di), B.reshape(b, l, g * n), C.reshape(b, l, g * n)], axis=-1))
    buf = torch.cat([buf.new_zeros(offset), buf.flatten()]).to(dtype)[offset:]
    buf = buf.view(b, l, di + 2 * g * n)
    return (buf[..., :di].reshape(b, l, h, p), torch.from_numpy(dt), torch.from_numpy(A),
            buf[..., di:di + g * n].reshape(b, l, g, n), buf[..., di + g * n:].reshape(b, l, g, n))


@pytest.mark.parametrize("dtype,h,p,g,n,l,chunk,offset,route", [
    ("bfloat16", 4, 64, 1, 128, 40, 16, 0, "tensor_core"),   # the model's widths, 3 chunks
    ("bfloat16", 4, 16, 2, 16, 10, 16, 0, "tensor_core"),    # one chunk: no workspace
    ("bfloat16", 2, 48, 1, 32, 33, 8, 0, "tensor_core"),
    ("float32", 4, 64, 1, 128, 40, 16, 0, "cuda_core"),      # f32
    ("bfloat16", 2, 40, 1, 48, 20, 8, 0, "cuda_core"),       # head_dim 40
    ("bfloat16", 2, 16, 1, 24, 20, 8, 0, "cuda_core"),       # state 24
    ("bfloat16", 2, 64, 1, 128, 20, 8, 1, "cuda_core"),      # rows off 16 bytes
    ("bfloat16", 1, 16, 1, 16, 2100, 2100, 0, "cuda_core"),  # a chunk over 2048 rows
    ("bfloat16", 1, 16, 1, 16, 2100, 2048, 0, "tensor_core"),
])
def test_ssd_scan_routes_by_dtype_and_shape(scan_extension, dtype, h, p, g, n, l, chunk,
                                            offset, route):
    """`ssd_scan` on tensors that count as CUDA ones launches once through
    `ssd_scan_cuda`: bf16 x with head_dim and state multiples of 16 (<= 64,
    <= 128), chunks of at most 2048 rows and 16-byte rows reaches the
    tensor-core entry with an f32 workspace of states [b, nc - 1, h, p, n]
    and decays [b, nc - 1, h] (empty for one chunk); anything else the
    CUDA-core entry. The total and
    that route's count each rise by one, and y is what the entry wrote."""
    tdt = getattr(torch, dtype)
    x, dt, A, B, C = _model_views(2, l, h, p, g, n, tdt, seed=h * p + n, offset=offset)
    assert ssd_ops.ssd_route(x, B, C, chunk) == route
    before = _scan_counts()
    y = ssd_ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    after = _scan_counts()
    [launch] = scan_extension.launches
    assert after[0] - before[0] == 1
    assert (after[1] - before[1], after[2] - before[2]) == (
        (1, 0) if route == "tensor_core" else (0, 1))
    assert launch["chunk"] == chunk
    if route == "tensor_core":
        nc1 = -(-l // min(chunk, l)) - 1
        assert launch["entry"] == "ssd_scan_mma"
        assert launch["states"] == (2, nc1, h, p, n) and launch["decays"] == (2, nc1, h)
        assert launch["dtypes"] == (torch.float32, torch.float32)
        want = ssd_scan_chunked_ref(x, dt, A, B, C, chunk=chunk)
    else:
        assert launch["entry"] == "ssd_scan"
        want = ssd_scan_ref(x, dt, A, B, C, chunk=chunk)[0]
    assert y.dtype == tdt and y.shape == x.shape and torch.equal(y, want)


@pytest.mark.parametrize("dtype,h,p,g,n,l,chunk,route", [
    ("bfloat16", 4, 64, 1, 128, 40, 16, "tensor_core"),   # 2 whole chunks and a ragged one
    ("bfloat16", 4, 16, 2, 16, 10, 16, "tensor_core"),    # one chunk: one workspace slot
    ("bfloat16", 2, 48, 1, 32, 32, 8, "tensor_core"),     # whole chunks only
    ("float32", 4, 64, 1, 128, 40, 16, "cuda_core"),
    ("bfloat16", 2, 40, 1, 48, 20, 8, "cuda_core"),
])
def test_ssd_scan_final_state_routes(scan_extension, dtype, h, p, g, n, l, chunk, route):
    """`ssd_scan(final_state=True)` on tensors that count as CUDA ones: one
    launch of the route's entry with an f32 h_final [b, h, p, n] to write
    (the tensor-core entry with a workspace of nc slots, the last chunk's
    too), counted in the route's final-state count as well as its own;
    -> (y, h_final) as the entry wrote them. Without the final state the
    entry gets an empty h_final and the workspace nc - 1 slots."""
    tdt = getattr(torch, dtype)
    x, dt, A, B, C = _model_views(2, l, h, p, g, n, tdt, seed=h * p + n + 1)
    f = ssd_ops.ssd_scan_cuda
    counts = (f.launches, f.final_state_tensor_core_launches, f.final_state_cuda_core_launches)
    y, hf = ssd_ops.ssd_scan(x, dt, A, B, C, chunk=chunk, final_state=True)
    after = (f.launches, f.final_state_tensor_core_launches, f.final_state_cuda_core_launches)
    assert [a - b for a, b in zip(after, counts)] == (
        [1, 1, 0] if route == "tensor_core" else [1, 0, 1])
    y0 = ssd_ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    first, second = scan_extension.launches
    assert first["h_final"] == (2, h, p, n) and second["h_final"] == (0,)
    nc = -(-l // min(chunk, l))
    if route == "tensor_core":
        assert first["states"] == (2, nc, h, p, n) and first["decays"] == (2, nc, h)
        assert second["states"] == (2, nc - 1, h, p, n)
        want_y, want_h = ssd_scan_chunked_ref(x, dt, A, B, C, chunk=chunk, final_state=True)
    else:
        want_y, want_h = ssd_scan_ref(x, dt, A, B, C, chunk=chunk)
    assert hf.dtype == torch.float32 and torch.equal(hf, want_h)
    assert torch.equal(y, want_y) and torch.equal(y0, want_y)


@pytest.mark.parametrize("l,chunk,dt_kind", [
    (2, 16, "trained"),      # under K - 1, the prefill's shortest prompt
    (16, 16, "trained"),     # one whole chunk
    (40, 16, "trained"),     # a ragged last chunk
    (64, 16, "softplus"),
])
def test_ssd_scan_final_state_on_cpu_matches_plain_and_jax(ref, jssd, l, chunk, dt_kind):
    """On CPU tensors `ssd_scan(final_state=True)` is the plain scan's (y,
    h_final) bitwise; h_final within 1e-5 of the JAX `ssd_scan_ref`'s
    largest |h_final| (f32), and within the same of the plain model of the
    tensor-core route (`ssd_scan_chunked_ref(final_state=True)`, its hi +
    lo operands), whose h_final the kernel's carries through the last
    chunk."""
    _, sref = jssd
    x, dt, A, B, C = scan_inputs(2, l, 4, 16, 1, 16, seed=400 + l)
    if dt_kind == "trained":
        dt = trained_dt(2, l, 4, seed=500 + l)
    tins = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    y, hf = ssd_ops.ssd_scan(*tins, chunk=chunk, final_state=True)
    want_y, want_h = ssd_scan_ref(*tins, chunk=chunk)
    assert torch.equal(y, want_y) and torch.equal(hf, want_h)
    assert torch.equal(ssd_ops.ssd_scan(*tins, chunk=chunk), want_y)
    _, jh = sref.ssd_scan_ref(*[ref.jnp.asarray(a) for a in (x, dt, A, B, C)], chunk=chunk)
    within_max(hf, jh, 1e-5, "h_final vs ssd_scan_ref")
    _, mh = ssd_scan_chunked_ref(*tins, chunk=chunk, final_state=True)
    within_max(mh, jh, 1e-5, "the chunked model's h_final")


def test_ssd_scan_dispatch_goes_by_device():
    ins = [torch.from_numpy(a) for a in scan_inputs(1, 20, 2, 16, 1, 16, seed=3)]
    assert torch.equal(ssd_ops.ssd_scan(*ins, chunk=8), ssd_scan_ref(*ins, chunk=8)[0])


def _scan_args(**over):
    a = dict(x=torch.zeros(1, 8, 4, 16, dtype=torch.bfloat16),
             dt=torch.zeros(1, 8, 4), A=torch.zeros(4),
             B=torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16))
    a.update(over)
    return a["x"], a["dt"], a["A"], a["B"], a.get("C", a["B"])


@pytest.mark.parametrize("args,kw,err,match", [
    (_scan_args(B=torch.zeros(1, 8, 2, 16)), {}, TypeError, "dtype"),
    (_scan_args(dt=torch.zeros(1, 8, 4, dtype=torch.bfloat16)), {}, TypeError, "dtype"),
    (_scan_args(dt=torch.zeros(1, 7, 4)), {}, ValueError, "shape"),
    (_scan_args(B=torch.zeros(1, 8, 3, 16, dtype=torch.bfloat16)), {}, ValueError,
     "multiple of groups"),
    (_scan_args(x=torch.zeros(1, 8, 4, 80, dtype=torch.bfloat16)), {}, ValueError,
     "head_dim=80"),
    (_scan_args(B=torch.zeros(1, 8, 2, 256, dtype=torch.bfloat16)), {}, ValueError,
     "state=256"),
    (_scan_args(x=torch.zeros(1, 8, 16, 4, dtype=torch.bfloat16).transpose(2, 3)), {},
     ValueError, "contiguous"),
    (_scan_args(), {"chunk": 0}, ValueError, "chunk=0"),
    (_scan_args(x=torch.zeros(1, 8, 4, 16, requires_grad=True)), {}, RuntimeError,
     "no backward"),
])
def test_ssd_scan_launcher_rejects_what_the_kernel_does_not_take(args, kw, err, match):
    """The CUDA launcher's checks run before anything is built or launched."""
    with pytest.raises(err, match=match):
        ssd_ops.ssd_scan_cuda(*args, **kw)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_gated_rmsnorm_matches_jax(ref):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    z = rng.standard_normal((2, 5, 32)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    jnp, jl = ref.jnp, ref.layers
    got = layers.gated_rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x),
                               torch.from_numpy(z))
    want = jl.gated_rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), jnp.asarray(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # bf16: the gate's silu rounds to bf16 before the product on both sides
    got = layers.gated_rmsnorm({"scale": torch.from_numpy(scale)},
                               torch.from_numpy(x).bfloat16(), torch.from_numpy(z).bfloat16())
    want = jl.gated_rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(z, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - f32(want)).max() <= bf16_ulp_of_max(want)


def test_cross_entropy_matches_jax_with_ignored_labels(ref):
    rng = np.random.default_rng(12)
    logits = (3 * rng.standard_normal((2, 6, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 6)).astype(np.int32)
    labels[0, :2] = -1
    labels[1, 5] = -1
    got = layers.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = ref.layers.cross_entropy(ref.jnp.asarray(logits), ref.jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    # every label ignored: the mean is over max(count, 1) tokens, so 0
    none = layers.cross_entropy(torch.from_numpy(logits), torch.full((2, 6), -1))
    assert none.item() == 0.0


def test_ssm_a_init_range():
    """A_log = log u with u uniform on [1, 16): A = -exp(A_log) in (-16, -1]."""
    d = layers.ParamDef((4, 4096), ("layers", "ssm_heads"), init="ssm_a", dtype="float32")
    gen = torch.Generator().manual_seed(0)
    a_log = layers.init_array(d, gen, "cpu")
    assert a_log.dtype == torch.float32 and a_log.shape == (4, 4096)
    u = torch.exp(a_log)
    assert u.min().item() >= 1.0 - 1e-6 and u.max().item() < 16.0 + 1e-5
    assert u.min().item() < 1.1 and u.max().item() > 15.9     # it spans the range
    again = layers.init_array(d, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(a_log, again)                            # from the generator


# ---------------------------------------------------------------------------
# the SSM block and the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba(ref):
    cfg = get_smoke_config(ARCH)
    jcfg = ref.get_smoke_config(ARCH)
    jparams, nparams = random_params(ref, jcfg, seed=0)
    return cfg, jcfg, jparams, nparams, params_from_jax(nparams, "cpu")


def test_config_matches_reference(ref):
    from repro.configs import get_config as jget_config
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jget_config(ARCH))
    assert (dataclasses.asdict(get_smoke_config(ARCH))
            == dataclasses.asdict(ref.get_smoke_config(ARCH)))
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim,
            cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_chunk, cfg.vocab_size) == \
        (48, 2048, 4096, 64, 64, 128, 1, 256, 50280)


def test_converter_carries_the_ssm_tree(ref, mamba):
    """params_from_jax keeps every SSM leaf: key, shape, dtype and value."""
    cfg, _, _, nparams, tparams = mamba
    want = []
    tree_map(lambda d: want.append((d.shape, layers.DTYPES[d.dtype])),
                         Model(cfg).param_defs())
    got = []

    def walk(t, n):
        if isinstance(t, dict):
            assert set(t) == set(n)
            for k in t:
                walk(t[k], n[k])
            return
        got.append((tuple(t.shape), t.dtype))
        assert np.array_equal(t.float().numpy(), f32(n))
    walk(tparams, nparams)
    assert sorted(map(str, got)) == sorted(map(str, want))
    assert set(tparams["decoder"]["stack0"]["ssd_0"]["ssm"]) == {
        "in_proj_z", "in_proj_x", "in_proj_bc", "in_proj_dt", "conv_w", "conv_b",
        "A_log", "D", "dt_bias", "norm", "out_proj"}


def test_apply_ssm_matches_jax_f32(ref, mamba):
    """One SSM block in f32 (params and input), so the comparison is of the
    algorithm: projections, the causal conv, softplus, the scan, the skip
    term, the gated norm and the output projection."""
    cfg, jcfg, _, nparams, _ = mamba
    from repro.models import ssm as jssm
    lp = nparams["decoder"]["stack0"]["ssd_0"]["ssm"]

    def first(tree, conv):
        return {k: first(v, conv) if isinstance(v, dict) else conv(f32(v)[0])
                for k, v in tree.items()}
    tp = first(lp, torch.from_numpy)
    jp = first(lp, ref.jnp.asarray)
    x = np.random.default_rng(13).standard_normal((2, 40, 64)).astype(np.float32)
    got, gh = ssm.apply_ssm(cfg, tp, torch.from_numpy(x))
    want, jh = jssm.apply_ssm(jcfg, jp, ref.jnp.asarray(x))
    within_max(got, want, 1e-5, "apply_ssm")
    within_max(gh, jh, 1e-5, "final states")
    kgot, kh = ssm.apply_ssm(cfg, tp, torch.from_numpy(x), ssd_impl="pallas")
    assert torch.equal(kgot, got) and kh is None      # the kernel path's plain version
    with pytest.raises(ValueError):
        ssm.apply_ssm(cfg, tp, torch.from_numpy(x), ssd_impl="nope")


def test_softplus_has_no_linear_switch():
    """jax.nn.softplus is logaddexp(x, 0) everywhere; F.softplus returns x
    above 20, one f32 rounding off it."""
    x = torch.tensor([-30.0, 0.0, 19.0, 20.5, 40.0])
    want = np.logaddexp(x.double().numpy(), 0.0)
    np.testing.assert_allclose(ssm._softplus(x).double().numpy(), want, rtol=1e-7)


def _tokens(cfg, b=2, s=40, seed=14):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :3] = -1
    return toks, labels


@pytest.fixture(scope="module")
def qwen(ref):
    cfg = get_smoke_config("qwen2.5-14b")
    jcfg = ref.get_smoke_config("qwen2.5-14b")
    jparams, nparams = random_params(ref, jcfg, seed=1)
    return cfg, jcfg, jparams, nparams, params_from_jax(nparams, "cpu")


@pytest.mark.parametrize("family", ["ssm", "attn"])
def test_model_forward_and_loss_match_jax(ref, mamba, qwen, family):
    """Model.forward / loss against the JAX model (ssd_impl="ref",
    blockwise attention) on the same converted params and tokens; 40
    tokens, so the SSM's chunk of 16 ends ragged."""
    cfg, jcfg, jparams, _, tparams = mamba if family == "ssm" else qwen
    toks, labels = _tokens(cfg)
    jm = ref.Model(jcfg, ssd_impl="ref", attn_impl="blockwise", attn_chunk=16)
    jbatch = {"tokens": ref.jnp.asarray(toks), "labels": ref.jnp.asarray(labels)}
    jlogits, jaux = ref.jax.jit(jm.forward)(jparams, jbatch)
    jloss, jparts = ref.jax.jit(jm.loss)(jparams, jbatch)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    for impl in ("ref", "pallas"):
        model = Model(cfg, ssd_impl=impl, attn_chunk=16)
        logits, aux = model.forward(tparams, batch)
        assert logits.shape == (2, 40, cfg.vocab_size) and logits.dtype == torch.bfloat16
        assert aux.item() == float(jaux) == 0.0
        within_max(logits.float(), f32(jlogits), 2.0 ** -5, f"{family} {impl} logits")
        loss, parts = model.loss(tparams, batch)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-2)
        np.testing.assert_allclose(parts["ce"].item(), float(jparts["ce"]), rtol=1e-2)


def test_forward_last_row_is_prefill(qwen):
    """The forward pass and the prefill share the attention layer's ops, so
    the forward's last row is the prefill's logits bitwise (on the CPU; on
    the card chip_smoke.py holds the hidden state entering the head)."""
    cfg, _, _, _, tparams = qwen
    toks, _ = _tokens(cfg, s=24)
    for impl in ("blockwise", "pallas"):
        model = Model(cfg, attn_impl=impl, attn_chunk=8)
        logits, _ = model.forward(tparams, {"tokens": torch.from_numpy(toks)})
        last, _ = model.prefill(tparams, {"tokens": torch.from_numpy(toks)})
        assert torch.equal(logits[:, -1], last)




def test_model_init_draws_every_ssm_leaf():
    """Model.init from a seeded generator: the tree of param_defs, A_log in
    its range, D and the norm scale ones, dt_bias and conv_b zeros."""
    cfg = get_smoke_config(ARCH)
    params = Model(cfg).init(0, "cpu")
    p = params["decoder"]["stack0"]["ssd_0"]["ssm"]
    assert p["in_proj_x"].shape == (2, 64, 128) and p["in_proj_x"].dtype == torch.bfloat16
    assert p["conv_w"].shape == (2, 4, 128 + 32)
    a = torch.exp(p["A_log"])
    assert a.shape == (2, 8) and a.min() >= 1.0 - 1e-6 and a.max() < 16.0 + 1e-5
    assert torch.equal(p["D"], torch.ones(2, 8)) and not p["dt_bias"].any()
    assert not p["conv_b"].any() and torch.equal(p["norm"]["scale"], torch.ones(2, 128))
    loss, parts = Model(cfg).loss(params, {
        "tokens": torch.zeros((1, 8), dtype=torch.long),
        "labels": torch.ones((1, 8), dtype=torch.long)})
    assert torch.isfinite(loss) and abs(loss.item() - np.log(256)) < 0.5
