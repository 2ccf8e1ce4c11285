"""The port's kernel modules against the JAX package, on the CPU.

Flash attention (prefill), flash-decode over slot-contiguous caches and
over the page arena, the int8 row quantizer and RMSNorm have hand-written CUDA
kernels that run only on the card (chip_smoke.py holds each against its
plain version there). Here the plain versions — what a CPU tensor
dispatches to — are held against the JAX Pallas kernels run in interpret
mode, and against the JAX package's plain references.

Tolerances: f32 outputs agree to 1e-5 absolute (the same math summed in
another order); bf16 outputs to one bf16 ulp of |o| (an f32 difference of
a few f32 ulps can round to neighbouring bf16 values); int8 codes and
their scales bitwise (the division is IEEE and both round half to even).
"""
import numpy as np
import pytest
import torch

from tests.test_torch_ref import jax_ref, jax_ref_scope  # noqa: F401 (autouse fixture)

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import on_cpu
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref,
                                                 flash_decode,
                                                 flash_decode_paged,
                                                 flash_decode_paged_ref,
                                                 flash_decode_ref)
from repro_torch.kernels.flash_attention.ops import (flash_attention_cuda,
                                                     flash_decode_cuda)
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_attention.ref import attention_mask
from repro_torch.kernels.quantize import quantize, quantize_ref
from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.kernels.quantize import ref as q_ref
from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_bwd_ref, rmsnorm_cuda,
                                         rmsnorm_ref)
from repro_torch.models import attention


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significand bits), with a floor at tiny |x|."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.maximum(2.0 ** (e - 7), 2.0 ** -126)


def _paged_case(b, h, kh, ps, d, kv_lens, dtype, seed):
    """q + arenas + a scrambled table: each slot with kv_len > 0 owns
    distinct random arena pages in random order; empty slots and unused
    table entries point at the null page (the last arena row). Pages
    outside the tables hold values the masking must keep out."""
    rng = np.random.default_rng(seed)
    cap = max(kv_lens + [1])
    max_pages = -(-cap // ps)
    pages = sum(-(-n // ps) for n in kv_lens) + 3
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((pages + 1, ps, kh, d)).astype(np.float32)
    v = rng.standard_normal((pages + 1, ps, kh, d)).astype(np.float32)
    tab = np.full((b, max_pages), pages, np.int32)
    perm = rng.permutation(pages)
    nxt = 0
    for i, n in enumerate(kv_lens):
        need = -(-n // ps)
        tab[i, :need] = perm[nxt:nxt + need]
        nxt += need
    kvl = np.asarray(kv_lens, np.int32)
    if dtype == "bfloat16":   # round inputs to bf16 once, on both sides
        q, k, v = (torch.from_numpy(a).bfloat16().float().numpy() for a in (q, k, v))
    return q, k, v, kvl, tab


CASES = [
    # b, h, kh, page_size, d, kv_lens
    (3, 4, 2, 4, 16, [5, 0, 12]),            # G=2, ragged, a 0, full capacity
    (4, 4, 4, 24, 32, [24, 1, 47, 0]),       # G=1, page not a multiple of 256
    (2, 10, 2, 8, 32, [17, 9]),              # G=5 (not a power of two)
    (3, 6, 3, 384, 16, [400, 383, 0]),       # page 384: block_k = gcd(256, 384)
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_paged_decode_plain_matches_jax(case, dtype):
    ref = jax_ref()
    jnp = ref.jnp
    b, h, kh, ps, d, kv_lens = case
    q, k, v, kvl, tab = _paged_case(b, h, kh, ps, d, kv_lens, dtype, seed=len(kv_lens))
    tdt = getattr(torch, dtype)
    got = flash_decode_paged(torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
                             torch.from_numpy(v).to(tdt), torch.from_numpy(kvl),
                             torch.from_numpy(tab)).float().numpy()
    args = [jnp.asarray(a, dtype) for a in (q, k, v)] + [jnp.asarray(kvl), jnp.asarray(tab)]
    kern = np.asarray(ref.decode_kernel.flash_decode_paged_fwd(*args, interpret=True)
                      ).astype(np.float32)
    oracle = np.asarray(ref.fa_ref.flash_decode_paged_ref(*args)).astype(np.float32)
    for want in (kern, oracle):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        else:
            assert np.all(np.abs(got - want) <= _bf16_ulp(want)), \
                np.max(np.abs(got - want))
    assert np.all(got[kvl == 0] == 0.0)   # empty slots: exact zeros


def _close(got, want, dtype, what=""):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=what)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want)), \
            (what, np.max(np.abs(got - want)))


ATTN_CASES = [
    # b, h, kh, sq, skv, d, window, q_offset, JAX block (q and k)
    (2, 4, 2, 37, 37, 16, 0, 0, 16),         # G=2, ragged last block
    (1, 5, 1, 20, 45, 16, 0, None, 16),      # G=5, Sq < Skv aligned to the end
    (2, 3, 3, 24, 50, 32, 8, 10, 16),        # G=1, window, positive offset
    (1, 10, 2, 40, 24, 16, 0, None, 256),    # Sq > Skv: 16 rows see no key
    (1, 4, 2, 33, 33, 16, 5, 0, 8),          # window, ragged
    (1, 10, 2, 40, 24, 16, 0, None, 16),     # rows without a key, Skv ragged to the block
    (1, 10, 2, 40, 20, 16, 0, None, 16),     # ... 20 such rows, 20 of 32 padded keys real
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_plain_matches_jax(case, dtype):
    """The port's flash_attention on CPU tensors (model layout) against the
    JAX Pallas kernel in interpret mode and its oracle (kernel layout),
    every row: f32 to 1e-5, bf16 to one bf16 ulp. A row with no visible
    key is the mean of v over all Skv keys of its kv head in the port and
    the oracle (the masked scores are a finite -1e30, so its softmax is
    uniform). The Pallas kernel masks the padded keys of a ragged last
    block with -1e30 too, so there it averages over nk * block_k keys, the
    padded ones zero: Skv / (nk * block_k) times the mean (0.75 at Skv 24,
    block 16). Where Skv fills its blocks the three agree on those rows;
    where it does not, the kernel is held to that scaled mean, and its
    distance from the port is that of the mean it drops."""
    ref = jax_ref()
    jnp = ref.jnp
    b, h, kh, sq, skv, d, window, q_offset, blk = case
    rng = np.random.default_rng(sq * skv + d)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kh, d)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=True,
                          window=window, q_offset=q_offset)
    assert got.dtype == tdt and got.shape == (b, sq, h, d)
    got = got.float().numpy()
    jargs = [jnp.asarray(a.transpose(0, 2, 1, 3), dtype) for a in (q, k, v)]
    kw = dict(causal=True, window=window, q_offset=q_offset)
    kern = ref.fa_kernel.flash_attention_fwd(*jargs, **kw, block_q=blk, block_k=blk,
                                             interpret=True)
    oracle = ref.fa_ref.flash_attention_ref(*jargs, **kw)
    off = skv - sq if q_offset is None else q_offset
    seen = attention_mask(sq, skv, "cpu", causal=True, window=window,
                          q_offset=off).any(dim=-1).numpy()
    bk = min(blk, skv)
    padded = -(-skv // bk) * bk                     # the kernel's kv length
    for name, want in (("kernel", kern), ("oracle", oracle)):
        want = np.asarray(want).astype(np.float32).transpose(0, 2, 1, 3)
        _close(got[:, seen], want[:, seen], dtype, name)
        if name == "oracle" or padded == skv or seen.all():
            _close(got[:, ~seen], want[:, ~seen], dtype, name + " (rows without a key)")
        else:
            # the inputs as both sides saw them, summed over the real keys
            vin = torch.from_numpy(v).to(tdt).double().numpy()
            vsum = np.repeat(vin.sum(axis=1), h // kh, axis=1)       # [b, h, d]
            scaled = np.broadcast_to((vsum / padded)[:, None], want[:, ~seen].shape)
            _close(want[:, ~seen], scaled.astype(np.float32), dtype, "kernel's scaled mean")
            lost = np.abs(vsum / skv - vsum / padded).max()
            assert lost > 0.05
            assert np.abs(got[:, ~seen] - want[:, ~seen]).max() == pytest.approx(lost, rel=0.02)
    assert (~seen).sum() == min(sq, max(0, -off))   # causal rows before key 0


def _decode_case(b, h, kh, smax, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, d)).astype(np.float32),
            rng.standard_normal((b, smax, kh, d)).astype(np.float32),
            rng.standard_normal((b, smax, kh, d)).astype(np.float32))


DECODE_CASES = [
    # b, h, kh, smax, d, kv_len (a list is [B], an int a scalar)
    (3, 4, 2, 20, 16, [5, 0, 20]),           # G=2, a 0, full capacity
    (2, 10, 2, 33, 32, 17),                  # G=5, scalar kv_len
    (4, 4, 4, 9, 16, [9, 1, 0, 4]),          # G=1
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_flash_decode_plain_matches_jax(case, dtype):
    """The port's flash_decode on CPU tensors against the JAX
    flash_decode_fwd in interpret mode and flash_decode_ref: f32 to 1e-5,
    bf16 to one bf16 ulp; kv_len 0 gives exact zeros; q as [B,1,H,D] keeps
    its shape."""
    ref = jax_ref()
    jnp = ref.jnp
    b, h, kh, smax, d, kv_len = case
    q, k, v = _decode_case(b, h, kh, smax, d, seed=smax)
    if dtype == "bfloat16":   # round inputs to bf16 once, on both sides
        q, k, v = (torch.from_numpy(a).bfloat16().float().numpy() for a in (q, k, v))
    tdt = getattr(torch, dtype)
    tkv = torch.tensor(kv_len, dtype=torch.int32) if isinstance(kv_len, list) else kv_len
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = flash_decode(tq, tk, tv, tkv).float().numpy()
    assert flash_decode(tq[:, None], tk, tv, tkv).shape == (b, 1, h, d)
    jargs = [jnp.asarray(a, dtype) for a in (q, k, v)] + [jnp.asarray(kv_len, jnp.int32)]
    kern = ref.decode_kernel.flash_decode_fwd(*jargs, block_k=8, interpret=True)
    oracle = ref.fa_ref.flash_decode_ref(*jargs)
    for name, want in (("kernel", kern), ("oracle", oracle)):
        _close(got, np.asarray(want).astype(np.float32), dtype, name)
    empty = np.broadcast_to(np.asarray(kv_len), (b,)) == 0
    assert np.all(got[empty] == 0.0)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_flash_decode_int8_plain_matches_jax(case):
    """int8 codes with f32 per-row scales: to 1e-5 of the JAX kernel in
    interpret mode and of its oracle."""
    ref = jax_ref()
    jnp = ref.jnp
    b, h, kh, smax, d, kv_len = case
    q, k, v = _decode_case(b, h, kh, smax, d, seed=smax + 1)
    kq, ks = _quant_np(k)
    vq, vs = _quant_np(v)
    tkv = torch.tensor(kv_len, dtype=torch.int32) if isinstance(kv_len, list) else kv_len
    got = flash_decode(torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(vq), tkv,
                       k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)).numpy()
    jargs = (jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(kv_len, jnp.int32))
    jkw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    kern = ref.decode_kernel.flash_decode_fwd(*jargs, **jkw, block_k=8, interpret=True)
    oracle = ref.fa_ref.flash_decode_ref(*jargs, **jkw)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=0, atol=1e-5)


def _quant_np(x):
    qt, st = quantize_ref(torch.from_numpy(x.reshape(-1, x.shape[-1])))
    return qt.numpy().reshape(x.shape), st.numpy().reshape(x.shape[:-1])


@pytest.mark.parametrize("case", CASES[:3])
def test_paged_decode_int8_plain_matches_jax(case):
    ref = jax_ref()
    jnp = ref.jnp
    b, h, kh, ps, d, kv_lens = case
    q, k, v, kvl, tab = _paged_case(b, h, kh, ps, d, kv_lens, "float32", seed=7)
    kq, ks = _quant_np(k)
    vq, vs = _quant_np(v)
    got = flash_decode_paged(
        torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(vq),
        torch.from_numpy(kvl), torch.from_numpy(tab),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)).numpy()
    jargs = (jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(kvl),
             jnp.asarray(tab))
    jkw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    kern = np.asarray(ref.decode_kernel.flash_decode_paged_fwd(*jargs, **jkw,
                                                               interpret=True))
    oracle = np.asarray(ref.fa_ref.flash_decode_paged_ref(*jargs, **jkw))
    np.testing.assert_allclose(got, kern, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-5)


def test_paged_ref_equals_contiguous_ref():
    """Gathering through the table and running the dense version is the
    paged plain version, bitwise."""
    q, k, v, kvl, tab = _paged_case(3, 4, 2, 4, 16, [5, 0, 12], "float32", seed=1)
    t = [torch.from_numpy(a) for a in (q, k, v, kvl, tab)]
    kc = k[tab].reshape(3, -1, 2, 16)
    vc = v[tab].reshape(3, -1, 2, 16)
    paged = flash_decode_paged_ref(*t)
    dense = flash_decode_ref(t[0], torch.from_numpy(kc), torch.from_numpy(vc), t[3])
    assert torch.equal(paged, dense)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_plain_matches_jax_bitwise(dtype):
    ref = jax_ref()
    jnp = ref.jnp
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((40, 128)) * rng.uniform(0.01, 10, (40, 1))).astype(np.float32)
    x[3] = 0.0                                   # all-zero row: scale 1
    x[5, :] = 0.0
    x[5, 0] = 127.0                              # scale exactly 1.0 ...
    x[5, 1:6] = [0.5, 1.5, 2.5, -0.5, -2.5]      # ... so these are exact .5 ties
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    x_in = xt.float().numpy()                    # what both sides see
    q, s = quantize(xt)
    jq, js = ref.q_kernel.quantize_fwd(jnp.asarray(x_in, dtype), interpret=True)
    # the JAX package's `quantize` op runs its reference under jit, where XLA
    # turns `amax / 127.0` into a multiply by the f32 reciprocal; eager
    # jnp divides, and its scales can differ from the jitted ones by an ulp
    rq, rs = ref.jax.jit(ref.q_ref.quantize_ref)(jnp.asarray(x_in, dtype))
    for wq, ws in ((jq, js), (rq, rs)):
        assert np.array_equal(q.numpy(), np.asarray(wq))
        assert np.array_equal(s.numpy().view(np.uint32),
                              np.asarray(ws).astype(np.float32).view(np.uint32))
    assert s[3].item() == 1.0 and not q[3].any()
    assert q[5, 1:6].tolist() == [0, 2, 2, 0, -2]  # half to even


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_plain_matches_jax_on_nonfinite_rows(dtype):
    """Rows holding NaN and infinities: the port's plain quantizer against
    the JAX package's jitted `quantize_ref` and its Pallas kernel in
    interpret mode, bitwise. A row holding a NaN gets scale 1 and its NaN
    elements code 0; a row holding an infinity and no NaN gets scale inf
    and all codes 0 (each quotient is 0, or inf / inf = NaN); the CUDA
    kernel takes the same values (chip_smoke.py holds it to this plain
    version on such rows)."""
    ref = jax_ref()
    jnp = ref.jnp
    nan, inf = np.nan, np.inf
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((8, 64)) * 3).astype(np.float32)
    x[0, 7] = nan                                # a NaN among finite values
    x[1, 0] = inf
    x[2, 63] = -inf
    x[3, :2] = [inf, -inf]
    x[4, :3] = [nan, inf, -inf]                  # NaN with both infinities
    x[5] = nan
    x[6, 10] = 300.0                             # a finite row, for contrast
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    x_in = jnp.asarray(xt.float().numpy(), dtype)
    q, s = quantize(xt)
    jq, js = ref.jax.jit(ref.q_ref.quantize_ref)(x_in)
    kq, ks = ref.q_kernel.quantize_fwd(x_in, interpret=True)
    for wq, ws in ((jq, js), (kq, ks)):
        assert np.array_equal(q.numpy(), np.asarray(wq))
        assert np.array_equal(s.numpy().view(np.uint32),
                              np.asarray(ws).astype(np.float32).view(np.uint32))
    assert s[[0, 4, 5]].tolist() == [1.0, 1.0, 1.0]
    assert s[[1, 2, 3]].tolist() == [inf, inf, inf] and not q[1:4].any()
    assert q[0, 7] == 0 and q[4, 0] == 0 and not q[5].any()
    assert q[4, 1:3].tolist() == [127, -127]     # +-inf / 1, clipped
    assert torch.equal(q[0, :7], torch.round(xt[0, :7].float()).clamp(-127, 127).to(torch.int8))


def test_dispatch_goes_by_device():
    x = torch.randn(4, 8)
    assert all(torch.equal(a, b) for a, b in zip(quantize(x), quantize_ref(x)))
    q, k = torch.randn(2, 6, 4, 32), torch.randn(2, 6, 2, 32)
    assert torch.equal(flash_attention(q, k, k, q_offset=0),
                       flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                           k.transpose(1, 2), q_offset=0).transpose(1, 2))
    assert torch.equal(flash_decode(q[:, 0], k, k, 3), flash_decode_ref(q[:, 0], k, k, 3))
    # the model's decode entry takes the same path; the dense oracle agrees
    assert torch.equal(attention.decode_attention(q[:, :1], k, k, 3),
                       attention.dense_decode_attention(q[:, :1], k, k, 3))
    assert on_cpu(x, None)
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        on_cpu(x, torch.empty(1, device="meta"))


def _attn_args(**over):
    a = dict(q=torch.zeros(1, 8, 4, 32, dtype=torch.bfloat16),
             k=torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16))
    a.update(over)
    return a["q"], a["k"], a.get("v", a["k"])


@pytest.mark.parametrize("args,err,match", [
    (_attn_args(k=torch.zeros(1, 8, 2, 32)), TypeError, "dtype"),
    (_attn_args(q=torch.zeros(1, 8, 4, 48, dtype=torch.bfloat16),
                k=torch.zeros(1, 8, 2, 48, dtype=torch.bfloat16)), ValueError, "multiple of 32"),
    (_attn_args(k=torch.zeros(1, 8, 3, 32, dtype=torch.bfloat16)), ValueError, "multiple of K"),
    (_attn_args(q=torch.zeros(1, 4, 8, 32, dtype=torch.bfloat16).transpose(1, 2)),
     ValueError, "contiguous"),
])
def test_flash_attention_launcher_rejects_what_the_kernel_does_not_take(args, err, match):
    """The CUDA launcher's checks run before anything is built or launched."""
    with pytest.raises(err, match=match):
        flash_attention_cuda(*args)


class _AttentionExtension:
    """Stands in for the built extension: records which kernel entry each
    launch reaches and computes the plain version into `out`."""

    def __init__(self):
        self.entries = []

    def _attend(self, entry, q, k, v, out, causal, window, q_offset, sm_scale):
        assert sm_scale == pytest.approx(q.shape[-1] ** -0.5)
        self.entries.append(entry)
        out.copy_(flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                      causal=causal, window=window,
                                      q_offset=q_offset).transpose(1, 2))

    def flash_attention(self, *args):
        self._attend("cuda_core", *args)

    def flash_attention_wgmma(self, *args):
        self._attend("wgmma", *args)


@pytest.fixture
def attention_extension(monkeypatch):
    """CPU tensors routed as CUDA ones: `on_cpu` says False, and the
    extension is the stand-in above."""
    ext = _AttentionExtension()
    monkeypatch.setattr(_build, "extension", lambda: ext)
    monkeypatch.setattr(fa_ops, "on_cpu", lambda *tensors: False)
    return ext


def _route_counts():
    f = flash_attention_cuda
    return f.launches, f.wgmma_launches, f.cuda_core_launches


@pytest.mark.parametrize("dtype,d,route", [
    ("bfloat16", 64, "wgmma"), ("bfloat16", 128, "wgmma"), ("bfloat16", 256, "wgmma"),
    ("float32", 64, "cuda_core"), ("float32", 128, "cuda_core"), ("float32", 256, "cuda_core"),
    ("bfloat16", 96, "cuda_core"), ("bfloat16", 32, "cuda_core"), ("bfloat16", 160, "cuda_core"),
])
def test_flash_attention_routes_by_dtype_and_head_dim(attention_extension, dtype, d, route):
    """`flash_attention` on tensors that count as CUDA ones launches through
    `flash_attention_cuda`: bf16 at head_dim 64/128/256 reaches the
    tensor-core entry, f32 or another head_dim the CUDA-core one, once;
    the total and that route's count each rise by one; the output is what
    the entry wrote."""
    tdt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(d)
    q = torch.randn(2, 9, 4, d, generator=g).to(tdt)
    k = torch.randn(2, 13, 2, d, generator=g).to(tdt)
    v = torch.randn(2, 13, 2, d, generator=g).to(tdt)
    before = _route_counts()
    out = fa_ops.flash_attention(q, k, v, causal=True, window=5, q_offset=3)
    after = _route_counts()
    assert attention_extension.entries == [route]
    assert after[0] - before[0] == 1
    assert (after[1] - before[1], after[2] - before[2]) == ((1, 0) if route == "wgmma" else (0, 1))
    want = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               window=5, q_offset=3).transpose(1, 2)
    assert out.dtype == tdt and torch.equal(out, want)


@pytest.mark.parametrize("dtype,d,err,match", [
    ("bfloat16", 48, ValueError, "multiple of 32"),
    ("float32", 288, ValueError, "at most 256"),
    ("float16", 128, TypeError, "dtype"),
])
def test_flash_attention_neither_route_takes(attention_extension, dtype, d, err, match):
    """What neither kernel takes raises before any launch or count."""
    tdt = getattr(torch, dtype)
    q, k = torch.zeros(1, 8, 4, d, dtype=tdt), torch.zeros(1, 8, 2, d, dtype=tdt)
    before = _route_counts()
    with pytest.raises(err, match=match):
        fa_ops.flash_attention(q, k, k)
    assert attention_extension.entries == [] and _route_counts() == before


def test_flash_attention_launcher_has_no_backward(attention_extension):
    """Like the JAX kernel (and the SSD scan launcher), the launcher has no
    backward: with autograd on and an input that needs a gradient it
    raises before launching; under no_grad, or with inputs that need
    none, it launches."""
    q = torch.randn(1, 8, 4, 64, dtype=torch.bfloat16, requires_grad=True)
    k = torch.randn(1, 8, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_cuda(q, k, k)
    assert attention_extension.entries == []
    with torch.no_grad():
        flash_attention_cuda(q, k, k)
    flash_attention_cuda(q.detach(), k, k)
    assert attention_extension.entries == ["wgmma", "wgmma"]


def test_flash_decode_launcher_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(2, 4, 32, dtype=torch.bfloat16)
    k = torch.zeros(2, 8, 2, 32, dtype=torch.bfloat16)
    kv = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="dtype"):
        flash_decode_cuda(q, k.float(), k.float(), kv)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        flash_decode_cuda(q, k.to(torch.int8), k.to(torch.int8), kv,
                          k_scale=torch.zeros(2, 8, 2))
    with pytest.raises(ValueError, match="at most 8 query heads"):
        flash_decode_cuda(torch.zeros(2, 18, 32, dtype=torch.bfloat16), k, k, kv)
    with pytest.raises(ValueError, match="kv_len"):
        flash_decode_cuda(q, k, k, torch.zeros(3, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Decode: the tensor-core route's splits, its plain model, the routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,kh,capacity,sm", [
    (16, 8, 4096, 132),     # long context: a few blocks an SM
    (4, 8, 160, 132),       # the engine: one split, no combine launch
    (8, 8, 160, 132),       # the static loop
    (16, 8, 10, 132),       # capacity below one tile
    (1, 1, 0, 132),         # no positions at all
    (1, 1, 64, 132),        # exactly one tile
    (1, 1, 4096, 132),      # one slot, one kv head: many splits
    (1, 1, 100_000, 132),
    (128, 8, 4096, 132),    # enough (slot, head) pairs to fill the card alone
    (16, 8, 4096, 1),
    (3, 2, 1000, 16),
])
def test_decode_splits_cover_the_capacity_in_whole_tiles(b, kh, capacity, sm):
    """`decode_splits` cuts [0, capacity) into `splits` chunks of whole
    tiles that cover it exactly (the last split holds a position), aims at
    DECODE_BLOCKS_PER_SM blocks an SM, and keeps every split at least
    DECODE_MIN_SPLIT_TILES tiles long unless there is one."""
    splits, chunk = fa_ops.decode_splits(b, kh, capacity, sm)
    tile = fa_ops.DECODE_TILE
    assert splits >= 1 and chunk >= tile and chunk % tile == 0
    assert splits * chunk >= capacity > (splits - 1) * chunk or (splits == 1 and capacity <= chunk)
    blocks = b * kh * splits
    if splits > 1:
        assert chunk >= fa_ops.DECODE_MIN_SPLIT_TILES * tile
        # never more splits than it takes to reach the target
        assert b * kh * (splits - 1) < fa_ops.DECODE_BLOCKS_PER_SM * sm
    if capacity <= tile:
        assert (splits, chunk) == (1, tile)
    if (b, kh, capacity, sm) == (16, 8, 4096, 132):
        assert 4 <= splits <= 8 and blocks >= 4 * sm
    if (b, kh, capacity) in ((4, 8, 160), (8, 8, 160), (128, 8, 4096)):
        assert splits == 1


SPLIT_CASES = [
    # b, h, kh, smax (contiguous) or page_size (paged), d, kv_lens
    (3, 4, 2, 20, 16, [5, 0, 20]),          # G=2, a 0, full capacity
    (2, 10, 2, 33, 32, [17, 33]),           # G=5
    (4, 4, 4, 9, 16, [9, 1, 0, 4]),         # G=1
    (2, 36, 4, 24, 32, [24, 7]),            # G=9 (starcoder2-7b's 36/4)
    (2, 32, 2, 16, 16, [3, 16]),            # G=16 (qwen3-moe's 64/4)
]


@pytest.mark.parametrize("splits", [1, 3, 50])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_ref_matches_plain_and_jax(case, paged, dtype, splits):
    """The plain model of the tensor-core decode's split and combine
    (`flash_decode_split_ref`) against `flash_decode_ref` /
    `flash_decode_paged_ref` and the JAX `flash_decode_fwd` /
    `flash_decode_paged_fwd` in interpret mode: f32 to 1e-5, bf16 to one
    bf16 ulp, int8 codes (f32 q, f32 scales) to 1e-5. 50 splits is more
    than there are positions, so most splits lie wholly past kv_len and
    some past the capacity; kv_len 0 gives exact zeros, and no NaN."""
    ref = jax_ref()
    jnp = ref.jnp
    b, h, kh, n, d, kv_lens = case
    int8 = dtype == "int8"
    qdt = "float32" if int8 else dtype
    if paged:
        q, k, v, kvl, tab = _paged_case(b, h, kh, n, d, kv_lens, qdt, seed=h + n)
    else:
        q, k, v = _decode_case(b, h, kh, n, d, seed=h + n)
        if qdt == "bfloat16":
            q, k, v = (torch.from_numpy(a).bfloat16().float().numpy() for a in (q, k, v))
        kvl, tab = np.asarray(kv_lens, np.int32), None
    tdt = getattr(torch, qdt)
    tq = torch.from_numpy(q).to(tdt)
    kw, jkw = {}, {}
    if int8:
        k, ks = _quant_np(k)
        v, vs = _quant_np(v)
        kw = {"k_scale": torch.from_numpy(ks), "v_scale": torch.from_numpy(vs)}
        jkw = {"k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs)}
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    else:
        tk, tv = torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)
    tkvl = torch.from_numpy(kvl)
    ttab = None if tab is None else torch.from_numpy(tab)
    got = fa_ref.flash_decode_split_ref(tq, tk, tv, tkvl, splits, page_table=ttab, **kw)
    assert got.dtype == tdt and got.shape == (b, h, d)
    got = got.float().numpy()
    jdt = jnp.int8 if int8 else qdt
    jargs = [jnp.asarray(q, qdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(kvl)]
    if paged:
        plain = flash_decode_paged_ref(tq, tk, tv, tkvl, ttab, **kw)
        kern = ref.decode_kernel.flash_decode_paged_fwd(*jargs, jnp.asarray(tab), **jkw,
                                                        interpret=True)
    else:
        plain = flash_decode_ref(tq, tk, tv, tkvl, **kw)
        kern = ref.decode_kernel.flash_decode_fwd(*jargs, **jkw, block_k=8, interpret=True)
    for name, want in (("plain", plain.float().numpy()),
                       ("jax kernel", np.asarray(kern).astype(np.float32))):
        _close(got, want, qdt, name)
    assert np.isfinite(got).all()
    assert np.all(got[kvl == 0] == 0.0)


def test_split_ref_refuses_splits_that_do_not_cover():
    q, k = torch.zeros(1, 2, 16), torch.zeros(1, 20, 1, 16)
    with pytest.raises(ValueError, match="do not cover"):
        fa_ref.flash_decode_split_ref(q, k, k, torch.tensor([20], dtype=torch.int32), 2,
                                      chunk=8)


DECODE_GROUP_CASES = [
    # b, h, kh, smax / page_size, d, kv_lens: the group sizes of the configs
    # the tensor-core route takes beyond the CUDA-core limit of 8
    (2, 36, 4, 24, 32, [24, 7]),            # G=9: starcoder2-7b (36/4)
    (3, 32, 2, 16, 16, [3, 16, 0]),         # G=16: qwen3-moe-235b (64/4)
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_GROUP_CASES)
def test_decode_plain_matches_jax_at_large_groups(case, dtype):
    """The plain decode versions, slot-contiguous and paged, against the
    JAX kernels in interpret mode and their oracles at 9 and 16 query
    heads per kv head: f32 to 1e-5, bf16 to one bf16 ulp, kv_len 0 exact
    zeros."""
    ref = jax_ref()
    jnp = ref.jnp
    b, h, kh, n, d, kv_lens = case
    tdt = getattr(torch, dtype)
    # slot-contiguous caches of n positions
    q, k, v = _decode_case(b, h, kh, n, d, seed=h * n)
    if dtype == "bfloat16":
        q, k, v = (torch.from_numpy(a).bfloat16().float().numpy() for a in (q, k, v))
    kvl = np.asarray(kv_lens, np.int32)
    got = flash_decode(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                       torch.from_numpy(kvl)).float().numpy()
    jargs = [jnp.asarray(a, dtype) for a in (q, k, v)] + [jnp.asarray(kvl)]
    for name, want in (
            ("kernel", ref.decode_kernel.flash_decode_fwd(*jargs, block_k=8, interpret=True)),
            ("oracle", ref.fa_ref.flash_decode_ref(*jargs))):
        _close(got, np.asarray(want).astype(np.float32), dtype, "contiguous " + name)
    assert np.all(got[kvl == 0] == 0.0)
    # page arenas of page size n
    q, k, v, kvl, tab = _paged_case(b, h, kh, n, d, kv_lens, dtype, seed=h + n)
    got = flash_decode_paged(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                             torch.from_numpy(kvl), torch.from_numpy(tab)).float().numpy()
    jargs = [jnp.asarray(a, dtype) for a in (q, k, v)] + [jnp.asarray(kvl), jnp.asarray(tab)]
    for name, want in (
            ("kernel", ref.decode_kernel.flash_decode_paged_fwd(*jargs, interpret=True)),
            ("oracle", ref.fa_ref.flash_decode_paged_ref(*jargs))):
        _close(got, np.asarray(want).astype(np.float32), dtype, "paged " + name)
    assert np.all(got[kvl == 0] == 0.0)


class _DecodeExtension:
    """Stands in for the built extension's decode entries: records each
    launch (entry, chunk, scratch shapes) and computes into `out` what the
    entry's kernel computes: the split-and-combine model on the tensor-core
    entries, the plain version on the CUDA-core ones."""

    def __init__(self):
        self.launches = []

    def _record(self, entry, q, ml, acc, chunk, sm_scale):
        assert sm_scale == pytest.approx(q.shape[-1] ** -0.5)
        self.launches.append({"entry": entry, "chunk": chunk,
                              "part_ml": None if ml is None else tuple(ml.shape),
                              "part_acc": None if acc is None else tuple(acc.shape),
                              "scratch_dtype": None if acc is None else acc.dtype})

    def flash_decode_mma(self, q, k, v, ks, vs, kvl, out, ml, acc, chunk, sm_scale):
        self._record("flash_decode_mma", q, ml, acc, chunk, sm_scale)
        splits = 1 if acc is None else acc.shape[2]
        out.copy_(fa_ref.flash_decode_split_ref(q, k, v, kvl, splits, chunk=chunk,
                                                k_scale=ks, v_scale=vs))

    def flash_decode_paged_mma(self, q, k, v, ks, vs, kvl, tab, out, ml, acc, chunk,
                               sm_scale):
        self._record("flash_decode_paged_mma", q, ml, acc, chunk, sm_scale)
        splits = 1 if acc is None else acc.shape[2]
        out.copy_(fa_ref.flash_decode_split_ref(q, k, v, kvl, splits, chunk=chunk,
                                                k_scale=ks, v_scale=vs, page_table=tab))

    def flash_decode(self, q, k, v, ks, vs, kvl, out, sm_scale):
        self._record("flash_decode", q, None, None, None, sm_scale)
        out.copy_(flash_decode_ref(q, k, v, kvl, k_scale=ks, v_scale=vs))

    def flash_decode_paged(self, q, k, v, ks, vs, kvl, tab, out, sm_scale):
        self._record("flash_decode_paged", q, None, None, None, sm_scale)
        out.copy_(flash_decode_paged_ref(q, k, v, kvl, tab, k_scale=ks, v_scale=vs))


SM_COUNT = 132


@pytest.fixture
def decode_extension(monkeypatch):
    """CPU tensors routed as CUDA ones: `on_cpu` says False, the card has
    SM_COUNT SMs, and the extension is the stand-in above."""
    ext = _DecodeExtension()
    monkeypatch.setattr(_build, "extension", lambda: ext)
    monkeypatch.setattr(fa_ops, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(fa_ops, "_sm_count", lambda device: SM_COUNT)
    return ext


def _decode_counts(launcher):
    return launcher.launches, launcher.tensor_core_launches, launcher.cuda_core_launches


@pytest.mark.parametrize("int8", [False, True], ids=["kv_model", "kv_int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("dtype,h,kh,d,capacity,route", [
    ("bfloat16", 4, 2, 64, 1024, "tensor_core"),     # G 2, splits over the card
    ("bfloat16", 32, 2, 128, 1024, "tensor_core"),   # G 16
    ("bfloat16", 18, 2, 256, 96, "tensor_core"),     # G 9, one split
    ("bfloat16", 6, 6, 64, 160, "tensor_core"),      # G 1
    ("float32", 4, 2, 128, 1024, "cuda_core"),
    ("bfloat16", 4, 2, 32, 96, "cuda_core"),          # head_dim 32
    ("bfloat16", 16, 2, 96, 96, "cuda_core"),         # head_dim 96, G 8
])
def test_decode_routes_by_dtype_and_shape(decode_extension, dtype, h, kh, d, capacity, route,
                                          paged, int8):
    """`flash_decode` / `flash_decode_paged` on tensors that count as CUDA
    ones launch once through their `*_cuda` launcher: bf16 q at head_dim
    64/128/256 with G <= 16 reaches the tensor-core entry with the chunk
    and f32 scratch shapes `decode_splits` gives ([B, K, splits, 2, G] and
    [B, K, splits, G, D], or none for one split); anything else the
    CUDA-core entry. The total and that route's count each rise by one,
    and the output is what the entry wrote."""
    tdt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(h * d)
    b, ps = 2, 16
    kv_lens = [capacity, capacity // 3]
    q = torch.randn(b, h, d, generator=g).to(tdt)
    if paged:
        pages = b * capacity // ps
        shape = (pages + 1, ps, kh, d)
        table = torch.randperm(pages, generator=g).reshape(b, -1).to(torch.int32)
    else:
        shape = (b, capacity, kh, d)
    k, v = (torch.randn(shape, generator=g).to(tdt) for _ in range(2))
    kw = {}
    if int8:
        (k, ks), (v, vs) = (quantize_ref(x.reshape(-1, d)) for x in (k, v))
        k, v = k.reshape(shape), v.reshape(shape)
        kw = {"k_scale": ks.reshape(shape[:3]), "v_scale": vs.reshape(shape[:3])}
    kvl = torch.tensor(kv_lens, dtype=torch.int32)
    launcher = fa_ops.flash_decode_paged_cuda if paged else fa_ops.flash_decode_cuda
    before = _decode_counts(launcher)
    if paged:
        out = fa_ops.flash_decode_paged(q, k, v, kvl, table, **kw)
    else:
        out = fa_ops.flash_decode(q, k, v, kvl, **kw)
    after = _decode_counts(launcher)
    [launch] = decode_extension.launches
    entry = ("flash_decode_paged" if paged else "flash_decode") + (
        "_mma" if route == "tensor_core" else "")
    assert launch["entry"] == entry
    assert after[0] - before[0] == 1
    assert (after[1] - before[1], after[2] - before[2]) == (
        (1, 0) if route == "tensor_core" else (0, 1))
    tab = {"page_table": table} if paged else {}
    if route == "tensor_core":
        splits, chunk = fa_ops.decode_splits(b, kh, capacity, SM_COUNT)
        assert launch["chunk"] == chunk
        if splits == 1:
            assert launch["part_ml"] is None and launch["part_acc"] is None
        else:
            assert launch["part_ml"] == (b, kh, splits, 2, h // kh)
            assert launch["part_acc"] == (b, kh, splits, h // kh, d)
            assert launch["scratch_dtype"] == torch.float32
        assert (splits > 1) == (capacity == 1024)
        want = fa_ref.flash_decode_split_ref(q, k, v, kvl, splits, chunk=chunk, **tab, **kw)
    elif paged:
        want = flash_decode_paged_ref(q, k, v, kvl, table, **kw)
    else:
        want = flash_decode_ref(q, k, v, kvl, **kw)
    assert out.dtype == tdt and out.shape == q.shape and torch.equal(out, want)


@pytest.mark.parametrize("dtype,h,kh,d,err,match", [
    ("bfloat16", 34, 2, 128, ValueError, "at most 16 query heads"),   # G 17
    ("bfloat16", 18, 2, 32, ValueError, "at most 8 query heads"),     # G 9 at head_dim 32
    ("float32", 18, 2, 128, ValueError, "at most 8 query heads"),     # G 9 in f32
    ("bfloat16", 4, 2, 48, ValueError, "multiple of 32"),
    ("float16", 4, 2, 128, TypeError, "dtype"),
])
def test_decode_neither_route_takes(decode_extension, dtype, h, kh, d, err, match):
    """What neither decode kernel takes raises before any launch or count."""
    tdt = getattr(torch, dtype)
    q, k = torch.zeros(2, h, d, dtype=tdt), torch.zeros(2, 8, kh, d, dtype=tdt)
    kvl = torch.tensor([8, 3], dtype=torch.int32)
    for launcher, call in ((fa_ops.flash_decode_cuda, lambda: fa_ops.flash_decode(q, k, k, kvl)),
                           (fa_ops.flash_decode_paged_cuda, lambda: fa_ops.flash_decode_paged(
                               q, k, k, kvl, torch.zeros(2, 1, dtype=torch.int32)))):
        before = _decode_counts(launcher)
        with pytest.raises(err, match=match):
            call()
        assert _decode_counts(launcher) == before
    assert decode_extension.launches == []


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def _rms_inputs(rows, d, seed):
    """x with rows of varied scale (one all-zero row where there are several)
    and a scale around 1, as a trained norm's."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, d)) * rng.uniform(0.05, 8.0, (rows, 1))).astype(np.float32)
    if rows > 1:
        x[1] = 0.0
    s = (1.0 + 0.2 * rng.standard_normal(d)).astype(np.float32)
    return x, s


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("rows,d", [(1, 64), (37, 64), (300, 64), (1, 5120), (37, 5120),
                                    (300, 5120)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_jax(dtype, rows, d, eps):
    """The port's rmsnorm on CPU tensors against the JAX rmsnorm_fwd in
    interpret mode, its rmsnorm_ref and layers.apply_norm (what the JAX
    model computes): f32 within 1e-6 of each element (a product of x, one
    rsqrt per row and the scale, so every element carries only the few-ulp
    error of that rsqrt), bf16 within one bf16 ulp of each element (the f32
    results round to neighbouring bf16 values at most)."""
    ref = jax_ref()
    jnp = ref.jnp
    from repro.kernels.rmsnorm import kernel as rk, ref as rr
    x, s = _rms_inputs(rows, d, seed=rows * d)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    got = rmsnorm(xt, torch.from_numpy(s), eps=eps)
    assert got.dtype == tdt and got.shape == (rows, d)
    got = got.float().numpy()
    jx, js = jnp.asarray(xt.float().numpy(), dtype), jnp.asarray(s)
    cfg = ref.get_smoke_config("qwen2.5-14b")
    wants = {"kernel": rk.rmsnorm_fwd(jx, js, eps=eps, interpret=True),
             "ref": rr.rmsnorm_ref(jx, js, eps=eps),
             "apply_norm": ref.layers.apply_norm(cfg, {"scale": js}, jx, eps=eps)}
    for name, want in wants.items():
        want = np.asarray(want).astype(np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=name)
        else:
            assert np.all(np.abs(got - want) <= _bf16_ulp(want)), \
                (name, np.max(np.abs(got - want)))
    if rows > 1:
        assert not got[1].any()                       # a zero row stays zero


@pytest.mark.parametrize("rows,d,eps", [(1, 64, 1e-6), (37, 64, 1e-5), (300, 512, 1e-6)])
def test_rmsnorm_gradient_matches_jax(rows, d, eps):
    """rmsnorm_bwd_ref (the backward of the kernel's autograd Function)
    against jax.vjp of the JAX apply_norm and against torch autograd
    through rmsnorm_ref, in f32: dx within 1e-5 of its largest |value|
    (its terms cancel, so an element-wise bound would not hold near 0)
    and dscale likewise; bf16 x gives a bf16 dx and an f32 dscale."""
    ref = jax_ref()
    jnp = ref.jnp
    x, s = _rms_inputs(rows, d, seed=rows + d)
    dy = np.random.default_rng(rows).standard_normal((rows, d)).astype(np.float32)
    cfg = ref.get_smoke_config("qwen2.5-14b")
    _, vjp = ref.jax.vjp(lambda x_, s_: ref.layers.apply_norm(cfg, {"scale": s_}, x_, eps=eps),
                         jnp.asarray(x), jnp.asarray(s))
    jdx, jds = (np.asarray(a) for a in vjp(jnp.asarray(dy)))
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(s).requires_grad_()
    rmsnorm_ref(xt, st, eps=eps).backward(torch.from_numpy(dy))
    dx, ds = rmsnorm_bwd_ref(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(dy),
                             eps=eps)
    assert dx.dtype == torch.float32 and ds.dtype == torch.float32 and ds.shape == (d,)
    for name, (wx, ws) in {"jax": (jdx, jds), "torch autograd": (xt.grad.numpy(),
                                                                 st.grad.numpy())}.items():
        for got, want in ((dx.numpy(), wx), (ds.numpy(), ws)):
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), name
    bx, bs = rmsnorm_bwd_ref(torch.from_numpy(x).bfloat16(), torch.from_numpy(s),
                             torch.from_numpy(dy).bfloat16(), eps=eps)
    assert bx.dtype == torch.bfloat16 and bs.dtype == torch.float32


def test_rmsnorm_dispatch_on_cpu_takes_the_plain_version():
    """CPU tensors take rmsnorm_ref under ordinary autograd: the same
    values and grads, any leading shape, and no kernel launch."""
    before = rmsnorm_cuda.launches
    x = torch.randn(2, 5, 64, requires_grad=True)
    s = (1 + 0.1 * torch.randn(64)).requires_grad_()
    out = rmsnorm(x, s, eps=1e-5)
    assert out.shape == x.shape and torch.equal(out, rmsnorm_ref(x, s, eps=1e-5))
    out.square().sum().backward()
    dx, ds = rmsnorm_bwd_ref(x.detach(), s.detach(), 2 * out.detach(), eps=1e-5)
    torch.testing.assert_close(x.grad, dx, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(s.grad, ds, rtol=1e-5, atol=1e-5)
    assert rmsnorm_cuda.launches == before


@pytest.mark.parametrize("x,scale,err,match", [
    (torch.zeros(4, 64), torch.ones(64), ValueError, "on the card"),
    (torch.zeros(4, 64, dtype=torch.float16), torch.ones(64), TypeError, "dtype"),
    (torch.zeros(64, 4).t(), torch.ones(64), ValueError, "contiguous"),
    (torch.zeros(4, 64), torch.ones(64, dtype=torch.bfloat16), TypeError, "dtype"),
    (torch.zeros(4, 64), torch.ones(32), ValueError, "shape"),
])
def test_rmsnorm_launcher_rejects_what_the_kernel_does_not_take(x, scale, err, match):
    """The CUDA launcher's checks run before anything is built or launched."""
    with pytest.raises(err, match=match):
        rmsnorm_cuda(x, scale)


@pytest.mark.parametrize("d,esize,aligned,layout", [
    (5120, 2, True, (1, 20)),     # qwen2.5-14b in bf16: one warp, 20 vectors a lane
    (2048, 2, True, (1, 8)),      # mamba2-1.3b
    (5120, 4, True, (2, 20)),     # f32 at d 5120: two warps
    (8192, 2, True, (2, 16)),
    (8192, 4, True, (4, 16)),
    (16384, 4, True, (8, 16)),
    (40960, 2, True, (8, 20)),    # the widest row 8 warps hold
    (40968, 2, True, None),       # one vector more: the element path
    (64, 2, True, (1, 1)),        # a 37 x 64 row
    (4, 4, True, (1, 1)),
    (100, 2, True, None),         # not a whole number of 16-byte vectors
    (2, 4, True, None),
    (5120, 2, False, None),       # an unaligned pointer
])
def test_rmsnorm_layout_by_width_and_alignment(d, esize, aligned, layout):
    """The path and layout the RMSNorm launcher passes the kernel: the
    fewest warps W (1, 2, 4, 8) whose lanes hold a row in at most 20
    16-byte vectors, or None (the element path) for rows that are no whole
    number of vectors, unaligned pointers and rows wider than 8 warps hold."""
    from repro_torch.kernels.rmsnorm.ops import MAX_VECTORS, rmsnorm_layout
    got = rmsnorm_layout(d, esize, aligned)
    assert got == layout
    if got:
        w, v = got
        assert v <= MAX_VECTORS and w * 32 * v * 16 >= d * esize
        assert w == 1 or -(-(d * esize // 16) // (32 * (w // 2))) > MAX_VECTORS


def test_rmsnorm_layout_holds_every_config_row_in_registers():
    """Every model width of the port's configs (full and smoke), in bf16 and
    f32, takes the row-in-registers path; bf16 at the full widths in one
    warp a row."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_layout
    for arch in ("qwen2.5-14b", "mamba2-1.3b"):
        for cfg in (get_config(arch), get_smoke_config(arch)):
            for esize in (2, 4):
                assert rmsnorm_layout(cfg.d_model, esize, True) is not None
        assert rmsnorm_layout(get_config(arch).d_model, 2, True)[0] == 1


# ---------------------------------------------------------------------------
# int8 quantize and dequantize: paths and launches
# ---------------------------------------------------------------------------

class _QuantizeExtension:
    """Stands in for the built extension's int8 entries: records each
    launch (entry and path arguments) and computes into the outputs what
    the entry's kernel computes, by the plain versions."""

    def __init__(self):
        self.launches = []

    def quantize_rows(self, x, q, scale, lanes, vectors):
        self.launches.append(("quantize_rows", lanes, vectors))
        pq, ps = quantize_ref(x)
        q.copy_(pq)
        scale.copy_(ps)

    def quantize_kv_write(self, k, v, kc, vc, ks, vs, table, positions, active, lanes, vectors):
        self.launches.append(("quantize_kv_write", lanes, vectors))
        q_ref.quantize_kv_write_ref(k, v, kc, vc, ks, vs, table, positions, active)

    def dequantize_rows(self, q, scale, out, vector):
        self.launches.append(("dequantize_rows", vector))
        out.copy_(q_ref.dequantize_ref(q, scale, out.dtype))

    def dequantize_sum_rows(self, q, scale, out, vector):
        self.launches.append(("dequantize_sum_rows", vector))
        out.copy_(q_ref.dequantize_sum_rows_ref(q, scale, out.numel()))


@pytest.fixture
def quantize_extension(monkeypatch):
    """CPU tensors routed as CUDA ones through the int8 entries: `on_cpu`
    says False and the extension is the stand-in above."""
    ext = _QuantizeExtension()
    monkeypatch.setattr(_build, "extension", lambda: ext)
    monkeypatch.setattr(q_ops, "on_cpu", lambda *tensors: False)
    return ext


def _path_counts(launcher):
    return launcher.launches, launcher.vector_launches, launcher.element_launches


@pytest.mark.parametrize("cols,esize,aligned,layout", [
    (1024, 4, True, (32, 8)),     # DDL's pod-hop row, f32: one warp, 8 vectors a lane
    (128, 2, True, (16, 1)),      # a k/v row at head_dim 128, bf16: half a warp
    (128, 4, True, (32, 1)),
    (64, 2, True, (8, 1)),        # head_dim 64
    (256, 2, True, (32, 1)),      # head_dim 256
    (2048, 2, True, (32, 8)),     # the widest row 32 lanes x 8 vectors hold
    (2056, 2, True, None),        # one vector more: the element path
    (1000, 4, True, (32, 8)),     # 250 vectors: 8 a lane, the last ones masked
    (40, 4, True, (16, 1)),       # 10 vectors: 16 lanes
    (4, 4, True, (1, 1)),
    (100, 2, True, None),         # not a whole number of 16-byte vectors
    (1023, 4, True, None),
    (1024, 4, False, None),       # an unaligned pointer or stride
])
def test_quantize_layout_by_width_and_alignment(cols, esize, aligned, layout):
    """The path the quantizer's launchers pass the kernel: the fewest lanes
    (a power of two <= 32) whose 16-byte vectors hold the row one a lane,
    else 32 lanes and the fewest vectors in 1, 2, 4, 8 a lane; None (the
    element path) exactly for rows of no whole number of vectors, unaligned
    pointers or strides, and rows wider than 32 lanes x 8 vectors."""
    got = q_ops.quantize_layout(cols, esize, aligned)
    assert got == layout
    if got:
        lanes, vectors = got
        nvec = cols * esize // 16
        assert lanes * vectors >= nvec and vectors <= q_ops.MAX_VECTORS
        assert lanes == 32 or lanes >= nvec > lanes // 2


@pytest.mark.parametrize("cols,aligned,vector", [
    (1024, True, True), (64, True, True), (4, True, True), (1000, True, True),
    (30, True, False), (1022, True, False), (1, True, False), (1024, False, False)])
def test_dequantize_layout_by_width_and_alignment(cols, aligned, vector):
    """The dequantizers' vector path (a warp a row, 4 codes a lane a store)
    exactly for rows of a multiple of 4 codes on aligned pointers."""
    assert q_ops.dequantize_layout(cols, aligned) is vector


@pytest.mark.parametrize("rows,cols,dtype,offset,layout", [
    (40, 1024, torch.float32, 0, (32, 8)),
    (32, 128, torch.bfloat16, 0, (16, 1)),
    (7, 100, torch.bfloat16, 0, None),
    (6, 128, torch.bfloat16, 1, None),          # a view one element in: unaligned
])
def test_quantize_routes_by_layout(quantize_extension, rows, cols, dtype, offset, layout):
    """`quantize` on tensors that count as CUDA ones launches once through
    `quantize_cuda` with `quantize_layout`'s path ((0, 0) for the element
    path), counted by path, and returns what the kernel wrote."""
    g = torch.Generator().manual_seed(rows)
    # contiguous rows starting `offset` elements into their buffer
    x = torch.randn(rows * cols + offset, generator=g).to(dtype)[offset:].view(rows, cols)
    before = _path_counts(q_ops.quantize_cuda)
    q, s = q_ops.quantize(x)
    after = _path_counts(q_ops.quantize_cuda)
    assert quantize_extension.launches == [("quantize_rows", *(layout or (0, 0)))]
    assert (after[0] - before[0], after[1] - before[1], after[2] - before[2]) == (
        (1, 1, 0) if layout else (1, 0, 1))
    pq, ps = quantize_ref(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)


@pytest.mark.parametrize("rows,cols,out_dtype,vector", [
    (16, 1024, torch.float32, True), (5, 1024, torch.bfloat16, True),
    (37, 64, torch.float32, True), (5, 30, torch.float32, False)])
def test_dequantize_routes_by_layout(quantize_extension, rows, cols, out_dtype, vector):
    """`dequantize` launches once through `dequantize_cuda`, on the path
    `dequantize_layout` gives, counted by path."""
    q, s = quantize_ref(torch.randn(rows, cols, generator=torch.Generator().manual_seed(cols)))
    before = _path_counts(q_ops.dequantize_cuda)
    out = q_ops.dequantize(q, s, out_dtype)
    after = _path_counts(q_ops.dequantize_cuda)
    assert quantize_extension.launches == [("dequantize_rows", vector)]
    assert (after[0] - before[0], after[1] - before[1], after[2] - before[2]) == (
        (1, 1, 0) if vector else (1, 0, 1))
    assert torch.equal(out, q_ref.dequantize_ref(q, s, out_dtype))


def _kv_case(b, kh, d, dtype, paged, seed):
    """k/v rows, int8 caches with arbitrary contents, positions (one on a
    page boundary, an inactive slot, and past Smax on the slot-contiguous
    caches) and a scrambled table."""
    g = torch.Generator().manual_seed(seed)
    ps, max_pages = (4, 3) if paged else (6, 1)
    pages = b * max_pages + 1 if paged else b
    k, v = (torch.randn(b, 1, kh, d, generator=g).to(dtype) for _ in range(2))
    caches = [torch.randint(-127, 128, (pages, ps, kh, d), generator=g, dtype=torch.int8)
              for _ in range(2)]
    caches += [torch.rand(pages, ps, kh, generator=g) for _ in range(2)]
    table = (torch.randperm(pages - 1, generator=g)[:b * max_pages].reshape(b, max_pages)
             .to(torch.int32) if paged else None)
    positions = torch.tensor([4, 11, 0, 9][:b], dtype=torch.int32)
    active = torch.tensor([True, True, False, True][:b])
    return k, v, caches, table, positions, active


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("dtype,d,strided,layout", [
    (torch.bfloat16, 128, False, (16, 1)),
    (torch.float32, 64, False, (16, 1)),
    (torch.bfloat16, 128, True, (16, 1)),     # rows of a wider projection, strides of 8
    (torch.bfloat16, 12, False, None),        # 24 B rows: the element path
])
def test_quantize_kv_write_routes_by_layout(quantize_extension, paged, dtype, d, strided,
                                            layout):
    """`quantize_kv_write` on tensors that count as CUDA ones launches once
    through `quantize_kv_write_cuda` with `quantize_layout`'s path at width
    D (rows read through their strides), counted by path, and leaves the
    caches as the plain version does."""
    k, v, caches, table, positions, active = _kv_case(4, 2, d, dtype, paged, seed=d)
    if strided:   # k and v as views into one [B, 1, 3K, D] projection output
        proj = torch.cat([k, v, k], dim=2)
        k, v = proj[:, :, :2], proj[:, :, 2:4]
        assert not k.is_contiguous() and k.stride(0) == 6 * d
    want = [c.clone() for c in caches]
    q_ref.quantize_kv_write_ref(k, v, *want, table, positions, active)
    before = _path_counts(q_ops.quantize_kv_write_cuda)
    assert q_ops.quantize_kv_write(k, v, *caches, table, positions, active) is None
    after = _path_counts(q_ops.quantize_kv_write_cuda)
    assert quantize_extension.launches == [("quantize_kv_write", *(layout or (0, 0)))]
    assert (after[0] - before[0], after[1] - before[1], after[2] - before[2]) == (
        (1, 1, 0) if layout else (1, 0, 1))
    assert all(torch.equal(c, w) for c, w in zip(caches, want))


@pytest.mark.parametrize("kwargs,err,match", [
    ({"k": torch.zeros(4, 2, 2, 16, dtype=torch.bfloat16)}, ValueError, "one token a slot"),
    ({"v": torch.zeros(4, 1, 2, 16)}, TypeError, "dtype"),
    ({"positions": torch.zeros(4, dtype=torch.int64)}, TypeError, "dtype"),
    ({"active": torch.ones(3, dtype=torch.bool)}, ValueError, "shape"),
    ({"table": None}, ValueError, "one page a slot"),
    ({"k_scale": torch.zeros(13, 4, 2, 1)}, ValueError, "shape"),
])
def test_quantize_kv_write_launcher_rejects_what_the_kernel_does_not_take(
        quantize_extension, kwargs, err, match):
    """What the fused write's kernel does not take raises before any launch
    or count."""
    k, v, (kc, vc, ks, vs), table, positions, active = _kv_case(4, 2, 16, torch.bfloat16,
                                                                True, 0)
    args = dict(k=k, v=v, k_codes=kc, v_codes=vc, k_scale=ks, v_scale=vs, table=table,
                positions=positions, active=active)
    args.update(kwargs)
    before = _path_counts(q_ops.quantize_kv_write_cuda)
    with pytest.raises(err, match=match):
        q_ops.quantize_kv_write(*args.values())
    assert _path_counts(q_ops.quantize_kv_write_cuda) == before
    assert quantize_extension.launches == []


def test_dequantize_sum_rows_routes_and_checks(quantize_extension):
    """`dequantize_sum_rows` launches once through its launcher on the
    vector path for 1024-code rows (the element path for 30), and rejects
    an n past a pod's elements and a scale of another shape."""
    g = torch.Generator().manual_seed(0)
    for cols, vector in ((1024, True), (30, False)):
        qg = torch.randint(-127, 128, (2, 3, cols), generator=g, dtype=torch.int8)
        sg = torch.rand(2, 3, generator=g)
        before = _path_counts(q_ops.dequantize_sum_rows_cuda)
        out = q_ops.dequantize_sum_rows(qg, sg, 3 * cols - 5)
        after = _path_counts(q_ops.dequantize_sum_rows_cuda)
        assert quantize_extension.launches[-1] == ("dequantize_sum_rows", vector)
        assert (after[0] - before[0], after[1] - before[1]) == (1, int(vector))
        assert torch.equal(out, q_ref.dequantize_sum_rows_ref(qg, sg, 3 * cols - 5))
    for args, match in (((qg, sg, 3 * 30 + 1), "not within"), ((qg, sg[:, :2], 5), "shape")):
        with pytest.raises(ValueError, match=match):
            q_ops.dequantize_sum_rows(*args)
    assert len(quantize_extension.launches) == 2
