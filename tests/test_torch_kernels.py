"""The port's kernel modules against the JAX package, on the CPU.

The paged flash-decode and the int8 row quantizer have hand-written CUDA
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

from repro_torch.kernels._dispatch import on_cpu
from repro_torch.kernels.flash_attention import (flash_decode_paged,
                                                 flash_decode_paged_ref,
                                                 flash_decode_ref)
from repro_torch.kernels.quantize import quantize, quantize_ref


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


def test_dispatch_goes_by_device():
    x = torch.randn(4, 8)
    assert all(torch.equal(a, b) for a, b in zip(quantize(x), quantize_ref(x)))
    assert on_cpu(x, None)
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        on_cpu(x, torch.empty(1, device="meta"))
