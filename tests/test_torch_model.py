"""The port's model pieces against the JAX package on the qwen2.5-14b smoke
config (2 layers, d_model 64, 4 query / 2 kv heads), with params converted
from the JAX side; the whole-model paths (prefill, chunked prefill, the
flash-attention prefill, the whole-batch decode) on the smoke configs of
every dense decoder ported: qwen2.5-14b, olmo-1b (MHA, LayerNorm without
params, tied embeddings), starcoder2-7b (LayerNorm with a bias, GELU with
biases) and qwen2-72b (8 query / 2 kv heads of 8).

Function-level pieces (norm, rope, MLP, attention functions) run in f32 and
agree to 1e-5. The model runs in bf16 by construction — ParamDef defaults
to bf16 and `embed_tokens` casts to bf16 — and the two frameworks round
bf16 intermediates at different places (XLA fuses elementwise chains and
sums matmuls in another order), so model outputs are held to 4 bf16 ulps
of the largest |value| compared (2**-5 of it): measured differences are
under half of that.
"""
import numpy as np
import pytest
import torch

from tests.test_torch_ref import (jax_ref, jax_ref_scope,  # noqa: F401 (autouse fixture)
                                  random_params, smoke_cfg)

from repro_torch.convert import params_from_jax
from repro_torch.models import attention, layers, kvquant
from repro_torch.models.model import Model


def bf16_close(got, want, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = 2.0 ** -5 * max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: max |diff| {err} > {tol}"


def f32(x):
    return np.asarray(x).astype(np.float32)


DENSE_ARCHS = ("qwen2.5-14b", "olmo-1b", "starcoder2-7b", "qwen2-72b")


def _setup(arch):
    from repro_torch.configs import get_smoke_config
    ref = jax_ref()
    jcfg = ref.get_smoke_config(arch)
    jparams, nparams = random_params(ref, jcfg, seed=0)
    return ref, get_smoke_config(arch), jcfg, jparams, params_from_jax(nparams, "cpu")


@pytest.fixture(scope="module")
def setup():
    assert smoke_cfg() == _setup("qwen2.5-14b")[1]
    return _setup("qwen2.5-14b")


@pytest.fixture(scope="module", params=DENSE_ARCHS[1:])
def dense_setup(request):
    """`setup` for each other dense smoke config."""
    return _setup(request.param)


def test_layers_match_jax_f32(setup):
    ref, cfg, jcfg, _, _ = setup
    jnp, jl = ref.jnp, ref.layers
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    got = layers.apply_norm(cfg, {"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    want = jl.apply_norm(jcfg, {"scale": jnp.asarray(scale)}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)

    w = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
         for k, s in (("w_gate", (64, 128)), ("w_up", (64, 128)), ("w_down", (128, 64)))}
    got = layers.apply_mlp(cfg, {k: torch.from_numpy(v) for k, v in w.items()},
                           torch.from_numpy(x))
    want = jl.apply_mlp(jcfg, {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)

    for theta in (10_000.0, 1_000_000.0):
        assert np.array_equal(layers.rope_freqs(128, theta), jl.rope_freqs(128, theta))
    xr = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 130]], np.int32)
    got = layers.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos), 1e6)
    want = jl.apply_rope(jnp.asarray(xr), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# (norm_type, mlp_act, use_bias): the layer kinds of the dense configs
LAYER_KINDS = [("layernorm", "gelu", True), ("layernorm", "gelu", False),
               ("layernorm_nonparam", "swiglu", False), ("layernorm_nonparam", "swiglu", True),
               ("rmsnorm", "geglu", False), ("rmsnorm", "geglu", True)]


@pytest.mark.parametrize("norm_type,mlp_act,use_bias", LAYER_KINDS)
def test_layer_kinds_match_jax_f32(setup, norm_type, mlp_act, use_bias):
    """LayerNorm with and without params, and the gated (SwiGLU, GeGLU)
    and plain GELU MLPs with and without biases, in f32 at d 64 against
    the JAX package's on the same seeded inputs: the defs key for key and
    the outputs within 1e-5 (an n/(n-1) variance or the exact instead of
    the tanh GELU would be ~1e-2 off). Rows of varied mean and scale, so
    the mean is taken out for real; the input's dtype comes back."""
    import dataclasses
    ref, cfg, jcfg, _, _ = setup
    jnp, jl = ref.jnp, ref.layers
    kw = dict(norm_type=norm_type, mlp_act=mlp_act, use_bias=use_bias, norm_eps=1e-5)
    cfg, jcfg = dataclasses.replace(cfg, **kw), dataclasses.replace(jcfg, **kw)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 5, 64)) * rng.uniform(0.1, 4, (2, 5, 1))
         + rng.uniform(-3, 3, (2, 5, 1))).astype(np.float32)

    def draw(defs):
        return {k: (1 + 0.1 * rng.standard_normal(d.shape) if d.init == "ones" else
                    0.1 * rng.standard_normal(d.shape)).astype(np.float32)
                for k, d in defs.items()}
    for defs, jdefs, apply, japply in (
            (layers.norm_defs(cfg, 64), jl.norm_defs(jcfg, 64),
             layers.apply_norm, jl.apply_norm),
            (layers.mlp_defs(cfg), jl.mlp_defs(jcfg), layers.apply_mlp, jl.apply_mlp)):
        assert {k: dataclasses.astuple(d) for k, d in defs.items()} == \
            {k: dataclasses.astuple(d) for k, d in jdefs.items()}
        p = draw(defs)
        got = apply(cfg, {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
        want = japply(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    xb = torch.from_numpy(x).bfloat16()
    assert layers.apply_norm(cfg, {k: torch.from_numpy(v) for k, v in
                                   draw(layers.norm_defs(cfg, 64)).items()}, xb).dtype == \
        torch.bfloat16


@pytest.mark.parametrize("q_offset,kv_len", [(0, None), (4, 7), (8, 12)])
def test_attention_functions_match_jax_f32(setup, q_offset, kv_len):
    ref, cfg, jcfg, _, _ = setup
    jnp, ja = ref.jnp, ref.attention
    rng = np.random.default_rng(q_offset)
    q = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    j = [jnp.asarray(a) for a in (q, k, v)]
    got = attention.naive_attention(*t, causal=True, q_offset=q_offset, kv_len=kv_len)
    want = ja.naive_attention(*j, causal=True, q_offset=q_offset, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    if kv_len is None:
        got = attention.blockwise_attention(*t, causal=True, chunk=6, q_offset=q_offset)
        want = ja.blockwise_attention(*j, causal=True, chunk=6, q_offset=q_offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)

    p = {name: (0.1 * rng.standard_normal(s)).astype(np.float32) for name, s in
         (("wq", (64, 4, 16)), ("wk", (64, 2, 16)), ("wv", (64, 2, 16)),
          ("wo", (4, 16, 64)), ("bq", (4, 16)), ("bk", (2, 16)), ("bv", (2, 16)))}
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    for a, b in zip(attention.project_qkv(cfg, tp, torch.from_numpy(x)),
                    ja.project_qkv(jcfg, jp, jnp.asarray(x))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    o = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    np.testing.assert_allclose(
        attention.out_proj(cfg, tp, torch.from_numpy(o)).numpy(),
        np.asarray(ja.out_proj(jcfg, jp, jnp.asarray(o))), rtol=0, atol=1e-5)


def _prompt(n=2, s=11, seed=5):
    return np.random.default_rng(seed).integers(0, 256, (n, s)).astype(np.int32)


def test_prefill_matches_jax(setup):
    ref, cfg, jcfg, jparams, tparams = setup
    toks = _prompt()
    jm = ref.Model(jcfg, attn_impl="naive")
    jlog, jcache = ref.jax.jit(lambda p, b: jm.prefill(p, b, cache_len=16))(
        jparams, {"tokens": ref.jnp.asarray(toks)})
    for impl in ("naive", "blockwise"):
        tlog, tcache = Model(cfg, attn_impl=impl, attn_chunk=4).prefill(
            tparams, {"tokens": torch.from_numpy(toks)}, cache_len=16)
        bf16_close(tlog.float(), f32(jlog), f"{impl} logits")
        for key in ("k", "v"):
            got = tcache["stack0"]["attn_0"][key]
            assert got.shape == (2, 2, 16, cfg.num_kv_heads, cfg.head_dim)
            assert got.dtype == torch.bfloat16
            bf16_close(got.float(), f32(jcache["stack0"]["attn_0"][key]), key)


def test_prefill_matches_jax_dense(dense_setup):
    """`test_prefill_matches_jax` on the other dense smoke configs."""
    test_prefill_matches_jax(dense_setup)


def test_prefill_chunk_matches_whole_prefill(setup):
    """Chunked prefill against the port's own whole-prompt prefill and
    against the JAX package's chunked prefill, with a padded last chunk."""
    ref, cfg, jcfg, jparams, tparams = setup
    toks = _prompt(1, 11)
    model = Model(cfg, attn_impl="naive")
    whole, wcache = model.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                  cache_len=16)
    jm = ref.Model(jcfg, attn_impl="naive")
    jchunk = ref.jax.jit(jm.prefill_chunk)
    cache = model.init_cache(1, 16, "cpu")
    jcache = jm.init_cache(1, 16)
    for lo in range(0, 11, 4):
        hi = min(lo + 4, 11)
        chunk = np.pad(toks[:, lo:hi], ((0, 0), (0, 4 - (hi - lo))))
        logits, cache = model.prefill_chunk(tparams, cache,
                                            {"tokens": torch.from_numpy(chunk)}, lo, hi)
        jlogits, jcache = jchunk(jparams, jcache, {"tokens": ref.jnp.asarray(chunk)},
                                 ref.jnp.int32(lo), ref.jnp.int32(hi))
        bf16_close(logits[:, :hi - lo].float(), f32(jlogits)[:, :hi - lo], f"chunk {lo}")
    # the last valid row of the last chunk is whole-prompt prefill's logits
    torch.testing.assert_close(logits[:, 10 - 8].float(), whole.float(),
                               rtol=0, atol=0)
    for key in ("k", "v"):
        got = cache["stack0"]["attn_0"][key][:, :, :11]
        torch.testing.assert_close(got, wcache["stack0"]["attn_0"][key][:, :, :11],
                                   rtol=0, atol=0)
        bf16_close(got.float(), f32(jcache["stack0"]["attn_0"][key])[:, :, :11], key)


def test_prefill_chunk_matches_whole_prefill_dense(dense_setup):
    """`test_prefill_chunk_matches_whole_prefill` on the other dense smoke configs."""
    test_prefill_chunk_matches_whole_prefill(dense_setup)


def _arena_case(kv_dtype, seed=9):
    """Arena cache (L=2, 6 usable pages + null, page 4), a scrambled table
    for 3 slots (slot 1 free), positions and active mask."""
    rng = np.random.default_rng(seed)
    ps, pages, slots, max_pages = 4, 6, 3, 4
    k = rng.standard_normal((2, pages + 1, ps, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, pages + 1, ps, 2, 16)).astype(np.float32)
    tab = np.full((slots, max_pages), pages, np.int32)
    tab[0, :3] = [4, 0, 2]
    tab[2, :2] = [5, 1]
    positions = np.array([9, 0, 6], np.int32)
    active = np.array([True, False, True])
    k = torch.from_numpy(k).bfloat16()
    v = torch.from_numpy(v).bfloat16()
    if kvquant.is_int8(kv_dtype):
        kq, ks = kvquant.quantize_kv_leaf(k)
        vq, vs = kvquant.quantize_kv_leaf(v)
        layer = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        layer = {"k": k, "v": v}
    return layer, tab, positions, active, ps


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_decode_slots_paged_matches_jax(setup, kv_dtype):
    ref, cfg, jcfg, jparams, tparams = setup
    jnp = ref.jnp
    layer, tab, positions, active, ps = _arena_case(kv_dtype)
    toks = np.array([[3], [0], [200]], np.int32)

    def to_jax(t):
        return jnp.asarray(t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy(),
                           jnp.bfloat16 if t.dtype == torch.bfloat16 else None)
    jcache = {"stack0": {"attn_0": {k: to_jax(v) for k, v in layer.items()}},
              "page_table": jnp.asarray(tab)}
    tcache = {"stack0": {"attn_0": {k: v.clone() for k, v in layer.items()}},
              "page_table": torch.from_numpy(tab)}
    jm = ref.Model(jcfg, attn_impl="naive")
    jlog, jnew = ref.jax.jit(jm.decode_slots, static_argnames=("page_size",))(
        jparams, jcache, {"tokens": jnp.asarray(toks)}, jnp.asarray(positions),
        jnp.asarray(active), page_size=ps)
    tlog, tnew = Model(cfg).decode_slots(
        tparams, tcache, {"tokens": torch.from_numpy(toks)},
        torch.from_numpy(positions), torch.from_numpy(active), page_size=ps)
    assert tnew is tcache                       # updated in place
    bf16_close(tlog[torch.from_numpy(active)].float(), f32(jlog)[active], "logits")
    tl, jl = tnew["stack0"]["attn_0"], jnew["stack0"]["attn_0"]
    for key in ("k", "v"):
        got, want = tl[key].float().numpy(), f32(jl[key])
        if kv_dtype == "int8":
            # codes of a row shift when its scale moves by a bf16 rounding
            # difference, so compare what the codes stand for
            got = got * tl[key + "_scale"].numpy()[..., None]
            want = want * f32(jl[key + "_scale"])[..., None]
        bf16_close(got, want, key)
    # only the active slots' new rows changed: slot 0 pos 9 -> page 2 row 1,
    # slot 2 pos 6 -> page 1 row 2; the free slot wrote the null page back
    before = layer["k"].float().numpy()
    after = tnew["stack0"]["attn_0"]["k"].float().numpy()
    changed = {(p, r) for p, r in zip(*np.nonzero(np.any(before != after, axis=(0, 3, 4))))}
    assert changed <= {(2, 1), (1, 2)} and changed


def test_pallas_prefill_matches_jax_kernel_prefill(setup, monkeypatch):
    """Model(attn_impl="pallas").prefill — flash_attention's plain version
    on the CPU — against the JAX package's pallas prefill with its Pallas
    kernel forced on (interpret mode on the CPU), and against the port's
    naive prefill: logits and caches to 2**-5 of the largest |value|."""
    ref, cfg, jcfg, jparams, tparams = setup
    toks = _prompt(2, 11, seed=8)
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    jm = ref.Model(jcfg, attn_impl="pallas")
    jlog, jcache = ref.jax.jit(lambda p, b: jm.prefill(p, b, cache_len=16))(
        jparams, {"tokens": ref.jnp.asarray(toks)})
    tlog, tcache = Model(cfg, attn_impl="pallas").prefill(
        tparams, {"tokens": torch.from_numpy(toks)}, cache_len=16)
    bf16_close(tlog.float(), f32(jlog), "logits")
    for key in ("k", "v"):
        bf16_close(tcache["stack0"]["attn_0"][key].float(),
                   f32(jcache["stack0"]["attn_0"][key]), key)
    nlog, _ = Model(cfg, attn_impl="naive").prefill(
        tparams, {"tokens": torch.from_numpy(toks)}, cache_len=16)
    bf16_close(tlog.float(), nlog.float(), "pallas vs naive")


def test_pallas_prefill_matches_jax_kernel_prefill_dense(dense_setup, monkeypatch):
    """`test_pallas_prefill_matches_jax_kernel_prefill` on the other dense smoke configs."""
    test_pallas_prefill_matches_jax_kernel_prefill(dense_setup, monkeypatch)


def _to_jax(ref, t):
    if t.dtype == torch.bfloat16:
        return ref.jnp.asarray(t.float().numpy(), ref.jnp.bfloat16)
    return ref.jnp.asarray(t.numpy())


def test_decode_step_matches_jax(setup):
    """Model.decode_step (whole batch, every row at one position) against
    the JAX Model.decode_step, teacher-forced over 3 steps from the same
    prefilled cache: logits and caches to 2**-5 of the largest |value|.
    The cache is updated in place; a position past the cache end writes
    its last row, as JAX's clamping dynamic_update_slice does."""
    ref, cfg, jcfg, jparams, tparams = setup
    toks = _prompt(2, 11, seed=4)
    jm = ref.Model(jcfg, attn_impl="naive")
    _, jcache = ref.jax.jit(lambda p, b: jm.prefill(p, b, cache_len=14))(
        jparams, {"tokens": ref.jnp.asarray(toks)})
    tcache = {"stack0": {"attn_0": {k: torch.from_numpy(f32(v)).bfloat16()
                                    for k, v in jcache["stack0"]["attn_0"].items()}}}
    jstep = ref.jax.jit(jm.decode_step)
    model = Model(cfg)
    for i, pos in enumerate((11, 12, 13, 14)):     # 14: past the end, clamped
        tok = np.array([[7 + i], [200 - i]], np.int32)
        jlog, jcache = jstep(jparams, jcache, {"tokens": ref.jnp.asarray(tok)},
                             ref.jnp.int32(pos))
        tlog, new = model.decode_step(tparams, tcache, {"tokens": torch.from_numpy(tok)}, pos)
        assert new is tcache
        bf16_close(tlog.float(), f32(jlog), f"logits at {pos}")
    for key in ("k", "v"):
        bf16_close(tcache["stack0"]["attn_0"][key].float(),
                   f32(jcache["stack0"]["attn_0"][key]), key)


def test_decode_step_matches_jax_dense(dense_setup):
    """`test_decode_step_matches_jax` on the other dense smoke configs."""
    test_decode_step_matches_jax(dense_setup)


def test_apply_layer_decode_matches_jax(setup):
    """One layer of the whole-batch decode against the JAX layer, from the
    same random bf16 cache: output and the written cache rows to 2**-5."""
    ref, cfg, jcfg, jparams, tparams = setup
    from repro.models import transformer as jtr
    from repro_torch.models import transformer as tr
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((3, 1, 64)).astype(np.float32)).bfloat16()
    cache = {k: torch.from_numpy(rng.standard_normal((3, 12, 2, 16)).astype(np.float32)
                                 ).bfloat16() for k in ("k", "v")}
    pos = 7
    jp = ref.jax.tree.map(lambda a: a[0], jparams["decoder"]["stack0"]["attn_0"])
    tp = {k: (v[0] if isinstance(v, torch.Tensor) else {kk: vv[0] for kk, vv in v.items()})
          for k, v in tparams["decoder"]["stack0"]["attn_0"].items()}
    jx, jc = jtr.apply_layer_decode(jcfg, "attn", jp, _to_jax(ref, x),
                                    {k: _to_jax(ref, v) for k, v in cache.items()}, pos,
                                    {"positions": ref.jnp.full((1, 1), pos, ref.jnp.int32)})
    tc = {k: v.clone() for k, v in cache.items()}
    tx, tc2 = tr.apply_layer_decode(cfg, "attn", tp, x, tc, pos,
                                    {"positions": torch.full((1, 1), pos)})
    assert tc2["k"] is tc["k"]
    bf16_close(tx.float(), f32(jx), "x")
    for key in ("k", "v"):
        bf16_close(tc[key].float(), f32(jc[key]), key)
        untouched = [p for p in range(12) if p != pos]
        assert torch.equal(tc[key][:, untouched], cache[key][:, untouched])


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_decode_slots_contiguous_matches_jax(setup, kv_dtype):
    """Slot decode without a page table (slot-contiguous caches, int8 codes
    + scales too) against the JAX decode_slots: logits of the active slots
    and the caches to 2**-5; only the active slots' rows at their positions
    change, in place."""
    ref, cfg, jcfg, jparams, tparams = setup
    jnp = ref.jnp
    rng = np.random.default_rng(10)
    k = torch.from_numpy(rng.standard_normal((2, 3, 12, 2, 16)).astype(np.float32)).bfloat16()
    v = torch.from_numpy(rng.standard_normal((2, 3, 12, 2, 16)).astype(np.float32)).bfloat16()
    if kvquant.is_int8(kv_dtype):
        kq, ks = kvquant.quantize_kv_leaf(k)
        vq, vs = kvquant.quantize_kv_leaf(v)
        layer = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        layer = {"k": k, "v": v}
    positions = np.array([9, 0, 11], np.int32)
    active = np.array([True, False, True])
    toks = np.array([[3], [0], [200]], np.int32)
    jcache = {"stack0": {"attn_0": {n: _to_jax(ref, t) for n, t in layer.items()}}}
    tcache = {"stack0": {"attn_0": {n: t.clone() for n, t in layer.items()}}}
    jlog, jnew = ref.jax.jit(ref.Model(jcfg, attn_impl="naive").decode_slots)(
        jparams, jcache, {"tokens": jnp.asarray(toks)}, jnp.asarray(positions),
        jnp.asarray(active))
    tlog, tnew = Model(cfg).decode_slots(
        tparams, tcache, {"tokens": torch.from_numpy(toks)}, torch.from_numpy(positions),
        torch.from_numpy(active))
    assert tnew is tcache
    bf16_close(tlog[torch.from_numpy(active)].float(), f32(jlog)[active], "logits")
    tl, jl = tnew["stack0"]["attn_0"], jnew["stack0"]["attn_0"]
    for key in ("k", "v"):
        got, want = tl[key].float().numpy(), f32(jl[key])
        if kv_dtype == "int8":
            got = got * tl[key + "_scale"].numpy()[..., None]
            want = want * f32(jl[key + "_scale"])[..., None]
        bf16_close(got, want, key)
    changed = np.any(layer["k"].float().numpy() != tl["k"].float().numpy(), axis=(0, 3, 4))
    assert set(zip(*np.nonzero(changed))) <= {(0, 9), (2, 11)} and changed.any()
