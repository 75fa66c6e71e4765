"""The port's contiguous-cache attention (llmapigateway_tpu_torch/ops/
flash_attention.py and the cache functions of models/llama.py) held to the
JAX package's on the same numpy-seeded inputs, in both cache types (fp32
values, and int8 values with fp32 per-key scales).

The Pallas kernels run in interpret mode, as tests/test_ops_attention.py and
tests/test_kv_quant.py run them on the CPU; the port's wrappers take their
plain versions for CPU tensors. Tolerances: attention outputs 1e-5 in fp32
(the same function, sums in another order); caches bit-exact (data movement
and the same quantizer). The kernels themselves are held to the plain
versions on the card by chip_smoke.py and by the ``cuda``-marked test at the
end of this file.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmapigateway_tpu.models import llama as jllama
from llmapigateway_tpu.ops import flash_attention as jfa
from llmapigateway_tpu_torch.models import llama as tllama
from llmapigateway_tpu_torch.ops import flash_attention as tfa

ATOL = RTOL = 1e-5
KV, Dh, S, BLOCK = 2, 16, 32, 8
# Stale prefixes: fresh, one key, around a block edge, a full cache less one.
N_STALE = [0, 1, BLOCK - 1, BLOCK, BLOCK + 1, S - 1]


def _t(a):
    return torch.from_numpy(np.array(a))


def _cache(rng, B, quant, S=S):
    """One layer of the cache: fp32 [B, KV, S, Dh], or the int8 dict the JAX
    quantizer makes from fp32 values ([B, KV, 1, S] scales)."""
    x = (rng.standard_normal((B, KV, S, Dh)) * 2).astype(np.float32)
    if not quant:
        return x
    q, s = jllama.quantize_kv(jnp.asarray(x))
    return {"q": np.asarray(q), "s": np.asarray(s)[:, :, None, :]}


def _jax(side):
    if isinstance(side, dict):
        return {k: jnp.asarray(v) for k, v in side.items()}
    return jnp.asarray(side)


def _torch(side):
    if isinstance(side, dict):
        return {k: _t(v) for k, v in side.items()}
    return _t(side)


def _assert_same_cache(got, ref):
    if isinstance(ref, dict):
        for k in ("q", "s"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_plain_decode_matches_pallas_decode(G, quant):
    rng = np.random.default_rng(10 * G + quant)
    B, H = len(N_STALE), KV * G
    lk, lv = _cache(rng, B, quant), _cache(rng, B, quant)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    kn = rng.standard_normal((B, KV, Dh)).astype(np.float32)
    vn = rng.standard_normal((B, KV, Dh)).astype(np.float32)
    n_stale = np.asarray(N_STALE, np.int32)

    ref = jfa.flash_decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), _jax(lk), _jax(lv),
        jnp.asarray(n_stale), block_s=BLOCK, interpret=True)
    launches = tfa.flash_decode_attention.launches
    got = tfa.flash_decode_attention(_t(q), _t(kn), _t(vn), _torch(lk),
                                     _torch(lv), _t(n_stale))
    assert tfa.flash_decode_attention.launches == launches  # plain on CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    # n_stale 0: the self column alone, v_new exactly.
    np.testing.assert_allclose(got.numpy()[0].reshape(KV, G, Dh),
                               np.broadcast_to(vn[0][:, None], (KV, G, Dh)),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("G,T", [(1, 16), (2, 13), (4, 8)])
def test_plain_prefill_matches_pallas_prefill(G, T, quant):
    """Causal chunks from the cache start, mid-block and up to the cache
    end; T 13 is ragged (no power-of-two bucket)."""
    rng = np.random.default_rng(20 * G + T + quant)
    start = np.asarray([0, 5, BLOCK, S - T], np.int32)
    B, H = len(start), KV * G
    lk, lv = _cache(rng, B, quant), _cache(rng, B, quant)
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)

    ref = jfa.flash_prefill_attention(
        jnp.asarray(q), _jax(lk), _jax(lv), jnp.asarray(start), block_t=T,
        block_s=BLOCK, interpret=True)
    launches = tfa.flash_prefill_attention.launches
    got = tfa.flash_prefill_attention(_t(q), _torch(lk), _torch(lv),
                                      _t(start))
    assert tfa.flash_prefill_attention.launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_deferred_decode_step_matches_jax_reference(quant):
    """The exact calls the model makes for T == 1 (``.decode`` over the
    stale cache, then ``.insert_all``), with an inactive row: outputs of the
    active rows at 1e-5, and the stacked cache bit-exact — the inactive
    row's write lands on its row tail, where JAX's clamp puts it."""
    rng = np.random.default_rng(30 + quant)
    B, G = 4, 2
    H = KV * G
    lk, lv = _cache(rng, B, quant), _cache(rng, B, quant)
    q = rng.standard_normal((B, 1, H, Dh)).astype(np.float32)
    kn = rng.standard_normal((B, 1, KV, Dh)).astype(np.float32)
    vn = rng.standard_normal((B, 1, KV, Dh)).astype(np.float32)
    lengths = np.asarray([3, 10, 0, S - 1], np.int32)
    active = np.asarray([True, False, True, True])

    jargs = (jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), _jax(lk),
             _jax(lv), jnp.asarray(lengths), jnp.asarray(active))
    ref = jllama.dense_decode_attention(*jargs)
    stack = (lambda side: {k: v[None] for k, v in side.items()}
             if isinstance(side, dict) else side[None])
    ref_k, ref_v = jllama.insert_kv_stacked(
        stack(_jax(lk)), stack(_jax(lv)), jnp.asarray(kn)[None],
        jnp.asarray(vn)[None], jnp.asarray(lengths), jnp.asarray(active))

    attn = tfa.make_cache_attention_fn()
    got = attn.decode(_t(q), _t(kn), _t(vn), _torch(lk), _torch(lv),
                      _t(lengths), _t(active))
    ck, cv = _torch(stack(lk)), _torch(stack(lv))
    attn.insert_all(ck, cv, _t(kn)[None], _t(vn)[None], _t(lengths),
                    _t(active))
    np.testing.assert_allclose(got.numpy()[active], np.asarray(ref)[active],
                               atol=ATOL, rtol=RTOL)
    _assert_same_cache(ck, ref_k)
    _assert_same_cache(cv, ref_v)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_chunk_path_matches_jax_reference(quant):
    """The prefill chunk path (insert, then attend its own keys — read back
    quantized under int8) against the JAX reference ``dense_cache_attention``
    on the same state: outputs at 1e-5, caches bit-exact."""
    rng = np.random.default_rng(40 + quant)
    B, G, T = 3, 4, 6
    H = KV * G
    lk, lv = _cache(rng, B, quant), _cache(rng, B, quant)
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    kn = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    vn = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    start = np.asarray([0, 11, S - T], np.int32)

    ref, ref_k, ref_v = jllama.dense_cache_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), _jax(lk), _jax(lv),
        jnp.asarray(start))
    for fn in (tfa.make_cache_attention_fn(), tllama.dense_cache_attention):
        ck, cv = _torch(lk), _torch(lv)
        got, _, _ = fn(_t(q), _t(kn), _t(vn), ck, cv, _t(start))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=RTOL)
        _assert_same_cache(ck, ref_k)
        _assert_same_cache(cv, ref_v)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_row_map_reads_and_writes_the_cache_in_place(quant):
    """A prefill call for two slots of a four-slot cache, through the row
    map, equals the JAX engine's way: slice the slots' rows out, run the
    chunk, scatter them back. The other rows stay untouched."""
    rng = np.random.default_rng(50 + quant)
    Bc, G, T = 4, 2, 5
    H = KV * G
    lk, lv = _cache(rng, Bc, quant), _cache(rng, Bc, quant)
    slots = np.asarray([3, 1], np.int32)
    q = rng.standard_normal((2, T, H, Dh)).astype(np.float32)
    kn = rng.standard_normal((2, T, KV, Dh)).astype(np.float32)
    vn = rng.standard_normal((2, T, KV, Dh)).astype(np.float32)
    start = np.asarray([7, 0], np.int32)

    def rows_of(side):
        if isinstance(side, dict):
            return {k: jnp.asarray(v[slots]) for k, v in side.items()}
        return jnp.asarray(side[slots])
    ref, rk, rv = jllama.dense_cache_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), rows_of(lk),
        rows_of(lv), jnp.asarray(start))

    def scattered(side, rows):
        if isinstance(side, dict):
            out = {k: v.copy() for k, v in side.items()}
            for k in out:
                out[k][slots] = np.asarray(rows[k])
            return out
        out = side.copy()
        out[slots] = np.asarray(rows)
        return out

    ck, cv = _torch(lk), _torch(lv)
    got, _, _ = tfa.make_cache_attention_fn(_t(slots))(
        _t(q), _t(kn), _t(vn), ck, cv, _t(start))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    _assert_same_cache(ck, scattered(lk, rk))
    _assert_same_cache(cv, scattered(lv, rv))


def test_prefill_pad_queries_past_the_cache_end_leave_real_rows_alone():
    """A group padded to its longest chunk puts a short row's pads past S:
    their keys are dropped and their queries are the caller's to ignore;
    the real positions' outputs and the cache equal a run of the real
    tokens alone."""
    rng = np.random.default_rng(60)
    G, T, real = 2, 6, 3
    H = KV * G
    lk, lv = _cache(rng, 1, False), _cache(rng, 1, False)
    q = rng.standard_normal((1, T, H, Dh)).astype(np.float32)
    kn = rng.standard_normal((1, T, KV, Dh)).astype(np.float32)
    vn = rng.standard_normal((1, T, KV, Dh)).astype(np.float32)
    start = _t(np.asarray([S - real], np.int32))
    attn = tfa.make_cache_attention_fn()

    pk, pv = _t(lk), _t(lv)
    padded, _, _ = attn(_t(q), _t(kn), _t(vn), pk, pv, start)
    ek, ev = _t(lk), _t(lv)
    exact, _, _ = attn(_t(q[:, :real]), _t(kn[:, :real]), _t(vn[:, :real]),
                       ek, ev, start)
    np.testing.assert_array_equal(pk.numpy(), ek.numpy())
    np.testing.assert_array_equal(pv.numpy(), ev.numpy())
    np.testing.assert_allclose(padded.numpy()[:, :real], exact.numpy(),
                               atol=ATOL, rtol=RTOL)


def test_a_chunk_with_no_keys_gives_zero_not_nan():
    """The ``l == 0`` guard of the Pallas prefill kernel: a row that sees no
    key at all (an empty cache extent) gives 0."""
    q = torch.randn(2, 3, 4, Dh)
    empty = torch.zeros(2, KV, 0, Dh)
    out = tfa.causal_core(q, empty, empty, torch.tensor([0, 0]))
    assert out.shape == (2, 3, 4 * Dh)
    assert torch.equal(out, torch.zeros_like(out))


def test_wrappers_refuse_devices_without_a_kernel():
    """A tensor neither on the CPU nor on a CUDA card gets no silent plain
    fallback: the wrapper raises."""
    q = torch.empty((1, 4, 128), device="meta")
    kv = torch.empty((1, 2, 128), device="meta")
    cache = torch.empty((1, 2, 8, 128), device="meta")
    n = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_decode_attention(q, kv, kv, cache, cache, n)
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_prefill_attention(q[:, None], cache, cache, n)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """Both flash kernels, bf16 and int8, and the int8 bodies of both paged
    kernels, against their plain versions run in fp32 on the same card
    tensors at a small llama-3 head geometry, under the smoke's per-element
    tolerance (one bf16 output rounding plus summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from llmapigateway_tpu_torch.ops import paged_attention as tpa
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, KV_, G, Dh_, S_, page = 3, 2, 4, 128, 256, 32

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def fp32(args):
        return tuple(a.float() for a in args)

    def held(got, ref):
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        assert bool((err <= 2.0 ** -8 * ref.float().abs() + 2.0 ** -14).all())

    def quantized(x):           # [N, KV, S, Dh] → the int8 dict
        q, s = tllama.quantize_kv(x)
        return {"q": q, "s": s[:, :, None, :].contiguous()}

    q, kn, vn = rnd(B, KV_ * G, Dh_), rnd(B, KV_, Dh_), rnd(B, KV_, Dh_)
    n_stale = torch.tensor([0, 33, 255], dtype=torch.int32, device="cuda")
    start = torch.tensor([0, 30, 200], dtype=torch.int32, device="cuda")
    qp = rnd(B, 45, KV_ * G, Dh_)
    rows = torch.tensor([2, 0, 1], dtype=torch.int32, device="cuda")
    ck, cv = rnd(B, KV_, S_, Dh_), rnd(B, KV_, S_, Dh_)
    for lk, lv in ((ck, cv), (quantized(ck), quantized(cv))):
        for r in (None, rows):
            held(tfa.flash_decode_attention(q, kn, vn, lk, lv, n_stale, r),
                 tfa._flash_decode_plain(*fp32((q, kn, vn)), lk, lv,
                                         n_stale, r))
            held(tfa.flash_prefill_attention(qp, lk, lv, start, r),
                 tfa._flash_prefill_plain(qp.float(), lk, lv, start, r))
    pk, pv = rnd(B * 8 + 1, KV_, page, Dh_), rnd(B * 8 + 1, KV_, page, Dh_)
    table = (torch.randperm(B * 8, generator=gen, device="cuda") + 1).reshape(
        B, 8).to(torch.int32)
    pk, pv = quantized(pk), quantized(pv)
    held(tpa.paged_decode_attention(q, kn, vn, pk, pv, table, n_stale),
         tpa._paged_decode_plain(*fp32((q, kn, vn)), pk, pv, table, n_stale))
    held(tpa.paged_prefill_attention(qp, pk, pv, table, start),
         tpa._paged_prefill_plain(qp.float(), pk, pv, table, start))
