"""int8 KV (``kv_quant: "int8"``) in the port held to the JAX package: the
quantizer and all four inserts bit-exact (contiguous ``insert_kv`` /
``insert_kv_stacked``, paged ``paged_insert_kv`` / ``paged_insert_all``) in
both cache types, including the inactive-row tail clamp and a pad position
past the cache end; the int8 bodies of the paged plain versions against the
JAX int8 paged kernels in interpret mode (as tests/test_kv_quant.py runs
them) at fp32 1e-5; and the carrying of a JAX cache into the port's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmapigateway_tpu.models import llama as jllama
from llmapigateway_tpu.models.config import get_preset as jget_preset
from llmapigateway_tpu.ops import paged_attention as jpa
from llmapigateway_tpu_torch.models import llama as tllama
from llmapigateway_tpu_torch.models.convert import kv_cache_from_jax
from llmapigateway_tpu_torch.ops import paged_attention as tpa

ATOL = RTOL = 1e-5
KV, Dh = 2, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _side(rng, shape, quant):
    """A cache side of value shape ``[..., N, Dh]``: fp32, or an int8 dict
    of random values and positive scales ``[..., 1, N]``."""
    if not quant:
        return rng.standard_normal(shape).astype(np.float32)
    return {"q": rng.integers(-127, 128, shape).astype(np.int8),
            "s": rng.uniform(0.01, 0.1, (*shape[:-2], 1, shape[-2])
                             ).astype(np.float32)}


def _jax(side):
    if isinstance(side, dict):
        return {k: jnp.asarray(v) for k, v in side.items()}
    return jnp.asarray(side)


def _torch(side):
    if isinstance(side, dict):
        return {k: _t(v) for k, v in side.items()}
    return _t(side)


def _assert_same(got, ref):
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# The quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_kv_bit_exact(dtype):
    """Random rows over four decades, an all-zero row (scale 1e-30/127),
    a row whose values land on .5 after the division (round half to even)
    and a row with one outlier."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, KV, Dh)) * np.logspace(-2, 2, 5)[
        None, :, None, None]
    x[0, 0] = 0.0
    x[0, 1, 0] = np.arange(Dh) - Dh / 2 + 0.5
    x[0, 1, 0, 0] = 127.0
    x[0, 2, 1, 3] = 1e4
    xj = jnp.asarray(x, dtype)
    ref_q, ref_s = jllama.quantize_kv(xj)
    # bf16 values are exact in fp32, so the port gets the same inputs.
    xt = _t(np.asarray(xj.astype(jnp.float32)))
    got_q, got_s = tllama.quantize_kv(
        xt.to(torch.bfloat16) if dtype == jnp.bfloat16 else xt)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))


# ---------------------------------------------------------------------------
# Contiguous inserts
# ---------------------------------------------------------------------------

S = 24


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_insert_kv_bit_exact_with_inactive_tail_clamp(quant):
    """Active rows mid-cache and up to the last position; an inactive row,
    whose write JAX clamps to the row tail [S-T, S)."""
    rng = np.random.default_rng(1 + quant)
    B, T = 3, 4
    lk, lv = _side(rng, (B, KV, S, Dh), quant), _side(rng, (B, KV, S, Dh),
                                                       quant)
    kn = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    vn = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    lengths = np.asarray([5, 9, S - T], np.int32)
    active = np.asarray([True, False, True])
    ref_k, ref_v = jllama.insert_kv(_jax(lk), _jax(lv), jnp.asarray(kn),
                                    jnp.asarray(vn), jnp.asarray(lengths),
                                    jnp.asarray(active))
    got_k, got_v = _torch(lk), _torch(lv)
    tllama.insert_kv(got_k, got_v, _t(kn), _t(vn), _t(lengths), _t(active))
    _assert_same(got_k, ref_k)
    _assert_same(got_v, ref_v)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_insert_kv_drops_pad_positions_past_the_cache_end(quant):
    """A row 3 tokens from the end given 5 (2 pads past S) writes exactly
    what JAX writes for its 3 real tokens; the pads never shift onto real
    keys (JAX's dynamic_update_slice would move the chunk to S-5 — its
    engine clamps the bucket so that never happens)."""
    rng = np.random.default_rng(3 + quant)
    T, real = 5, 3
    lk, lv = _side(rng, (2, KV, S, Dh), quant), _side(rng, (2, KV, S, Dh),
                                                       quant)
    kn = rng.standard_normal((2, T, KV, Dh)).astype(np.float32)
    vn = rng.standard_normal((2, T, KV, Dh)).astype(np.float32)
    lengths = np.asarray([S - real, 2], np.int32)

    def row(side, b):
        if isinstance(side, dict):
            return {k: jnp.asarray(v[b:b + 1]) for k, v in side.items()}
        return jnp.asarray(side[b:b + 1])

    def stack(a, b):
        if isinstance(a, dict):
            return {k: np.concatenate([a[k], b[k]]) for k in a}
        return np.concatenate([np.asarray(a), np.asarray(b)])

    refs = [jllama.insert_kv(row(lk, 0), row(lv, 0),
                             jnp.asarray(kn[:1, :real]),
                             jnp.asarray(vn[:1, :real]),
                             jnp.asarray(lengths[:1]), None),
            jllama.insert_kv(row(lk, 1), row(lv, 1), jnp.asarray(kn[1:]),
                             jnp.asarray(vn[1:]), jnp.asarray(lengths[1:]),
                             None)]
    to_np = (lambda d: {k: np.asarray(v) for k, v in d.items()}
             if isinstance(d, dict) else np.asarray(d))
    ref_k = stack(to_np(refs[0][0]), to_np(refs[1][0]))
    ref_v = stack(to_np(refs[0][1]), to_np(refs[1][1]))
    got_k, got_v = _torch(lk), _torch(lv)
    tllama.insert_kv(got_k, got_v, _t(kn), _t(vn), _t(lengths), None)
    _assert_same(got_k, ref_k)
    _assert_same(got_v, ref_v)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_insert_kv_stacked_bit_exact(quant):
    """Every layer's token in one scatter per leaf: a decode step with an
    inactive row (tail clamp to S-1) and a row at the last position."""
    rng = np.random.default_rng(5 + quant)
    L, B, T = 3, 4, 1
    ck = _side(rng, (L, B, KV, S, Dh), quant)
    cv = _side(rng, (L, B, KV, S, Dh), quant)
    kn = rng.standard_normal((L, B, T, KV, Dh)).astype(np.float32)
    vn = rng.standard_normal((L, B, T, KV, Dh)).astype(np.float32)
    lengths = np.asarray([0, 7, 3, S - 1], np.int32)
    active = np.asarray([True, True, False, True])
    ref_k, ref_v = jllama.insert_kv_stacked(
        _jax(ck), _jax(cv), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(lengths), jnp.asarray(active))
    got_k, got_v = _torch(ck), _torch(cv)
    tllama.insert_kv_stacked(got_k, got_v, _t(kn), _t(vn), _t(lengths),
                             _t(active))
    _assert_same(got_k, ref_k)
    _assert_same(got_v, ref_v)


# ---------------------------------------------------------------------------
# Paged inserts, gather and the int8 paged plain versions
# ---------------------------------------------------------------------------

def _pool(rng, B, page, NP, quant, live_pages):
    """Pool [P, KV, page, Dh] (page 0 trash) and a shuffled table whose
    entries past each slot's live pages are 0."""
    P = B * NP + 1
    pk = _side(rng, (P, KV, page, Dh), quant)
    pv = _side(rng, (P, KV, page, Dh), quant)
    phys = np.arange(1, P)
    rng.shuffle(phys)
    table = phys.reshape(B, NP).astype(np.int32)
    for b, n in enumerate(live_pages):
        table[b, n:] = 0
    return pk, pv, table


def _paged_insert_case(rng, quant, L=None):
    """Slot 0 active mid-page, slot 1 inactive (trash page), slot 2 running
    off the end of its table (trash page too) — at trash offsets that do
    not collide (a collision's winner is unspecified in both packages)."""
    B, T, page, NP = 3, 4, 8, 4
    pk, pv, table = _pool(rng, B, page, NP, quant, [NP] * B)
    if L:
        pk = _side(rng, (L, B * NP + 1, KV, page, Dh), quant)
        pv = _side(rng, (L, B * NP + 1, KV, page, Dh), quant)
    lead = (L,) if L else ()
    kn = rng.standard_normal((*lead, B, T, KV, Dh)).astype(np.float32)
    vn = rng.standard_normal((*lead, B, T, KV, Dh)).astype(np.float32)
    lengths = np.asarray([5, 2, NP * page - 2], np.int32)
    active = np.asarray([True, False, True])
    return pk, pv, kn, vn, table, lengths, active


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_paged_insert_kv_bit_exact(quant):
    rng = np.random.default_rng(7 + quant)
    case = _paged_insert_case(rng, quant)
    ref_k, ref_v = jpa.paged_insert_kv(*(_jax(a) for a in case))
    pk, pv, kn, vn, table, lengths, active = case
    got_k, got_v = _torch(pk), _torch(pv)
    tpa.paged_insert_kv(got_k, got_v, _t(kn), _t(vn), _t(table),
                        _t(lengths), _t(active))
    _assert_same(got_k, ref_k)
    _assert_same(got_v, ref_v)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_paged_insert_all_bit_exact(quant):
    rng = np.random.default_rng(9 + quant)
    case = _paged_insert_case(rng, quant, L=2)
    ref_k, ref_v = jpa.paged_insert_all(*(_jax(a) for a in case))
    pk, pv, kn, vn, table, lengths, active = case
    got_k, got_v = _torch(pk), _torch(pv)
    tpa.paged_insert_all(got_k, got_v, _t(kn), _t(vn), _t(table),
                         _t(lengths), _t(active))
    _assert_same(got_k, ref_k)
    _assert_same(got_v, ref_v)


def test_int8_gather_and_dequant_bit_exact():
    rng = np.random.default_rng(11)
    pk, _, table = _pool(rng, 3, 8, 4, True, [4, 2, 1])
    for max_seq in (1, 13, 32):
        ref = jpa.gather_pages(_jax(pk), jnp.asarray(table), max_seq)
        got = tpa.gather_pages(_torch(pk), _t(table), max_seq)
        _assert_same(got, ref)
        np.testing.assert_array_equal(
            tpa.dequant_gathered(got, torch.float32).numpy(),
            np.asarray(jpa.dequant_gathered(ref, jnp.float32)))


@pytest.mark.parametrize("G", [1, 2, 4])
def test_int8_plain_paged_decode_matches_pallas(G):
    rng = np.random.default_rng(13 + G)
    page, NP = 8, 4
    n_stale = np.asarray([0, 1, page - 1, page, page + 1, NP * page - 1],
                         np.int32)
    B, H = len(n_stale), KV * G
    pk, pv, table = _pool(rng, B, page, NP, True,
                          [-(-n // page) for n in n_stale])
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    kn = rng.standard_normal((B, KV, Dh)).astype(np.float32)
    vn = rng.standard_normal((B, KV, Dh)).astype(np.float32)
    ref = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), _jax(pk), _jax(pv),
        jnp.asarray(table), jnp.asarray(n_stale), interpret=True)
    launches = tpa.paged_decode_attention.launches
    got = tpa.paged_decode_attention(_t(q), _t(kn), _t(vn), _torch(pk),
                                     _torch(pv), _t(table), _t(n_stale))
    assert tpa.paged_decode_attention.launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_int8_plain_paged_prefill_matches_pallas(G):
    rng = np.random.default_rng(17 + G)
    page, NP, T = 8, 6, 16
    start = np.asarray([0, page - 3, page, 2 * page + 5], np.int32)
    B, H = len(start), KV * G
    pk, pv, table = _pool(rng, B, page, NP, True,
                          [-(-(s + T) // page) for s in start])
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    ref = jpa.paged_prefill_attention(
        jnp.asarray(q), _jax(pk), _jax(pv), jnp.asarray(table),
        jnp.asarray(start), block_t=8, interpret=True)
    got = tpa.paged_prefill_attention(_t(q), _torch(pk), _torch(pv),
                                      _t(table), _t(start))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# A JAX cache carried into the port's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_kv_cache_from_jax(layout, kv_quant):
    from llmapigateway_tpu_torch.models.config import get_preset
    jcfg, tcfg = jget_preset("tiny-test"), get_preset("tiny-test")
    if layout == "contiguous":
        jc = jllama.KVCache.create(jcfg, 2, 16, jnp.bfloat16,
                                   kv_quant=kv_quant)
        want = tllama.KVCache.create(tcfg, 2, 16, torch.bfloat16,
                                     kv_quant=kv_quant)
    else:
        jc = jpa.PagedKVCache.create(jcfg, 5, 8, jnp.bfloat16,
                                     kv_quant=kv_quant)
        want = tpa.PagedKVCache.create(tcfg, 5, 8, torch.bfloat16,
                                       kv_quant=kv_quant)
    rng = np.random.default_rng(19)
    jc = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape) * 50, a.dtype),
        jc)
    got = kv_cache_from_jax(jax.tree.map(np.asarray, jc))
    assert type(got) is type(want)
    for g, w, j in ((got.k, want.k, jc.k), (got.v, want.v, jc.v)):
        leaves = (g.items() if isinstance(g, dict) else [("", g)])
        for key, leaf in leaves:
            ref = w[key] if key else w
            assert leaf.dtype == ref.dtype and leaf.shape == ref.shape
            jleaf = j[key] if key else j
            np.testing.assert_array_equal(
                leaf.float().numpy(), np.asarray(jleaf.astype(jnp.float32)))
