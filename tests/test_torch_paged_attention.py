"""The port's paged attention (llmapigateway_tpu_torch/ops/paged_attention.py)
held to the JAX package's on the same numpy-seeded inputs.

The Pallas kernels run in interpret mode, as tests/test_ops_paged.py runs
them on the CPU; the port's wrappers take their plain versions for CPU
tensors. Tolerances: attention outputs 1e-5 in fp32 (the same function,
sums in another order); inserts and gathers bit-exact (pure data movement).
The kernels themselves are held to the plain versions on the card by
chip_smoke.py and by the ``cuda``-marked test at the end of this file.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmapigateway_tpu.ops import paged_attention as jpa
from llmapigateway_tpu_torch.ops import paged_attention as tpa
from test_torch_engine import one_torch_thread  # noqa: F401

ATOL = RTOL = 1e-5


def _pool(rng, B, KV, page, Dh, NP, live_pages, shuffle=True):
    """Random fp32 pool (page 0 = trash, filled with a large value) and a
    page table mapping each slot's live pages to shuffled physical pages;
    entries past a slot's live pages are 0, as the allocator leaves them."""
    P = B * NP + 1
    pk = rng.standard_normal((P, KV, page, Dh)).astype(np.float32)
    pv = rng.standard_normal((P, KV, page, Dh)).astype(np.float32)
    pk[0] = pv[0] = 1e3
    phys = np.arange(1, B * NP + 1)
    if shuffle:
        rng.shuffle(phys)
    table = phys.reshape(B, NP).astype(np.int32)
    for b, n in enumerate(live_pages):
        table[b, n:] = 0
    return pk, pv, table


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("page", [8, 16])
def test_plain_decode_matches_pallas_decode(G, page):
    rng = np.random.default_rng(100 * G + page)
    KV, Dh, NP = 2, 16, 4
    H = KV * G
    n_stale = np.array([0, 1, page - 1, page, page + 1, NP * page - 1],
                       np.int32)
    B = len(n_stale)
    pk, pv, table = _pool(rng, B, KV, page, Dh, NP,
                          [-(-n // page) for n in n_stale])
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    kn = rng.standard_normal((B, KV, Dh)).astype(np.float32)
    vn = rng.standard_normal((B, KV, Dh)).astype(np.float32)

    ref = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(table), jnp.asarray(n_stale),
        interpret=True)
    launches = tpa.paged_decode_attention.launches
    got = tpa.paged_decode_attention(_t(q), _t(kn), _t(vn), _t(pk), _t(pv),
                                     _t(table), _t(n_stale))
    assert tpa.paged_decode_attention.launches == launches  # plain on CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("page", [8, 16])
def test_plain_prefill_matches_pallas_prefill(G, page):
    rng = np.random.default_rng(7 * G + page)
    KV, Dh, NP, T = 2, 16, 6, 16
    H = KV * G
    start = np.array([0, page - 3, page, 2 * page + 5], np.int32)
    B = len(start)
    pk, pv, table = _pool(rng, B, KV, page, Dh, NP,
                          [-(-(s + T) // page) for s in start])
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)

    ref = jpa.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(start), block_t=8, interpret=True)
    got = tpa.paged_prefill_attention(_t(q), _t(pk), _t(pv), _t(table),
                                      _t(start))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_plain_prefill_ragged_chunk_matches_its_prefix():
    """The port passes exact chunk lengths (no power-of-two buckets): a
    ragged T gives the same rows as the same queries inside a longer
    chunk, since causality hides every later query."""
    rng = np.random.default_rng(3)
    B, KV, G, Dh, page, NP = 2, 2, 2, 16, 8, 8
    start = np.array([0, 11], np.int32)
    pk, pv, table = _pool(rng, B, KV, page, Dh, NP, [NP, NP])
    q = _t(rng.standard_normal((B, 16, KV * G, Dh)).astype(np.float32))
    args = (_t(pk), _t(pv), _t(table), _t(start))
    full = tpa.paged_prefill_attention(q, *args)
    ragged = tpa.paged_prefill_attention(q[:, :13].contiguous(), *args)
    np.testing.assert_allclose(ragged.numpy(), full[:, :13].numpy(),
                               atol=ATOL, rtol=RTOL)


def test_dense_decode_attention_matches_jax():
    from llmapigateway_tpu.models.llama import dense_decode_attention as jdd
    from llmapigateway_tpu_torch.models.llama import dense_decode_attention as tdd
    rng = np.random.default_rng(5)
    B, H, KV, Dh, S = 3, 4, 2, 16, 24
    q = rng.standard_normal((B, 1, H, Dh)).astype(np.float32)
    kn = rng.standard_normal((B, 1, KV, Dh)).astype(np.float32)
    vn = rng.standard_normal((B, 1, KV, Dh)).astype(np.float32)
    lk = rng.standard_normal((B, KV, S, Dh)).astype(np.float32)
    lv = rng.standard_normal((B, KV, S, Dh)).astype(np.float32)
    lengths = np.array([0, 7, 24], np.int32)
    active = np.array([True, True, False])
    ref = jdd(*(jnp.asarray(a) for a in (q, kn, vn, lk, lv, lengths, active)))
    got = tdd(*(_t(a) for a in (q, kn, vn, lk, lv, lengths, active)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def _insert_case(seed):
    """Slot 0 active mid-page, slot 1 inactive (its writes go to the trash
    page), slot 2 running off the end of its table (the overflow goes to
    the trash page too) — at trash offsets that do not collide."""
    rng = np.random.default_rng(seed)
    B, T, KV, Dh, page, NP = 3, 4, 2, 8, 8, 4
    pk, pv, table = _pool(rng, B, KV, page, Dh, NP, [NP, NP, NP])
    k_new = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    v_new = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    lengths = np.array([5, 2, NP * page - 2], np.int32)
    active = np.array([True, False, True])
    return pk, pv, table, k_new, v_new, lengths, active


def test_paged_insert_kv_bit_exact_with_trash_redirect():
    pk, pv, table, k_new, v_new, lengths, active = _insert_case(11)
    ref_k, ref_v = jpa.paged_insert_kv(
        *(jnp.asarray(a) for a in (pk, pv, k_new, v_new, table, lengths,
                                   active)))
    got_k, got_v = _t(pk.copy()), _t(pv.copy())
    tpa.paged_insert_kv(got_k, got_v, _t(k_new), _t(v_new), _t(table),
                        _t(lengths), _t(active))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(ref_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    # The masked and overflowing writes landed on the trash page.
    assert not np.array_equal(got_k.numpy()[0], pk[0])
    np.testing.assert_array_equal(got_k.numpy()[table[1]], pk[table[1]])


def test_paged_insert_all_bit_exact_with_trash_redirect():
    pk, pv, table, k_new, v_new, lengths, active = _insert_case(12)
    L = 3
    rng = np.random.default_rng(13)
    pool_k = np.stack([pk + i for i in range(L)])
    pool_v = np.stack([pv - i for i in range(L)])
    k_news = rng.standard_normal((L,) + k_new.shape).astype(np.float32)
    v_news = rng.standard_normal((L,) + v_new.shape).astype(np.float32)
    ref_k, ref_v = jpa.paged_insert_all(
        *(jnp.asarray(a) for a in (pool_k, pool_v, k_news, v_news, table,
                                   lengths, active)))
    got_k, got_v = _t(pool_k.copy()), _t(pool_v.copy())
    tpa.paged_insert_all(got_k, got_v, _t(k_news), _t(v_news), _t(table),
                         _t(lengths), _t(active))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(ref_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))


def test_gather_pages_bit_exact():
    rng = np.random.default_rng(14)
    pk, _, table = _pool(rng, 3, 2, 8, 8, 4, [4, 2, 1])
    for max_seq in (1, 13, 32):
        ref = jpa.gather_pages(jnp.asarray(pk), jnp.asarray(table), max_seq)
        got = tpa.gather_pages(_t(pk), _t(table), max_seq)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_wrappers_refuse_devices_without_a_kernel():
    """A tensor neither on the CPU nor on a CUDA card gets no silent plain
    fallback: the wrapper raises."""
    q = torch.empty((1, 4, 128), device="meta")
    kv = torch.empty((1, 2, 128), device="meta")
    pool = torch.empty((2, 2, 8, 128), device="meta")
    table = torch.empty((1, 1), dtype=torch.int32, device="meta")
    n = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tpa.paged_decode_attention(q, kv, kv, pool, pool, table, n)
    with pytest.raises(ValueError, match="no kernel"):
        tpa.paged_prefill_attention(q[:, None], pool, pool, table, n)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """Both CUDA kernels against their plain versions at a small llama-3
    head geometry (bf16; one output ulp plus summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, KV, G, Dh, page, NP = 3, 2, 4, 128, 32, 4

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    pk, pv = rnd(B * NP + 1, KV, page, Dh), rnd(B * NP + 1, KV, page, Dh)
    table = (torch.randperm(B * NP, generator=gen, device="cuda") + 1).reshape(
        B, NP).to(torch.int32)
    n_stale = torch.tensor([0, 33, 127], dtype=torch.int32, device="cuda")
    q, kn, vn = rnd(B, KV * G, Dh), rnd(B, KV, Dh), rnd(B, KV, Dh)
    args = (q, kn, vn, pk, pv, table, n_stale)
    got = tpa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert (got.float() - tpa._paged_decode_plain(*args).float()).abs().max() \
        <= 2 * 2.0 ** -6
    qp = rnd(B, 45, KV * G, Dh)
    start = torch.tensor([0, 30, 70], dtype=torch.int32, device="cuda")
    got = tpa.paged_prefill_attention(qp, pk, pv, table, start)
    torch.cuda.synchronize()
    ref = tpa._paged_prefill_plain(qp, pk, pv, table, start)
    assert (got.float() - ref.float()).abs().max() <= 2 * 2.0 ** -6
