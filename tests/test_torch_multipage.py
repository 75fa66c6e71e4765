"""Multi-page blocks (``kv_pages_per_block > 1``) in the port held to the JAX
package: the superpage-packing allocator, the ppb 2/4 paged kernels' plain
versions against the JAX multi-page kernels in interpret mode (windowed and
not, fp32 and int8 pools), the engine's resolution of ``kv_ppb`` with its
fallback reasons, and greedy streams that do not depend on ppb.

Tables are PACKED as the superpage allocator packs them: each aligned group
of ppb logical pages maps onto an aligned run of ppb contiguous physical
pages, the runs scrambled across the pool. Tolerances: attention outputs
1e-5 in fp32 (the same function, sums in another order); allocator tables,
messages and engine streams exact.
"""
import asyncio
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmapigateway_tpu.config.schemas import LocalEngineConfig as JConfig
from llmapigateway_tpu.engine.engine import InferenceEngine as JEngine
from llmapigateway_tpu.engine.paged import PageAllocator as JAllocator
from llmapigateway_tpu.models import llama as jllama
from llmapigateway_tpu.ops import paged_attention as jpa
from llmapigateway_tpu_torch.config.schemas import LocalEngineConfig
from llmapigateway_tpu_torch.engine.engine import GenRequest, InferenceEngine
from llmapigateway_tpu_torch.engine.paged import PageAllocator
from llmapigateway_tpu_torch.ops import paged_attention as tpa

ATOL = RTOL = 1e-5
PPB = 4                    # tables packed for 4; 1, 2 and 4 all read them


def _t(a):
    return torch.from_numpy(np.array(a))


def _packed(rng, B, NP, KV, page, Dh, quant):
    """Pools [P, KV, page, Dh] (fp32, or the int8 dict from the JAX
    quantizer) and a table packed in runs of PPB with the runs shuffled;
    superpage 0 (the trash run) is never mapped."""
    n_groups = B * (NP // PPB)
    P = (n_groups + 2) * PPB                 # + the trash run and a spare
    sps = np.arange(1, n_groups + 1)
    rng.shuffle(sps)
    table = np.zeros((B, NP), np.int32)
    for b in range(B):
        for g in range(NP // PPB):
            sp = int(sps[b * (NP // PPB) + g])
            table[b, g * PPB:(g + 1) * PPB] = sp * PPB + np.arange(PPB)

    def side():
        x = (rng.standard_normal((P, KV, page, Dh)) * 2).astype(np.float32)
        if not quant:
            return x
        q, s = jllama.quantize_kv(jnp.asarray(x))
        return {"q": np.asarray(q), "s": np.asarray(s)[..., None, :]}
    return side(), side(), table


def _jax(side):
    if isinstance(side, dict):
        return {k: jnp.asarray(v) for k, v in side.items()}
    return jnp.asarray(side)


def _torch(side):
    if isinstance(side, dict):
        return {k: _t(v) for k, v in side.items()}
    return _t(side)


# ---------------------------------------------------------------------------
# The superpage allocator
# ---------------------------------------------------------------------------

def test_superpage_allocator_tables_match_jax():
    """One operation sequence through both allocators: packed aligned runs,
    reservations rounded up to whole runs, the trash superpage never handed
    out, the same LIFO reuse after release, the same refusals."""
    allocs = [PageAllocator(num_pages=14, page_size=16, batch=3, max_seq=64,
                            pages_per_block=2),
              JAllocator(num_pages=14, page_size=16, batch=3, max_seq=64,
                         pages_per_block=2)]

    def same():
        np.testing.assert_array_equal(allocs[0].table, allocs[1].table)
        assert allocs[0].free_pages == allocs[1].free_pages
        for a in allocs:
            a.check_invariants()

    same()
    for a in allocs:
        assert a.pages_needed(20) == 2 and a.pages_needed(33) == 4
        assert a.allocate(0, 20)              # 2 pages: one run
        assert a.allocate(1, 64)              # 4 pages: two runs
        assert a.allocate(2, 33)              # 3 pages rounded up to 4
    same()
    mapped = allocs[0].table[allocs[0].table != 0]
    assert mapped.min() >= 2                  # never the trash superpage
    for a in allocs:
        assert not a.can_admit(64) and a.can_admit(17)
        a.release(1)
        assert a.can_admit(64)
    same()
    for a in allocs:
        assert a.allocate(1, 50)
        a.release(0)
        a.release(2)
    same()
    for a in allocs:
        a.release(1)
    same()
    assert allocs[0].free_pages == 12


@pytest.mark.parametrize("kwargs", [
    dict(num_pages=17, page_size=16, batch=1, max_seq=64, pages_per_block=2),
    dict(num_pages=16, page_size=16, batch=1, max_seq=48, pages_per_block=2),
    dict(num_pages=1, page_size=16, batch=1, max_seq=64)])
def test_superpage_allocator_geometry_errors_match_jax(kwargs):
    msgs = []
    for cls in (PageAllocator, JAllocator):
        with pytest.raises(ValueError) as e:
            cls(**kwargs)
        msgs.append(str(e.value))
    if kwargs["num_pages"] > 1:
        assert msgs[0] == msgs[1]


def test_ring_is_refused_on_a_packed_pool_as_in_jax():
    msgs = []
    for cls in (PageAllocator, JAllocator):
        a = cls(num_pages=16, page_size=16, batch=1, max_seq=64,
                pages_per_block=2)
        with pytest.raises(ValueError, match="superpage packing") as e:
            a.allocate(0, 64, ring_pages=2)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# The ppb 2/4 paged kernels: plain versions against the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ppb", [2, 4])
@pytest.mark.parametrize("window", [0, 24], ids=["full", "windowed"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_multipage_decode_matches_pallas(quant, window, ppb):
    rng = np.random.default_rng(3 * ppb + window + quant)
    B, NP, KV, page, Dh, G = 4, 8, 2, 16, 16, 2
    pk, pv, table = _packed(rng, B, NP, KV, page, Dh, quant)
    # Fresh slot, mid-page, a page boundary, near the table's end.
    n_stale = np.asarray([0, 23, 64, NP * page - 1], np.int32)
    q = rng.standard_normal((B, KV * G, Dh)).astype(np.float32)
    kn = rng.standard_normal((B, KV, Dh)).astype(np.float32)
    vn = rng.standard_normal((B, KV, Dh)).astype(np.float32)
    ref = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), _jax(pk), _jax(pv),
        jnp.asarray(table), jnp.asarray(n_stale), window=window,
        pages_per_block=ppb, interpret=True)
    args = (_t(q), _t(kn), _t(vn), _torch(pk), _torch(pv), _t(table),
            _t(n_stale))
    got = tpa.paged_decode_attention(*args, window=window,
                                     pages_per_block=ppb)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("ppb", [2, 4])
@pytest.mark.parametrize("window", [0, 40], ids=["full", "windowed"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_multipage_prefill_matches_pallas(quant, window, ppb):
    rng = np.random.default_rng(5 * ppb + window + quant)
    B, NP, KV, page, Dh, G, T = 2, 8, 2, 16, 16, 2, 16
    pk, pv, table = _packed(rng, B, NP, KV, page, Dh, quant)
    # The window spans chunk and cache and crosses superpage boundaries.
    start = np.asarray([70, 3], np.int32)
    q = rng.standard_normal((B, T, KV * G, Dh)).astype(np.float32)
    ref = jpa.paged_prefill_attention(
        jnp.asarray(q), _jax(pk), _jax(pv), jnp.asarray(table),
        jnp.asarray(start), block_t=16, window=window, pages_per_block=ppb,
        interpret=True)
    got = tpa.paged_prefill_attention(_t(q), _torch(pk), _torch(pv),
                                      _t(table), _t(start), window=window,
                                      pages_per_block=ppb)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_undividable_geometry_is_refused_as_in_jax():
    q = np.zeros((2, 4, 16), np.float32)
    kv = np.zeros((2, 2, 16), np.float32)
    pool = np.zeros((16, 2, 16, 16), np.float32)
    table = np.zeros((2, 6), np.int32)                 # NP 6: not a run of 4
    n = np.zeros((2,), np.int32)
    msgs = []
    with pytest.raises(ValueError, match="pages_per_block") as e:
        jpa.paged_decode_attention(*(jnp.asarray(a) for a in
                                     (q, kv, kv, pool, pool, table, n)),
                                   pages_per_block=4, interpret=True)
    msgs.append(str(e.value))
    with pytest.raises(ValueError, match="pages_per_block") as e:
        tpa.paged_decode_attention(*(_t(a) for a in
                                     (q, kv, kv, pool, pool, table, n)),
                                   pages_per_block=4)
    msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="pages_per_block must be >= 1"):
        tpa.paged_prefill_attention(_t(q)[:, None], _t(pool), _t(pool),
                                    _t(table), _t(n), pages_per_block=0)


# ---------------------------------------------------------------------------
# The engine: kv_ppb resolution, and streams that do not depend on it
# ---------------------------------------------------------------------------

_BASE = dict(preset="tiny-test", kv_layout="paged", kv_page_size=16,
             max_batch_size=2, max_seq_len=128, prefill_chunk=32,
             prefix_cache=False, dtype="float32")


@pytest.mark.parametrize("knobs", [
    dict(kv_pages_per_block=2),                                # packs
    dict(kv_pages_per_block=3),                                # 8 % 3
    dict(kv_pages_per_block=2, kv_num_pages=33),               # 33 % 2
    dict(kv_pages_per_block=2, preset="tiny-mistral-test",
         prefill_chunk=16),                                    # SWA ring
    dict(kv_pages_per_block=4, preset="tiny-mistral-test",
         prefill_chunk=512),                                   # no ring
], ids=["packs", "per-slot", "num-pages", "ring", "window-no-ring"])
def test_kv_ppb_resolution_matches_jax(knobs, caplog):
    """The resolved ``kv_ppb``, the ring, the pool and the logged fallback
    reason are the JAX engine's for the same config."""
    cfg = {**_BASE, **knobs}
    got = []
    for make in (lambda: JEngine(JConfig(**cfg, attention="reference",
                                         prewarm_sampler_variants=False),
                                 devices=[jax.devices("cpu")[0]]),
                 lambda: InferenceEngine(LocalEngineConfig(**cfg),
                                         device="cpu")):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            eng = make()
        eng._stopped = True
        got.append((eng.kv_ppb, eng._swa_ring_pages,
                    eng.allocator.pages_per_block, eng.allocator.num_pages,
                    [r.getMessage() for r in caplog.records
                     if "kv_pages_per_block" in r.getMessage()]))
    assert got[0] == got[1]
    assert got[1][0] == (knobs["kv_pages_per_block"]
                         if not got[1][4] else 1)


PROMPTS = [np.random.default_rng(i).integers(0, 256, n).tolist()
           for i, n in enumerate((11, 45, 97))]


async def _streams(**cfg):
    eng = InferenceEngine(LocalEngineConfig(**{**_BASE, "max_batch_size": 4,
                                               "max_seq_len": 256, **cfg}),
                          device="cpu")
    reqs = [GenRequest(prompt_ids=list(p), max_tokens=24) for p in PROMPTS]
    for r in reqs:
        await eng.submit(r)
    for r in reqs:
        async for _ in eng.stream(r):
            pass
    await eng.stop()
    eng.allocator.check_invariants()
    assert eng.allocator.free_pages == (eng.allocator.num_pages
                                        - eng.kv_ppb)
    return eng.kv_ppb, [r.generated for r in reqs]


@pytest.mark.parametrize("preset", ["tiny-test", "tiny-mistral-test"])
async def test_ppb2_greedy_streams_equal_ppb1(preset):
    """The same requests through a packed pool (kv_ppb 2) and a per-page
    one give the same greedy tokens, full attention and windowed (the
    window without a ring: a 512-token chunk makes the ring larger than a
    slot, so packing stays on)."""
    cfg = dict(preset=preset, prefill_chunk=512)
    ppb2, tokens2 = await _streams(**cfg, kv_pages_per_block=2)
    ppb1, tokens1 = await _streams(**cfg)
    assert (ppb2, ppb1) == (2, 1)
    assert tokens2 == tokens1


@pytest.mark.cuda
def test_multipage_kernels_equal_per_page_kernel_on_the_card():
    """ppb 2 and 4, bf16 and int8, windowed and not: bit-for-bit the ppb 1
    kernel's output on a packed, shuffled table."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from llmapigateway_tpu_torch.models.llama import quantize_kv
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, KV, G, Dh, page, NP = 3, 2, 4, 128, 16, 16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def quantized(x):
        q, s = quantize_kv(x)
        return {"q": q, "s": s[:, :, None, :].contiguous()}

    n_groups = B * NP // PPB
    sps = torch.randperm(n_groups, generator=gen, device="cuda") + 1
    table = (sps.reshape(B, NP // PPB, 1) * PPB
             + torch.arange(PPB, device="cuda")).reshape(B, NP).to(
        torch.int32).contiguous()
    P = (n_groups + 1) * PPB
    q, kn, vn = rnd(B, KV * G, Dh), rnd(B, KV, Dh), rnd(B, KV, Dh)
    qp = rnd(B, 40, KV * G, Dh)
    n_stale = torch.tensor([0, 77, 255], dtype=torch.int32, device="cuda")
    start = torch.tensor([0, 50, 200], dtype=torch.int32, device="cuda")
    for pk, pv in ((rnd(P, KV, page, Dh), rnd(P, KV, page, Dh)),):
        for k, v in ((pk, pv), (quantized(pk), quantized(pv))):
            for window in (0, 45):
                d1 = tpa.paged_decode_attention(q, kn, vn, k, v, table,
                                                n_stale, window=window)
                p1 = tpa.paged_prefill_attention(qp, k, v, table, start,
                                                 window=window)
                for ppb in (2, 4):
                    assert torch.equal(d1, tpa.paged_decode_attention(
                        q, kn, vn, k, v, table, n_stale, window=window,
                        pages_per_block=ppb))
                    assert torch.equal(p1, tpa.paged_prefill_attention(
                        qp, k, v, table, start, window=window,
                        pages_per_block=ppb))
