"""Sliding-window models in the port held to the JAX package: the window
variants of the four attention kernels (plain versions against the Pallas
kernels in interpret mode), the windowed dense paths, a ``tiny-mistral-test``
forward, the paged SWA ring allocator, and greedy engine streams in every
(kv_layout, kv_quant) configuration, ring rotation included.

HF Mistral semantics throughout: key ``j`` is visible to the query at
position ``i`` iff ``i - j < window``, the query itself included.
Tolerances: attention outputs 1e-5 in fp32 (the same function, sums in
another order); the forward 1e-4 on fp32 logits (two frameworks' matmuls);
allocator tables exact; engine streams exact against the JAX engine, and a
disagreement settled by the JAX model's own greedy choices (1e-4 ties).
"""
import asyncio
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmapigateway_tpu.engine.paged import PageAllocator as JAllocator
from llmapigateway_tpu.models import llama as jllama
from llmapigateway_tpu.models.config import get_preset as jget_preset
from llmapigateway_tpu.ops import flash_attention as jfa
from llmapigateway_tpu.ops import paged_attention as jpa
from llmapigateway_tpu_torch.config.schemas import LocalEngineConfig
from llmapigateway_tpu_torch.engine.engine import GenRequest, InferenceEngine
from llmapigateway_tpu_torch.engine.paged import PageAllocator
from llmapigateway_tpu_torch.models import llama as tllama
from llmapigateway_tpu_torch.models.config import get_preset
from llmapigateway_tpu_torch.models.convert import params_from_jax
from llmapigateway_tpu_torch.ops import flash_attention as tfa
from llmapigateway_tpu_torch.ops import paged_attention as tpa
from test_torch_engine import (assert_jax_model_greedy, load_jax_params,
                               one_torch_thread, reference_env)  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
ATOL = RTOL = 1e-5
TOL = 1e-4
KV, G, Dh, PAGE, NP = 2, 2, 16, 8, 8
H = KV * G
S = PAGE * NP                                  # 64 positions per slot


def _t(a):
    return torch.from_numpy(np.array(a))


def _side(rng, shape, quant):
    """One cache side of fp32 values, or the int8 dict the JAX quantizer
    makes of them (scales [.., KV, 1, N])."""
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    if not quant:
        return x
    q, s = jllama.quantize_kv(jnp.asarray(x))
    return {"q": np.asarray(q), "s": np.asarray(s)[..., None, :]}


def _jax(side):
    if isinstance(side, dict):
        return {k: jnp.asarray(v) for k, v in side.items()}
    return jnp.asarray(side)


def _torch(side):
    if isinstance(side, dict):
        return {k: _t(v) for k, v in side.items()}
    return _t(side)


def _ring_table(rng, B, first_pages, last_pages):
    """A shuffled page table in which slot b maps only logical pages
    [first_pages[b], last_pages[b]) — what the SWA ring leaves mapped: the
    pages wholly below the window are 0 (the trash page), and the kernels
    must never need them."""
    phys = np.arange(1, B * NP + 1)
    rng.shuffle(phys)
    table = phys.reshape(B, NP).astype(np.int32)
    for b in range(B):
        table[b, :first_pages[b]] = 0
        table[b, last_pages[b]:] = 0
    return table


def _n_stale(window):
    """Ragged lengths around the window: fresh, one key, window - 1,
    window, window + 1, mid-cache, one short of the end."""
    return np.asarray([0, 1, window - 1, window, window + 1, 37, S - 1],
                      np.int32)


# ---------------------------------------------------------------------------
# The window variants of kernels #1-#4: plain versions against Pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("window", [16, 24])
def test_paged_decode_window_matches_pallas(window, quant):
    rng = np.random.default_rng(window + 2 * quant)
    n_stale = _n_stale(window)
    B = len(n_stale)
    w0 = np.maximum(n_stale - (window - 1), 0)
    table = _ring_table(rng, B, w0 // PAGE, -(-n_stale // PAGE))
    pk = _side(rng, (B * NP + 1, KV, PAGE, Dh), quant)
    pv = _side(rng, (B * NP + 1, KV, PAGE, Dh), quant)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    kn = rng.standard_normal((B, KV, Dh)).astype(np.float32)
    vn = rng.standard_normal((B, KV, Dh)).astype(np.float32)
    ref = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), _jax(pk), _jax(pv),
        jnp.asarray(table), jnp.asarray(n_stale), window=window,
        interpret=True)
    got = tpa.paged_decode_attention(_t(q), _t(kn), _t(vn), _torch(pk),
                                     _torch(pv), _t(table), _t(n_stale),
                                     window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("window", [16, 24])
def test_paged_prefill_window_matches_pallas(window, quant):
    rng = np.random.default_rng(10 + window + 2 * quant)
    T = 16
    start = np.asarray([0, window - 3, window + 5, 40], np.int32)
    B = len(start)
    floor = np.maximum(start - (window - 1), 0)
    table = _ring_table(rng, B, floor // PAGE, -(-(start + T) // PAGE))
    pk = _side(rng, (B * NP + 1, KV, PAGE, Dh), quant)
    pv = _side(rng, (B * NP + 1, KV, PAGE, Dh), quant)
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    ref = jpa.paged_prefill_attention(
        jnp.asarray(q), _jax(pk), _jax(pv), jnp.asarray(table),
        jnp.asarray(start), block_t=8, window=window, interpret=True)
    got = tpa.paged_prefill_attention(_t(q), _torch(pk), _torch(pv),
                                      _t(table), _t(start), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("window", [16, 24])
def test_flash_decode_window_matches_pallas(window, quant):
    rng = np.random.default_rng(20 + window + 2 * quant)
    n_stale = _n_stale(window)
    B = len(n_stale)
    lk, lv = (_side(rng, (B, KV, S, Dh), quant) for _ in "kv")
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    kn = rng.standard_normal((B, KV, Dh)).astype(np.float32)
    vn = rng.standard_normal((B, KV, Dh)).astype(np.float32)
    ref = jfa.flash_decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), _jax(lk), _jax(lv),
        jnp.asarray(n_stale), block_s=8, window=window, interpret=True)
    got = tfa.flash_decode_attention(_t(q), _t(kn), _t(vn), _torch(lk),
                                     _torch(lv), _t(n_stale), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("window", [16, 24])
def test_flash_prefill_window_matches_pallas(window, quant):
    rng = np.random.default_rng(30 + window + 2 * quant)
    T = 16
    start = np.asarray([0, window - 3, window + 5, 40], np.int32)
    B = len(start)
    lk, lv = (_side(rng, (B, KV, S, Dh), quant) for _ in "kv")
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    ref = jfa.flash_prefill_attention(
        jnp.asarray(q), _jax(lk), _jax(lv), jnp.asarray(start), block_t=8,
        block_s=8, window=window, interpret=True)
    got = tfa.flash_prefill_attention(_t(q), _torch(lk), _torch(lv),
                                      _t(start), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_negative_window_is_refused():
    q = torch.zeros((1, H, Dh))
    kv = torch.zeros((1, KV, Dh))
    cache = torch.zeros((1, KV, S, Dh))
    n = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="window must be >= 0"):
        tfa.flash_decode_attention(q, kv, kv, cache, cache, n, window=-1)


# ---------------------------------------------------------------------------
# The windowed dense paths (the plain references and the CPU path)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_windowed_dense_decode_matches_jax(quant):
    rng = np.random.default_rng(41 + quant)
    window = 16
    lengths = _n_stale(window)
    B = len(lengths)
    lk, lv = (_side(rng, (B, KV, S, Dh), quant) for _ in "kv")
    q = rng.standard_normal((B, 1, H, Dh)).astype(np.float32)
    kn = rng.standard_normal((B, 1, KV, Dh)).astype(np.float32)
    vn = rng.standard_normal((B, 1, KV, Dh)).astype(np.float32)
    active = np.asarray([True] * (B - 1) + [False])
    ref = jllama.dense_decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), _jax(lk), _jax(lv),
        jnp.asarray(lengths), jnp.asarray(active), window=window)
    got = tllama.dense_decode_attention(
        _t(q), _t(kn), _t(vn), _torch(lk), _torch(lv), _t(lengths),
        _t(active), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_windowed_dense_cache_attention_matches_jax(quant):
    """Insert-then-attend of a chunk that crosses the window, through the
    memoized windowed provider that ``forward`` swaps in."""
    rng = np.random.default_rng(43 + quant)
    window, T = 16, 12
    start = np.asarray([0, 20, 45], np.int32)
    B = len(start)
    lk, lv = (_side(rng, (B, KV, S, Dh), quant) for _ in "kv")
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    kn = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    vn = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    jfn = jllama.windowed_dense_attention(window)
    ref, ref_k, _ = jfn(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                        _jax(lk), _jax(lv), jnp.asarray(start))
    tfn = tllama.windowed_dense_attention(window)
    assert tfn is tllama.windowed_dense_attention(window)
    got, got_k, _ = tfn(_t(q), _t(kn), _t(vn), _torch(lk), _torch(lv),
                        _t(start))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    if quant:
        np.testing.assert_array_equal(got_k["q"].numpy(),
                                      np.asarray(ref_k["q"]))
    else:
        np.testing.assert_array_equal(got_k.numpy(), np.asarray(ref_k))


def test_tiny_mistral_forward_matches_jax():
    """A prefill chunk past the window (16) and two deferred decode steps
    of ``tiny-mistral-test``, weights carried by ``params_from_jax``: the
    dense default provider (which forward swaps for the windowed one) and
    the paged provider with the window, against the JAX forward."""
    jcfg, cfg = jget_preset("tiny-mistral-test"), get_preset(
        "tiny-mistral-test")
    assert cfg.sliding_window == jcfg.sliding_window == 16
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(5),
                                 dtype=jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(6)
    B, T, page, n_pages = 2, 40, 16, 4
    start = np.asarray([0, 7], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, (2, B, 1)).astype(np.int32)
    table = rng.permutation(np.arange(1, B * n_pages + 1)).reshape(
        B, n_pages).astype(np.int32)

    def jrun(cache, attn):
        kw = {} if attn is None else {"attention_fn": attn}
        outs = []
        lengths = start
        logits, cache = jllama.forward(jparams, jcfg, jnp.asarray(tokens),
                                       jnp.asarray(lengths), cache, **kw)
        outs.append(np.asarray(logits))
        lengths = lengths + T
        for step in steps:
            logits, cache = jllama.forward(jparams, jcfg, jnp.asarray(step),
                                           jnp.asarray(lengths), cache, **kw)
            outs.append(np.asarray(logits))
            lengths = lengths + 1
        return outs

    def trun(cache, attn):
        outs = []
        lengths = _t(start)
        logits, cache = tllama.forward(tparams, cfg, _t(tokens), lengths,
                                       cache, attention_fn=attn)
        outs.append(logits.numpy())
        lengths = lengths + T
        for step in steps:
            logits, cache = tllama.forward(tparams, cfg, _t(step), lengths,
                                           cache, attention_fn=attn)
            outs.append(logits.numpy())
            lengths = lengths + 1
        return outs

    ref = jrun(jllama.KVCache.create(jcfg, B, 64, dtype=jnp.float32), None)
    dense = trun(tllama.KVCache.create(cfg, B, 64, torch.float32),
                 tllama.dense_cache_attention)
    paged = trun(tpa.PagedKVCache.create(cfg, B * n_pages + 1, page,
                                         torch.float32),
                 tpa.make_paged_attention_fn(_t(table), cfg.sliding_window))
    for r, d, p in zip(ref, dense, paged):
        np.testing.assert_allclose(d, r, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(p, r, atol=TOL, rtol=TOL)
    # The window changes the function: full attention gives other logits.
    full = trun(tllama.KVCache.create(cfg, B, 64, torch.float32),
                tllama.windowed_dense_attention(10 ** 6))
    assert not np.allclose(full[-1], ref[-1], atol=1e-3)


# ---------------------------------------------------------------------------
# The SWA page ring
# ---------------------------------------------------------------------------

def test_ring_allocator_matches_jax_rotation_and_invariants():
    """The JAX package's ring test (tests/test_engine_paged.py
    test_ring_allocator_rotation_and_invariants), driven through both
    allocators: the same tables after every operation, the same "ring
    exhausted" refusal, every page back after release."""
    allocs = [PageAllocator(num_pages=8, page_size=16, batch=2, max_seq=256),
              JAllocator(num_pages=8, page_size=16, batch=2, max_seq=256)]

    def same_tables():
        np.testing.assert_array_equal(allocs[0].table, allocs[1].table)
        assert allocs[0].free_pages == allocs[1].free_pages
        for a in allocs:
            a.check_invariants()

    for a in allocs:
        assert a.pages_per_slot == 16
        assert a.pages_needed(256, ring_pages=4) == 4
        assert a.allocate(0, total_tokens=256, ring_pages=4)
        assert len(a._held[0]) == 4 and 0 in a._ring_slots
    same_tables()
    row0 = list(allocs[0].table[0][:4])
    for a in allocs:
        assert a.ensure_mapped(0, last_logical=5, dead_before=2)
    same_tables()
    assert list(allocs[0].table[0][2:6]) == [row0[2], row0[3], row0[0],
                                             row0[1]]
    msgs = []
    for a in allocs:
        with pytest.raises(RuntimeError, match="ring exhausted") as e:
            a.ensure_mapped(0, last_logical=7, dead_before=2)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    for a in allocs:
        # A short request needs no ring; rotation is a no-op for it.
        assert a.allocate(1, total_tokens=40, ring_pages=4)
        assert 1 not in a._ring_slots
        assert not a.ensure_mapped(1, last_logical=9, dead_before=5)
    same_tables()
    for a in allocs:
        a.release(0)
        a.release(1)
    same_tables()
    assert allocs[0].free_pages == 7


# ---------------------------------------------------------------------------
# Greedy engine streams against the JAX engine
# ---------------------------------------------------------------------------

GEOMETRY = dict(preset="tiny-mistral-test", kv_page_size=16,
                max_batch_size=4, max_seq_len=256, prefill_chunk=32,
                dtype="float32")
# (kv_layout, kv_quant): every combination the port serves. The default
# prefix_cache=true stays: inert for a sliding-window model, as in JAX.
CONFIGS = [("paged", ""), ("paged", "int8"), ("contiguous", ""),
           ("contiguous", "int8")]
# Prompts within one page, across two chunks, and past the 6-page ring
# (96 tokens); 24 generated tokens slide the window (16) across pages.
PROMPTS = [np.random.default_rng(i).integers(0, 256, n).tolist()
           for i, n in enumerate((11, 45, 97))]
# The JAX package's small-pool ring case (tests/test_engine_paged.py
# test_swa_ring_serves_full_context_from_small_pool): per_slot is 16 pages
# of which the pool's 11 usable could not hold one; the ring is 5.
SMALL_POOL = dict(preset="tiny-mistral-test", kv_page_size=16,
                  max_batch_size=2, max_seq_len=256, prefill_chunk=16,
                  decode_burst=4, dtype="float32", kv_layout="paged",
                  kv_num_pages=12)
SMALL_POOL_PROMPT = list(("state rolls across many pages " * 4).encode())


def _jobs():
    """(name, geometry, prompts, max_tokens) of every stream comparison."""
    jobs = [(f"{lay}-{q or 'float'}",
             {**GEOMETRY, "kv_layout": lay, "kv_quant": q}, PROMPTS, 24)
            for lay, q in CONFIGS]
    jobs.append(("small-pool", SMALL_POOL, [SMALL_POOL_PROMPT], 96))
    return jobs


# The JAX engine's greedy streams come from a FRESH process, on one XLA:CPU
# thread with the compilation cache off (test_torch_engine.reference_env).
# The JAX engine is not a clean oracle on the CPU backend: its streams vary
# between runs, more often under load (test_torch_engine.py), so a
# disagreement is settled by the JAX model, teacher-forced on the port's
# stream (assert_jax_model_greedy, window and KV type included). One process
# serves every job in turn, each on its own engine, started when the
# module's first test runs so that it overlaps the kernel tests; it serves
# one request at a time for the small-pool case (as the JAX test serves it)
# and saves the params, the same for every job, for the port.
_JAX_STREAMS = r"""
import asyncio, json, sys
import jax
import numpy as np
jax.config.update("jax_platforms", "cpu")
from llmapigateway_tpu.config.schemas import LocalEngineConfig
from llmapigateway_tpu.engine.engine import GenRequest, InferenceEngine

jobs, params_path = json.loads(sys.argv[1])

async def serve(geometry, prompts, max_tokens):
    eng = InferenceEngine(LocalEngineConfig(**geometry, attention="reference",
                                            prewarm_sampler_variants=False),
                          devices=[jax.devices("cpu")[0]])
    reqs = [GenRequest(prompt_ids=p, max_tokens=max_tokens) for p in prompts]
    texts = []
    if len(prompts) == 1:
        await eng.submit(reqs[0])
        texts.append("".join([d.text async for d in eng.stream(reqs[0])]))
    else:
        for r in reqs:
            await eng.submit(r)
        texts = ["".join([d.text async for d in eng.stream(r)]) for r in reqs]
    await eng.stop()
    return eng, {"tokens": [r.generated for r in reqs],
                 "finish": [r.finish_reason for r in reqs], "texts": texts,
                 "ring": eng._swa_ring_pages, "kv_ppb": eng.kv_ppb}

async def run():
    out = {}
    for name, geometry, prompts, max_tokens in jobs:
        eng, out[name] = await serve(geometry, prompts, max_tokens)
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in
            jax.tree_util.tree_flatten_with_path(eng.params)[0]}
    np.savez(params_path, **flat)
    return out

print(json.dumps(asyncio.run(run())))
"""


def _start_jax_streams(jobs, params_path) -> subprocess.Popen:
    """One fresh JAX process serving ``jobs`` in turn; it saves the params
    at ``params_path``."""
    return subprocess.Popen(
        [sys.executable, "-c", _JAX_STREAMS,
         json.dumps([jobs, str(params_path)])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=reference_env())


def _finish_jax_streams(proc: subprocess.Popen) -> dict:
    """{job name: streams} of a process from :func:`_start_jax_streams`."""
    stdout, stderr = proc.communicate(timeout=400)
    assert proc.returncode == 0, stderr[-4000:]
    return json.loads(stdout.strip().splitlines()[-1])




@pytest.fixture(scope="module", autouse=True)
def _jax_streams_started(tmp_path_factory):
    """The reference process, started with the module's first test."""
    params_path = tmp_path_factory.mktemp("jax") / "params.npz"
    proc = _start_jax_streams(_jobs(), params_path)
    yield proc, params_path
    if proc.poll() is None:         # no test asked for the streams
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_streams(_jax_streams_started):
    proc, params_path = _jax_streams_started
    return _finish_jax_streams(proc), params_path


async def _port_streams(geometry, prompts, max_tokens, params):
    eng = InferenceEngine(LocalEngineConfig(**geometry), device="cpu")
    eng.params = params
    reqs = [GenRequest(prompt_ids=list(p), max_tokens=max_tokens)
            for p in prompts]
    rotations = []
    if eng.allocator is not None:
        # Record every change of a table row (ring rotation).
        ensure = eng.allocator.ensure_mapped

        def recording(slot, last, dead):
            changed = ensure(slot, last, dead)
            rotations.append(changed)
            held = np.count_nonzero(eng.allocator.table[slot])
            assert held <= (eng._swa_ring_pages or held)
            return changed
        eng.allocator.ensure_mapped = recording
    texts = []
    if len(prompts) == 1:
        await eng.submit(reqs[0])
        texts.append("".join([d.text async for d in eng.stream(reqs[0])]))
    else:
        for r in reqs:
            await eng.submit(r)
        texts = ["".join([d.text async for d in eng.stream(r)]) for r in reqs]
    await eng.stop()
    return eng, {"tokens": [r.generated for r in reqs],
                 "finish": [r.finish_reason for r in reqs], "texts": texts,
                 "ring": eng._swa_ring_pages, "kv_ppb": eng.kv_ppb}, rotations


@pytest.mark.parametrize("job", [j[0] for j in _jobs()])
async def test_greedy_streams_match_jax_engine(job, jax_streams):
    """Each configuration streams the JAX engine's greedy tokens. On the
    paged layout the SWA ring engages (6 pages a slot; 5 in the small pool)
    and rotates in prefill and in decode; the pool gets every page back."""
    results, params_path = jax_streams
    name, geometry, prompts, max_tokens = next(j for j in _jobs()
                                               if j[0] == job)
    jparams = load_jax_params(params_path)
    eng, port, rotations = await _port_streams(
        geometry, prompts, max_tokens, params_from_jax(jparams))
    expected = results[name]
    if port != expected:            # the JAX model adjudicates
        await asyncio.to_thread(assert_jax_model_greedy, jparams, geometry,
                                prompts, port["tokens"])
    assert port["ring"] == expected["ring"]
    if geometry["kv_layout"] == "paged":
        assert eng._swa_ring_pages == (5 if name == "small-pool" else 6)
        assert any(rotations), "the ring never rotated"
        eng.allocator.check_invariants()
        assert eng.allocator.free_pages == eng.allocator.num_pages - 1
    else:
        assert eng.allocator is None and eng._swa_ring_pages == 0
    if name == "small-pool":
        assert len(port["tokens"][0]) == 96


def test_paged_sliding_window_builds_with_prefix_cache_default():
    """prefix_cache=true is inert for a sliding-window model on the paged
    layout (JAX engine.py:720-725): it builds, with the SWA ring and no
    cache; a full-attention model's paged prefix_cache=true builds a live
    cache over its pool."""
    eng = InferenceEngine(LocalEngineConfig(
        **{**GEOMETRY, "kv_layout": "paged", "prefix_cache": True}),
        device="cpu")
    assert eng.cfg.prefix_cache and eng.paged and eng._swa_ring_pages == 6
    assert eng._prefix_cache is None
    full = InferenceEngine(LocalEngineConfig(
        **{**GEOMETRY, "preset": "tiny-test", "kv_layout": "paged",
           "prefix_cache": True}), device="cpu")
    assert full._prefix_cache is not None
    assert full._prefix_cache.allocator is full.allocator


@pytest.mark.cuda
def test_window_kernels_match_plain_versions_on_the_card():
    """The window variants of all four kernels, bf16, against their plain
    versions run in fp32 on the same card tensors (one bf16 output rounding
    plus summation order), with a window that is no multiple of the key
    tile or the page, and a page smaller than the key tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, KV_, G_, Dh_, S_, page, window = 4, 2, 4, 128, 256, 16, 45

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def held(got, ref):
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        assert bool((err <= 2.0 ** -8 * ref.float().abs() + 2.0 ** -14).all())

    q, kn, vn = rnd(B, KV_ * G_, Dh_), rnd(B, KV_, Dh_), rnd(B, KV_, Dh_)
    n_stale = torch.tensor([0, 44, 46, 255], dtype=torch.int32, device="cuda")
    start = torch.tensor([0, 30, 150, 200], dtype=torch.int32, device="cuda")
    qp = rnd(B, 50, KV_ * G_, Dh_)
    ck, cv = rnd(B, KV_, S_, Dh_), rnd(B, KV_, S_, Dh_)
    held(tfa.flash_decode_attention(q, kn, vn, ck, cv, n_stale,
                                    window=window),
         tfa._flash_decode_plain(q.float(), kn.float(), vn.float(),
                                 ck.float(), cv.float(), n_stale,
                                 window=window))
    held(tfa.flash_prefill_attention(qp, ck, cv, start, window=window),
         tfa._flash_prefill_plain(qp.float(), ck.float(), cv.float(), start,
                                  window=window))
    NP_ = S_ // page
    pk, pv = rnd(B * NP_ + 1, KV_, page, Dh_), rnd(B * NP_ + 1, KV_, page, Dh_)
    table = (torch.randperm(B * NP_, generator=gen, device="cuda") + 1
             ).reshape(B, NP_).to(torch.int32)
    held(tpa.paged_decode_attention(q, kn, vn, pk, pv, table, n_stale,
                                    window=window),
         tpa._paged_decode_plain(q.float(), kn.float(), vn.float(),
                                 pk.float(), pv.float(), table, n_stale,
                                 window))
    held(tpa.paged_prefill_attention(qp, pk, pv, table, start, window=window),
         tpa._paged_prefill_plain(qp.float(), pk.float(), pv.float(), table,
                                  start, window))
