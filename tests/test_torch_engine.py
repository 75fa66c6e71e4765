"""The port's engine (llmapigateway_tpu_torch/engine/engine.py) held to the
JAX engine: with the same ``tiny-test`` weights, the same KV geometry and
greedy decoding, concurrent requests whose prompts cross KV pages and
prefill chunks must stream the same tokens, token for token — on the paged
and the contiguous layout, with bf16-layout (here fp32) and int8 KV, and
with the prefix cache serving later requests from resident blocks. fp32
weights and activations on both sides, so only summation order differs.
Where the JAX engine's stream disagrees, the JAX model settles it: every
port token must be its greedy choice, teacher-forced (see TOL)."""
import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmapigateway_tpu.config.schemas import LocalEngineConfig as JConfig
from llmapigateway_tpu.engine.engine import GenRequest as JRequest
from llmapigateway_tpu.engine.engine import InferenceEngine as JEngine
from llmapigateway_tpu.engine.paged import PageAllocator as JAllocator
from llmapigateway_tpu.engine.prefix_cache import RadixPrefixCache as JCache
from llmapigateway_tpu.models import llama as jllama
from llmapigateway_tpu.models.config import get_preset as jget_preset
from llmapigateway_tpu.ops.paged_attention import (
    PagedKVCache as JPagedKVCache, make_paged_attention_fn as jmake_paged)
from llmapigateway_tpu_torch.config.schemas import LocalEngineConfig
from llmapigateway_tpu_torch.engine.engine import (GenRequest,
                                                   InferenceEngine)
from llmapigateway_tpu_torch.models import llama as tllama
from llmapigateway_tpu_torch.models.config import get_preset
from llmapigateway_tpu_torch.models.convert import params_from_jax
from llmapigateway_tpu_torch.ops.paged_attention import (
    PagedKVCache, make_paged_attention_fn)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch while a module runs (then the thread
    count it found): the port's CPU tests run small tensors, and six pytest
    workers each running torch's default of one thread per core, beside
    XLA's own pools, spend the cores waiting on each other (the heavy port
    files ran 25% longer so). Import it into a test module to apply it
    there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
GEOMETRY = dict(preset="tiny-test", kv_layout="paged", kv_page_size=16,
                prefix_cache=False, max_batch_size=4, max_seq_len=256,
                prefill_chunk=32, dtype="float32")
# Prompt lengths: within one page, across pages and one chunk boundary,
# across several chunk boundaries.
PROMPTS = [np.random.default_rng(i).integers(0, 256, n).tolist()
           for i, n in enumerate((11, 45, 97))]


# (kv_layout, kv_quant): every combination the port serves.
CONFIGS = [("paged", ""), ("paged", "int8"), ("contiguous", ""),
           ("contiguous", "int8")]


def _geometry(layout, kv_quant):
    geometry = {**GEOMETRY, "kv_layout": layout, "kv_quant": kv_quant}
    if layout == "contiguous":
        # The JAX default prefix_cache=true, inert on this layout there and
        # here (engine._refuse_unported).
        del geometry["prefix_cache"]
    return geometry


# The JAX engine is not a clean oracle on the CPU backend: its greedy
# streams for the same requests vary between runs, in one process and
# between fresh ones, and more often under load. Under the whole suite's
# load (pytest-xdist, six workers) the first prompt's JAX stream once left
# the port's at its sixth token, in the in-process engine and in three
# fresh processes in a row, choosing 181 where the JAX model's own
# teacher-forced logits rank 139 first by 0.105 (0.9705 against 0.8656):
# not a near tie but a reference computed otherwise. The same happens with
# XLA:CPU on one thread, with the compilation cache off, with synchronous
# dispatch and with requests served one at a time (1 to 4 of 8 fresh
# processes beside four busy cores); the port's streams never varied.
# So a disagreement with the JAX engine is settled by the JAX MODEL, which
# one forward call computes (assert_jax_model_greedy): every port token
# must be the JAX model's greedy choice, teacher-forced on the port's
# stream. The fresh JAX processes run on one XLA:CPU thread with the
# compilation cache off, so that they load no program another process
# compiled and crowd the suite's workers less.
TOL = 1e-4      # fp32 logits through two frameworks (test_torch_llama.py)


def reference_env() -> dict:
    """The environment of a fresh JAX reference process: XLA:CPU on one
    thread (Eigen's thread pool off) and the compilation cache disabled."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_"
                        "eigen=false intra_op_parallelism_threads=1").strip()
    env["JAX_ENABLE_COMPILATION_CACHE"] = "false"
    return env


def assert_jax_model_greedy(jparams, geometry, prompts, streams, page=16):
    """Each port stream is the JAX model's own greedy continuation of its
    prompt. Teacher-forced over prompt + stream in one forward call, the
    JAX model (reference attention, the geometry's KV type and window) and
    the port's give logits within TOL of each other, and at every generated
    position the port's token has the largest JAX logit, or one within TOL
    of it (a near tie). ``jparams``: the JAX params as numpy arrays."""
    jcfg = jget_preset(geometry["preset"])
    tcfg = get_preset(geometry["preset"])
    tparams = params_from_jax(jparams)
    kv_quant = geometry.get("kv_quant", "")
    for prompt, tokens in zip(prompts, streams):
        seq = list(prompt) + list(tokens[:-1])
        n_pages = -(-len(seq) // page)
        table = np.arange(1, n_pages + 1, dtype=np.int32)[None]
        jlog, _ = jllama.forward(
            jparams, jcfg, jnp.asarray([seq], jnp.int32),
            jnp.zeros((1,), jnp.int32),
            JPagedKVCache.create(jcfg, n_pages + 1, page, dtype=jnp.float32,
                                 kv_quant=kv_quant),
            attention_fn=jmake_paged(jnp.asarray(table),
                                     max_seq=n_pages * page, impl="reference",
                                     window=jcfg.sliding_window))
        tlog, _ = tllama.forward(
            tparams, tcfg, torch.tensor([seq]),
            torch.zeros(1, dtype=torch.int32),
            PagedKVCache.create(tcfg, n_pages + 1, page, torch.float32,
                                kv_quant=kv_quant),
            attention_fn=make_paged_attention_fn(torch.from_numpy(table),
                                                 tcfg.sliding_window))
        rows = slice(len(prompt) - 1, len(seq))
        jlog, tlog = np.asarray(jlog)[0, rows], tlog.numpy()[0, rows]
        np.testing.assert_allclose(tlog, jlog, atol=TOL, rtol=TOL)
        for i, (row, tok) in enumerate(zip(jlog, tokens)):
            assert row[tok] >= row.max() - TOL, (
                f"token {i} of {tokens}: {tok} (logit {row[tok]}) is not the "
                f"JAX model's greedy choice {row.argmax()} ({row.max()})")


def load_jax_params(params_path):
    """The params a JAX reference process saved, as a numpy tree."""
    with np.load(params_path) as z:
        params = {}
        for key in z.files:
            *parents, leaf = key.split("/")
            node = params
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = z[key]
    return params


_JAX_STREAMS = r"""
import asyncio, json, sys
import jax
import numpy as np
jax.config.update("jax_platforms", "cpu")
from llmapigateway_tpu.config.schemas import LocalEngineConfig
from llmapigateway_tpu.engine.engine import GenRequest, InferenceEngine

geometry, prompts, max_tokens, params_path = json.loads(sys.argv[1])
eng = InferenceEngine(LocalEngineConfig(**geometry, attention="reference",
                                        prewarm_sampler_variants=False),
                      devices=[jax.devices("cpu")[0]])

async def run():
    reqs = [GenRequest(prompt_ids=p, max_tokens=max_tokens) for p in prompts]
    for r in reqs:
        await eng.submit(r)
    texts = ["".join([d.text async for d in eng.stream(r)]) for r in reqs]
    await eng.stop()
    return [r.generated for r in reqs], [r.finish_reason for r in reqs], texts

flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(eng.params)[0]}
np.savez(params_path, **flat)
print(json.dumps(asyncio.run(run())))
"""


def _jax_streams_in_fresh_process(geometry, params_path, max_tokens=24):
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_STREAMS,
         json.dumps([geometry, PROMPTS, max_tokens, str(params_path)])],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=reference_env())
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    return result, load_jax_params(params_path)


@pytest.fixture(scope="module")
def engines(stop_engine):
    jeng = JEngine(JConfig(**GEOMETRY, attention="reference",
                           prewarm_sampler_variants=False),
                   devices=[jax.devices("cpu")[0]])
    teng = InferenceEngine(LocalEngineConfig(**GEOMETRY), device="cpu")
    teng.params = params_from_jax(jax.tree.map(np.asarray, jeng.params))
    yield jeng, teng
    stop_engine(jeng)
    stop_engine(teng)


async def _greedy_streams(eng, request_cls, max_tokens=24):
    reqs = [request_cls(prompt_ids=list(p), max_tokens=max_tokens)
            for p in PROMPTS]
    for r in reqs:
        await eng.submit(r)
    texts = []
    for r in reqs:
        parts = [d.text async for d in eng.stream(r)]
        texts.append("".join(parts))
    return [r.generated for r in reqs], [r.finish_reason for r in reqs], texts


async def test_greedy_streams_match_jax_engine(engines):
    jeng, teng = engines
    jax_result = list(await _greedy_streams(jeng, JRequest))
    port = list(await _greedy_streams(teng, GenRequest))
    if port != jax_result:          # the JAX model adjudicates (see TOL)
        await asyncio.to_thread(
            assert_jax_model_greedy, jax.tree.map(np.asarray, jeng.params),
            GEOMETRY, PROMPTS, port[0])
    # Every request ran prefill through the chunk path, the 97-token
    # prompt's one-token tail (3 x 32 + 1) through the decode path unpadded,
    # and decode through the deferred-insert path; all pages came back.
    assert teng.prefill_calls >= 4 and teng.decode_steps > 0
    assert teng.prefill_one_token_calls >= 1
    teng.allocator.check_invariants()
    assert teng.allocator.free_pages == teng.allocator.num_pages - 1


# The first prompt's stream from the port, and the one the JAX engine gave
# under the suite's load in the driver's run on PR 6.
PORT_STREAM = [21, 133, 139, 181, 237, 139, 139, 139, 415, 139, 426, 181,
               247, 237, 181, 378, 451, 188, 119, 242, 197, 87, 288, 77]
LOADED_JAX_STREAM = [21, 133, 139, 181, 237, 181, 426, 77, 336, 92, 179,
                     167, 237, 181, 426, 77, 336, 92, 179, 167, 237, 241,
                     426, 378]


def test_jax_model_adjudicates_a_disagreement(engines):
    """The adjudicator accepts the port's stream for the first prompt and
    refuses the stream the loaded JAX engine gave, at its sixth token."""
    jparams = jax.tree.map(np.asarray, engines[0].params)
    assert_jax_model_greedy(jparams, GEOMETRY, PROMPTS[:1], [PORT_STREAM])
    with pytest.raises(AssertionError, match="token 5 of"):
        assert_jax_model_greedy(jparams, GEOMETRY, PROMPTS[:1],
                                [LOADED_JAX_STREAM])


@pytest.fixture(scope="module", params=CONFIGS,
                ids=[f"{lay}-{q or 'float'}" for lay, q in CONFIGS])
def config_engines(request, stop_engine, tmp_path_factory):
    """Per (layout, kv_quant): the JAX engine's streams from the pinned
    reference process and a port engine with the same params."""
    geometry = _geometry(*request.param)
    params_path = tmp_path_factory.mktemp("jax") / "params.npz"
    jax_result, jparams = _jax_streams_in_fresh_process(geometry, params_path)
    teng = InferenceEngine(LocalEngineConfig(**geometry), device="cpu")
    teng.params = params_from_jax(jparams)
    teng.jparams = jparams
    yield request.param, jax_result, teng
    stop_engine(teng)


async def test_greedy_streams_match_jax_engine_in_every_config(
        config_engines):
    """Each (layout, kv_quant) pair streams the JAX engine's greedy tokens:
    the contiguous layout through the flash attention path (prefill calls
    read and write the slots' cache rows in place), int8 KV through the
    quantizing inserts and the scaled bodies, on either layout."""
    (layout, kv_quant), jax_result, teng = config_engines
    assert type(teng.cache).__name__ == ("PagedKVCache" if layout == "paged"
                                         else "KVCache")
    assert isinstance(teng.cache.k, dict) == (kv_quant == "int8")
    port = list(await _greedy_streams(teng, GenRequest))
    if port != jax_result:          # the JAX model adjudicates (see TOL)
        await asyncio.to_thread(
            assert_jax_model_greedy, teng.jparams,
            _geometry(layout, kv_quant), PROMPTS, port[0])
    assert teng.prefill_one_token_calls >= 1 and teng.decode_steps > 0
    if layout == "paged":
        teng.allocator.check_invariants()
        assert teng.allocator.free_pages == teng.allocator.num_pages - 1
    else:
        assert teng.allocator is None and sorted(teng._free_slots) == list(
            range(teng.B))


# The prefix cache against the JAX engine's. Requests share a 64-token
# prefix and come in waves, each sent once the one before has finished, so
# both engines admit and release in the same order: wave 0 runs cold and
# indexes its blocks at release; wave 1 hits (two new tails, and a second
# turn that extends wave 0's first conversation past the shared prefix,
# generated tokens and all); wave 2 is a penalty request, which bypasses
# the cache. The eviction job sends five requests with distinct prompts one
# at a time through a pool of 16 usable pages (one sequence holds 6, and
# each release keeps 5 resident), so admission evicts from the fourth on;
# then a second turn of the last conversation, which still hits.
PREFIX = np.random.default_rng(7).integers(0, 256, 64).tolist()


def _tail(seed, n):
    return np.random.default_rng(100 + seed).integers(0, 256, n).tolist()


PREFIX_WAVES = [
    ("together", [(PREFIX + _tail(0, 30), 0.0), (PREFIX + _tail(1, 5), 0.0),
                  (PREFIX + _tail(2, 17), 0.0)]),
    ("together", [(PREFIX + _tail(3, 9), 0.0), (PREFIX + _tail(4, 21), 0.0),
                  (["extend", 0, 0, _tail(5, 3)], 0.0)]),
    ("together", [(PREFIX + _tail(6, 12), 0.5)]),
]
EVICT_WAVES = [("one_by_one",
                [(np.random.default_rng(200 + i).integers(0, 256, 64).tolist()
                  + _tail(i, 10), 0.0) for i in range(5)]),
               ("one_by_one", [(["extend", 0, 4, _tail(9, 2)], 0.0)])]
PREFIX_GEOMETRY = {**GEOMETRY, "prefix_cache": True}
PREFIX_JOBS = [
    (f"{q or 'float'}-ppb{ppb}",
     {**PREFIX_GEOMETRY, "kv_quant": q, "kv_pages_per_block": ppb},
     PREFIX_WAVES) for q in ("", "int8") for ppb in (1, 2)] + [
    ("evict", {**PREFIX_GEOMETRY, "kv_num_pages": 17}, EVICT_WAVES)]
PREFIX_STATS = ("prefix_hits_total", "prefix_misses_total",
                "prefix_cached_tokens_total", "prefix_resident_blocks",
                "prefix_inserted_blocks", "prefix_evicted_blocks",
                "prefix_block_tokens")
# One driver for both engines: run verbatim here on the port and inside the
# JAX reference process.
_SERVE_WAVES = r"""
async def serve_waves(eng, request_cls, waves, max_tokens=8):
    done, out = [], []
    for mode, specs in waves:
        reqs = []
        for prompt, presence in specs:
            if prompt[0] == "extend":       # a later turn of a conversation
                _, w, i, more = prompt
                prompt = done[w][i].prompt_ids + done[w][i].generated + more
            reqs.append(request_cls(prompt_ids=list(prompt),
                                    max_tokens=max_tokens,
                                    presence_penalty=presence))
        calls = getattr(eng, "prefill_calls", 0)
        texts = []
        if mode == "together":
            for r in reqs:
                await eng.submit(r)
            texts = ["".join([d.text async for d in eng.stream(r)])
                     for r in reqs]
        else:
            for r in reqs:
                await eng.submit(r)
                texts.append("".join([d.text async for d in eng.stream(r)]))
        done.append(reqs)
        out.append({"prompts": [r.prompt_ids for r in reqs],
                    "tokens": [r.generated for r in reqs],
                    "finish": [r.finish_reason for r in reqs],
                    "texts": texts,
                    "cached": [r.cached_tokens for r in reqs],
                    "prefill_calls": getattr(eng, "prefill_calls", 0) - calls})
    return out, eng.stats()
"""
_JAX_PREFIX_STREAMS = r"""
import asyncio, json, sys
import jax
import numpy as np
jax.config.update("jax_platforms", "cpu")
from llmapigateway_tpu.config.schemas import LocalEngineConfig
from llmapigateway_tpu.engine.engine import GenRequest, InferenceEngine
""" + _SERVE_WAVES + r"""
jobs, stat_keys, params_path = json.loads(sys.argv[1])

async def run():
    out = {}
    for name, geometry, waves in jobs:
        eng = InferenceEngine(LocalEngineConfig(
            **geometry, attention="reference",
            prewarm_sampler_variants=False), devices=[jax.devices("cpu")[0]])
        waves_out, stats = await serve_waves(eng, GenRequest, waves)
        await eng.stop()
        out[name] = {"waves": waves_out,
                     "stats": {k: stats[k] for k in stat_keys}}
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in
            jax.tree_util.tree_flatten_with_path(eng.params)[0]}
    np.savez(params_path, **flat)
    return out

print(json.dumps(asyncio.run(run())))
"""


@pytest.fixture(scope="module", autouse=True)
def _jax_prefix_streams_started(tmp_path_factory):
    """The pinned JAX reference serving every prefix job in turn, started
    with the module's first test so that it overlaps the others."""
    params_path = tmp_path_factory.mktemp("jax-prefix") / "params.npz"
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_PREFIX_STREAMS,
         json.dumps([PREFIX_JOBS, PREFIX_STATS, str(params_path)])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=reference_env())
    yield proc, params_path
    if proc.poll() is None:         # no test asked for the streams
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_prefix_streams(_jax_prefix_streams_started):
    proc, params_path = _jax_prefix_streams_started
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    return json.loads(stdout.strip().splitlines()[-1]), params_path


def _jax_cache_replay(eng, waves, port_waves, max_tokens=8):
    """The JAX cache's own account of the port's run: the JAX
    RadixPrefixCache over the JAX PageAllocator, of the port engine's pool
    geometry, driven as the engines drive theirs (a wave's requests admitted
    in order, matching unless they carry a penalty and evicting under page
    pressure; released at their end, indexing the prompt and every generated
    token but the last) over the port's prompts and streams. Returns each
    wave's cached tokens and the cache's stats."""
    alloc = JAllocator(eng.allocator.num_pages, eng.allocator.page_size,
                       eng.B, eng.S, pages_per_block=eng.kv_ppb)
    cache = JCache(alloc, block_tokens=eng._prefix_cache.block_tokens)

    def release(slot, prompt, generated, nodes):
        seq = prompt + generated
        n_ok = len(prompt) + max(0, len(generated) - 1)
        cache.insert(seq, min(n_ok, eng.S, len(seq)), alloc.table[slot])
        cache.release_nodes(nodes)
        alloc.release(slot)

    cached = []
    for (mode, specs), got in zip(waves, port_waves):
        running, wave_cached = [], []
        for i, (prompt, generated, (_, presence)) in enumerate(
                zip(got["prompts"], got["tokens"], specs)):
            slot = i if mode == "together" else 0
            total = min(len(prompt) + max_tokens, eng.S)
            matched, pages, nodes = (cache.match(prompt) if presence == 0
                                     else (0, [], []))
            if not alloc.can_admit(total, shared_pages=len(pages)):
                cache.evict(alloc.fresh_shortfall(
                    total, shared_pages=len(pages)))
            assert alloc.allocate(slot, total, shared_pages=pages)
            cache.record_lookup(matched)
            wave_cached.append(matched)
            running.append((slot, prompt, generated, nodes))
            if mode == "one_by_one":
                release(*running.pop())
        for args in running:
            release(*args)
        cached.append(wave_cached)
    cache.check_invariants()
    return cached, cache.stats()


@pytest.mark.parametrize("job", [j[0] for j in PREFIX_JOBS])
async def test_prefix_cache_streams_match_jax_engine(job, jax_prefix_streams):
    """Each job's greedy streams, texts, finish reasons and per-request
    ``cached_tokens`` equal the JAX engine's, and so do the caches' hit,
    insert and eviction counts (a disagreement is settled by the JAX model,
    teacher-forced, and the JAX cache replayed over the port's streams).
    The JAX cache replayed over the port's run agrees with it in any case.
    Warm waves run fewer prefill calls than the cold one; the penalty
    request is served cold; after the run the allocator's refcounts and the
    tree agree, and every page is free or resident in the cache."""
    results, params_path = jax_prefix_streams
    _, geometry, waves = next(j for j in PREFIX_JOBS if j[0] == job)
    ns: dict = {}
    exec(_SERVE_WAVES, ns)
    eng = InferenceEngine(LocalEngineConfig(**geometry), device="cpu")
    jparams = load_jax_params(params_path)
    eng.params = params_from_jax(jparams)
    port, stats = await ns["serve_waves"](eng, GenRequest, waves)
    await eng.stop()
    port_stats = {k: stats[k] for k in PREFIX_STATS}
    keys = ("tokens", "finish", "texts", "cached")
    if ([{k: w[k] for k in keys} for w in port] != [
            {k: w[k] for k in keys} for w in results[job]["waves"]]
            or port_stats != results[job]["stats"]):
        await asyncio.to_thread(
            assert_jax_model_greedy, jparams, geometry,
            [p for w in port for p in w["prompts"]],
            [t for w in port for t in w["tokens"]])
    cached, jstats = _jax_cache_replay(eng, waves, port)
    assert [w["cached"] for w in port] == cached
    assert port_stats == {k: jstats[k] for k in PREFIX_STATS}
    cache = eng._prefix_cache
    cache.check_invariants()
    assert cache.pinned_refs() == 0
    assert (eng.allocator.free_pages + stats["prefix_resident_pages"]
            == stats["total_pages"])
    if job == "evict":
        assert stats["prefix_evicted_blocks"] > 0
        assert all(f in ("length", "stop") for f in port[0]["finish"])
        assert port[0]["cached"] == [0] * 5 and port[1]["cached"] == [80]
        return
    cold, warm, penalty = port
    assert cold["cached"] == [0, 0, 0]
    assert warm["cached"][:2] == [64, 64] and warm["cached"][2] > 64
    assert warm["prefill_calls"] < cold["prefill_calls"]
    assert penalty["cached"] == [0]


def test_prefix_cache_refused_only_where_it_would_mean_something():
    """The prefix cache is live exactly where the JAX engine builds its own
    (the paged layout, a model without a sliding window, the knob on; one
    block = page × resolved pages per block) and inert elsewhere: on the
    contiguous layout, for a windowed model, and with the knob off. No
    combination is refused."""
    cases = [({}, 16), ({"kv_pages_per_block": 2}, 32),
             ({"kv_layout": "contiguous"}, None),
             ({"preset": "tiny-mistral-test"}, None),
             ({"prefix_cache": False}, None)]
    for knob, block in cases:
        geometry = {**GEOMETRY, "prefix_cache": True, **knob}
        port = InferenceEngine(LocalEngineConfig(**geometry), device="cpu")
        jeng = JEngine(JConfig(**geometry, attention="reference",
                               prewarm_sampler_variants=False),
                       devices=[jax.devices("cpu")[0]])
        tcache, jcache = port._prefix_cache, jeng._prefix_cache
        assert (tcache is None) == (jcache is None) == (block is None), knob
        if block is not None:
            assert tcache.block_tokens == jcache.block_tokens == block
            assert tcache.allocator is port.allocator


@pytest.mark.parametrize("knob", [{"kv_quant": "int4"},
                                  {"kv_layout": "ring"}])
def test_unknown_kv_values_are_refused(knob):
    with pytest.raises(ValueError, match="unknown kv_"):
        InferenceEngine(LocalEngineConfig(**{**GEOMETRY, **knob}),
                        device="cpu")


def _emitted(eng, req, detok_cls, token_ids):
    """Feed ``token_ids`` through the engine's emission step, as the
    scheduler does after each sampled token; return the streamed deltas."""
    req.detok = detok_cls(eng.tokenizer)
    for tok in token_ids:
        req.generated.append(tok)
        eng._emit_token(req)
        if req.done:
            break
    out = []
    while not req.out_queue.empty():
        d = req.out_queue.get_nowait()
        out.append((d.text, d.finish_reason))
    return out


@pytest.mark.parametrize("stop,max_tokens", [
    (["lo w"], 64), (["o"], 64), (["zz"], 64), (["ld", "wö"], 64),
    ([], 5), (["zz"], 9)])
def test_emission_matches_jax_engine(engines, stop, max_tokens):
    """Stop strings (excluded from the output, held back while they may
    still match), max_tokens, EOS and UTF-8 boundaries: the same token
    sequence through both engines' emission gives the same deltas."""
    from llmapigateway_tpu.engine.tokenizer import (
        IncrementalDetokenizer as JDetok)
    from llmapigateway_tpu_torch.engine.tokenizer import (
        IncrementalDetokenizer as TDetok)
    jeng, teng = engines
    ids = list("héllo wörld, hello".encode()) + [257]       # 257 = EOS
    jout = _emitted(jeng, JRequest(prompt_ids=[1], max_tokens=max_tokens,
                                   stop=stop), JDetok, ids)
    tout = _emitted(teng, GenRequest(prompt_ids=[1], max_tokens=max_tokens,
                                     stop=stop), TDetok, ids)
    assert tout == jout
    assert tout[-1][1] is not None


@pytest.mark.parametrize("knob,item", [
    ({"prefix_cache": True, "quant": "int4"}, "weight quantization"),
    ({"kv_quant": "int8", "spec_draft_len": 3}, "speculative decoding"),
    ({"kv_pages_per_block": 2, "prefix_cache": True, "spec_draft_len": 1},
     "speculative decoding"),
    ({"preset": "tiny-mistral-test", "spec_draft_len": 2},
     "speculative decoding"),
    ({"spec_draft_len": 3}, "speculative decoding"),
    ({"quant": "int8"}, "weight quantization"),
    ({"mesh": {"model": 2}}, "parallelism"),
    # A checkpoint's knobs are refused before its files are opened.
    ({"model_path": "/nonexistent", "mesh": {"model": 2}}, "parallelism"),
    ({"disaggregation": {"enabled": True}}, "disaggregation"),
    ({"preset": "tiny-mistral-test", "mesh": {"model": 2}}, "parallelism"),
    ({"preset": "tiny-moe-test"}, "MoE"),
])
def test_unported_knobs_are_refused_at_build(knob, item):
    cfg = LocalEngineConfig(**{**GEOMETRY, **knob})
    with pytest.raises(ValueError, match=f"ROADMAP.md.*{item}"):
        InferenceEngine(cfg, device="cpu")
