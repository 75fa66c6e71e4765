"""The port's engine (llmapigateway_tpu_torch/engine/engine.py) held to the
JAX engine: with the same ``tiny-test`` weights, the same KV geometry and
greedy decoding, concurrent requests whose prompts cross KV pages and
prefill chunks must stream the same tokens, token for token — on the paged
and the contiguous layout, with bf16-layout (here fp32) and int8 KV. fp32
weights and activations on both sides, so only summation order differs."""
import asyncio
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from llmapigateway_tpu.config.schemas import LocalEngineConfig as JConfig
from llmapigateway_tpu.engine.engine import GenRequest as JRequest
from llmapigateway_tpu.engine.engine import InferenceEngine as JEngine
from llmapigateway_tpu_torch.config.schemas import LocalEngineConfig
from llmapigateway_tpu_torch.engine.engine import (GenRequest,
                                                   InferenceEngine)
from llmapigateway_tpu_torch.models.convert import params_from_jax

REPO = Path(__file__).resolve().parent.parent
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


# The JAX side of the engine comparisons is adjudicated in FRESH processes:
# the JAX engine's greedy streams are not reproducible run to run on the CPU
# backend (tests/conftest.py, _PARITY_RERUN_TESTS: XLA:CPU compiles vary
# within one process). Measured with this file's prompts, 3 of 14 fresh
# processes serving them concurrently gave a second stream for every request
# from the first decode token on, on both layouts, and 3 of 18 serving them
# one at a time under int8 KV; the port's streams never varied. The
# repo's rule for such flips is a rerun in a fresh process (conftest), so a
# disagreement is adjudicated by up to JAX_RERUNS more fresh JAX runs: a
# port fault disagrees with every one of them. The process saves its
# params for the port.
JAX_RERUNS = 3
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
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    with np.load(params_path) as z:
        params = {}
        for key in z.files:
            *parents, leaf = key.split("/")
            node = params
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = z[key]
    return result, params_from_jax(params)


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


async def test_greedy_streams_match_jax_engine(engines, tmp_path):
    jeng, teng = engines
    jax_result = list(await _greedy_streams(jeng, JRequest))
    ttok, tfin, ttext = await _greedy_streams(teng, GenRequest)
    # A disagreement is adjudicated by fresh JAX processes (see JAX_RERUNS).
    for _ in range(JAX_RERUNS):
        if [ttok, tfin, ttext] == jax_result:
            break
        jax_result, _ = await asyncio.to_thread(
            _jax_streams_in_fresh_process, GEOMETRY, tmp_path / "params.npz")
    jtok, jfin, jtext = jax_result
    assert ttok == jtok
    assert tfin == jfin
    assert ttext == jtext
    # Every request ran prefill through the chunk path, the 97-token
    # prompt's one-token tail (3 x 32 + 1) through the decode path unpadded,
    # and decode through the deferred-insert path; all pages came back.
    assert teng.prefill_calls >= 4 and teng.decode_steps > 0
    assert teng.prefill_one_token_calls >= 1
    teng.allocator.check_invariants()
    assert teng.allocator.free_pages == teng.allocator.num_pages - 1


@pytest.fixture(scope="module", params=CONFIGS,
                ids=[f"{lay}-{q or 'float'}" for lay, q in CONFIGS])
def config_engines(request, stop_engine, tmp_path_factory):
    """Per (layout, kv_quant): the JAX engine's streams from a fresh process
    and a port engine with the same params."""
    geometry = _geometry(*request.param)
    params_path = tmp_path_factory.mktemp("jax") / "params.npz"
    jax_result, params = _jax_streams_in_fresh_process(geometry, params_path)
    teng = InferenceEngine(LocalEngineConfig(**geometry), device="cpu")
    teng.params = params
    teng.params_path = params_path
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
    port_result = list(await _greedy_streams(teng, GenRequest))
    for _ in range(JAX_RERUNS):
        if port_result == jax_result:
            break
        jax_result, _ = await asyncio.to_thread(
            _jax_streams_in_fresh_process, _geometry(layout, kv_quant),
            teng.params_path)
    (ttok, tfin, ttext), (jtok, jfin, jtext) = port_result, jax_result
    assert ttok == jtok
    assert tfin == jfin
    assert ttext == jtext
    assert teng.prefill_one_token_calls >= 1 and teng.decode_steps > 0
    if layout == "paged":
        teng.allocator.check_invariants()
        assert teng.allocator.free_pages == teng.allocator.num_pages - 1
    else:
        assert teng.allocator is None and sorted(teng._free_slots) == list(
            range(teng.B))


def test_prefix_cache_refused_only_where_it_would_mean_something():
    """The JAX engine treats prefix_cache as inert outside the paged layout
    (and the port has no prefix cache yet): the default prefix_cache=true
    builds on the contiguous layout and is refused on the paged one, with
    the queue item named."""
    for layout in ("contiguous", "paged"):
        cfg = LocalEngineConfig(**{**GEOMETRY, "prefix_cache": True,
                                   "kv_layout": layout})
        if layout == "paged":
            with pytest.raises(ValueError, match="ROADMAP.md.*prefix cache"):
                InferenceEngine(cfg, device="cpu")
        else:
            eng = InferenceEngine(cfg, device="cpu")
            assert eng.cfg.prefix_cache and not eng.paged


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
    ({"prefix_cache": True}, "prefix cache"),
    ({"kv_quant": "int8", "spec_draft_len": 3}, "speculative decoding"),
    ({"kv_pages_per_block": 2, "prefix_cache": True}, "prefix cache"),
    ({"preset": "tiny-mistral-test", "spec_draft_len": 2},
     "speculative decoding"),
    ({"spec_draft_len": 3}, "speculative decoding"),
    ({"quant": "int8"}, "weight quantization"),
    ({"mesh": {"model": 2}}, "parallelism"),
    ({"model_path": "/nonexistent"}, "checkpoints"),
    ({"disaggregation": {"enabled": True}}, "disaggregation"),
    ({"preset": "tiny-mistral-test", "mesh": {"model": 2}}, "parallelism"),
    ({"preset": "tiny-moe-test"}, "MoE"),
])
def test_unported_knobs_are_refused_at_build(knob, item):
    cfg = LocalEngineConfig(**{**GEOMETRY, **knob})
    with pytest.raises(ValueError, match=f"ROADMAP.md.*{item}"):
        InferenceEngine(cfg, device="cpu")
