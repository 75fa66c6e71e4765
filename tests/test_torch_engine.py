"""The port's engine (llmapigateway_tpu_torch/engine/engine.py) held to the
JAX engine: with the same ``tiny-test`` weights, the same paged geometry and
greedy decoding, concurrent requests whose prompts cross KV pages and
prefill chunks must stream the same tokens, token for token. fp32 weights
and activations on both sides, so only summation order differs."""
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

GEOMETRY = dict(preset="tiny-test", kv_layout="paged", kv_page_size=16,
                prefix_cache=False, max_batch_size=4, max_seq_len=256,
                prefill_chunk=32, dtype="float32")
# Prompt lengths: within one page, across pages and one chunk boundary,
# across several chunk boundaries.
PROMPTS = [np.random.default_rng(i).integers(0, 256, n).tolist()
           for i, n in enumerate((11, 45, 97))]


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
    jtok, jfin, jtext = await _greedy_streams(jeng, JRequest)
    ttok, tfin, ttext = await _greedy_streams(teng, GenRequest)
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
    ({"kv_quant": "int8"}, "int8 KV"),
    ({"kv_pages_per_block": 2}, "multi-page blocks"),
    ({"kv_layout": "contiguous"}, "contiguous layout"),
    ({"spec_draft_len": 3}, "speculative decoding"),
    ({"quant": "int8"}, "weight quantization"),
    ({"mesh": {"model": 2}}, "parallelism"),
    ({"model_path": "/nonexistent"}, "checkpoints"),
    ({"disaggregation": {"enabled": True}}, "disaggregation"),
    ({"preset": "tiny-mistral-test"}, "window variant"),
    ({"preset": "tiny-moe-test"}, "MoE"),
])
def test_unported_knobs_are_refused_at_build(knob, item):
    cfg = LocalEngineConfig(**{**GEOMETRY, **knob})
    with pytest.raises(ValueError, match=f"ROADMAP.md.*{item}"):
        InferenceEngine(cfg, device="cpu")
