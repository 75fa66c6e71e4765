"""The port's radix prefix cache and refcounted page allocator
(llmapigateway_tpu_torch/engine/prefix_cache.py, engine/paged.py) held to
the JAX package's, step for step: seeded numpy sequences drive both sides
with the same ``match``, ``insert``, ``evict`` and ``release_nodes`` calls
and the same ``allocate(shared_pages=)``, ``retain``, ``drop``,
``fresh_shortfall`` and ``release`` calls, as an engine would: admission
matches, evicts under pressure and allocates with the matched pages;
release inserts the slot's written blocks, then unpins and frees the row.
After every step both sides must return equal matches and pages, hold
equal tables, free counts and ``stats()``, and pass their invariants.
Exact equality throughout: this is integer bookkeeping. Last, the cache
through the gateway: the usage block's cached-token count."""
import functools
import json

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from llmapigateway_tpu.engine.paged import PageAllocator as JAllocator
from llmapigateway_tpu.engine.prefix_cache import (
    RadixPrefixCache as JCache)
from llmapigateway_tpu_torch.engine.paged import PageAllocator
from llmapigateway_tpu_torch.config.loader import ConfigLoader
from llmapigateway_tpu_torch.config.settings import Settings
from llmapigateway_tpu_torch.engine.prefix_cache import RadixPrefixCache
from llmapigateway_tpu_torch.providers.local import make_local_provider
from llmapigateway_tpu_torch.server.app import build_app
from llmapigateway_tpu_torch.utils.sse import SSEParser

PAGE, BATCH, MAX_SEQ = 4, 4, 64


class Side:
    """One allocator + cache pair and the slots it runs, driven like the
    engine drives its own."""

    def __init__(self, alloc_cls, cache_cls, num_pages, ppb):
        self.alloc = alloc_cls(num_pages, PAGE, BATCH, MAX_SEQ,
                               pages_per_block=ppb)
        self.cache = cache_cls(self.alloc, block_tokens=PAGE * ppb)
        self.running = {}               # slot -> (tokens, nodes)

    def admit(self, slot, tokens, total):
        """match → (evict) → allocate: what the engine would see."""
        matched, pages, nodes = self.cache.match(tokens)
        shared = len(pages)
        short = self.alloc.fresh_shortfall(total, shared_pages=shared)
        ok = self.alloc.can_admit(total, shared_pages=shared)
        evicted = 0
        if not ok:
            evicted = self.cache.evict(short) if short > 0 else 0
            ok = self.alloc.can_admit(total, shared_pages=shared)
        if not ok:
            self.cache.release_nodes(nodes)
            return ("waits", matched, pages, short, evicted)
        assert self.alloc.allocate(slot, total, shared_pages=pages)
        self.cache.record_lookup(matched)
        self.running[slot] = (tokens, nodes)
        return ("admitted", matched, pages, short, evicted)

    def release(self, slot, n_written):
        tokens, nodes = self.running.pop(slot)
        added = self.cache.insert(tokens, n_written, self.alloc.table[slot])
        self.cache.release_nodes(nodes)
        self.alloc.release(slot)
        return added

    def pin_and_drop(self, slot):
        """An outside holder (retain) on a running slot's first group, then
        let go (drop): the refcount comes back to where it was."""
        pages = [int(p) for p in
                 self.alloc.table[slot, :self.alloc.group_pages]]
        self.alloc.retain(pages)
        held = dict(self.alloc._ref)
        self.alloc.drop(pages)
        return held

    def state(self):
        return (self.alloc.table.tolist(), self.alloc.free_pages,
                self.cache.stats(), sorted(self.cache.resident_page_list()))

    def check(self):
        self.cache.check_invariants()


def _sequence(rng, prefixes):
    """A prompt + generated run: one of a few shared prefixes (or none),
    then a random tail; and its max_tokens."""
    base = prefixes[rng.integers(len(prefixes))] if rng.random() < 0.8 \
        else []
    tokens = list(base) + rng.integers(0, 7, rng.integers(1, 20)).tolist()
    tokens = tokens[:MAX_SEQ - 8]
    max_tokens = int(rng.integers(1, 8))
    return tokens, max_tokens


@pytest.mark.parametrize("ppb,num_pages", [(1, 33), (2, 34), (1, 20),
                                           (2, 24)])
def test_cache_and_allocator_match_jax_step_for_step(ppb, num_pages):
    """Random admissions and releases over a few shared prefixes, on a pool
    that is roomy (33/34 pages) or tight enough to evict and to make the
    head wait (20/24)."""
    rng = np.random.default_rng(ppb * 100 + num_pages)
    prefixes = [rng.integers(0, 7, n).tolist() for n in (8, 16, 24)]
    jax_side = Side(JAllocator, JCache, num_pages, ppb)
    port = Side(PageAllocator, RadixPrefixCache, num_pages, ppb)
    free_slots = list(range(BATCH))
    written = {}
    outcomes = set()
    for step in range(400):
        if free_slots and (not port.running or rng.random() < 0.6):
            slot = free_slots[-1]
            tokens, max_tokens = _sequence(rng, prefixes)
            total = min(len(tokens) + max_tokens, MAX_SEQ)
            got = port.admit(slot, tokens, total)
            assert got == jax_side.admit(slot, tokens, total), step
            outcomes.add(got[0])
            if got[1]:
                outcomes.add("hit")
            if got[4]:
                outcomes.add("evicted")
            if got[0] == "admitted":
                free_slots.pop()
                # Written so far when it ends: the prompt and all but the
                # last generated token, or a cancellation mid-prefill.
                written[slot] = (len(tokens) + max_tokens - 1
                                 if rng.random() < 0.8
                                 else int(rng.integers(0, len(tokens) + 1)))
        else:
            slot = sorted(port.running)[rng.integers(len(port.running))]
            if rng.random() < 0.2:
                assert port.pin_and_drop(slot) == jax_side.pin_and_drop(slot)
            tokens = port.running[slot][0]
            seq = tokens + rng.integers(0, 7, 8).tolist()
            n = min(written.pop(slot), len(seq))
            # The same generated tokens on both sides (the engine inserts
            # prompt + generated).
            port.running[slot] = (seq, port.running[slot][1])
            jax_side.running[slot] = (seq, jax_side.running[slot][1])
            assert port.release(slot, n) == jax_side.release(slot, n), step
            free_slots.append(slot)
        assert port.state() == jax_side.state(), step
        port.check()
        jax_side.check()
    assert {"admitted", "hit"} <= outcomes
    if num_pages < 30:
        assert {"evicted", "waits"} <= outcomes


@pytest.mark.parametrize("ppb", [1, 2])
def test_match_stops_one_token_short_like_jax(ppb):
    """A prompt that is exactly a resident run of blocks matches one block
    less (the last token must be prefilled, and the block it writes into
    stays private); one token more matches them all; a prompt diverging
    inside the second block matches the first."""
    bt = PAGE * ppb
    seq = list(range(2 * bt))
    sides = [Side(cls_a, cls_c, 34, ppb) for cls_a, cls_c in
             ((JAllocator, JCache), (PageAllocator, RadixPrefixCache))]
    for side in sides:
        side.admit(0, seq, len(seq) + 1)
        side.release(0, len(seq))
    for prompt, want in ((seq, bt), (seq + [0], 2 * bt),
                         (seq[:bt + 1] + [99] * bt, bt)):
        got = [side.cache.match(prompt) for side in sides]
        assert got[0][:2] == got[1][:2]
        assert got[1][0] == want
        for side, (_, _, nodes) in zip(sides, got):
            side.cache.release_nodes(nodes)
            side.check()


def test_shared_pages_are_refused_where_jax_refuses_them():
    """Partial groups, a sharing ring slot, shared pages past the
    reservation, and a dead shared group raise on both sides; an
    over-freed group too."""
    for cls in (JAllocator, PageAllocator):
        a = cls(16, PAGE, 2, 32, pages_per_block=2)
        with pytest.raises(ValueError, match="whole groups"):
            a.allocate(0, 8, shared_pages=[2])
        with pytest.raises(ValueError, match="exceeds"):
            a.allocate(0, 4, shared_pages=[2, 3, 4, 5])
        with pytest.raises(ValueError, match="not live"):
            a.allocate(0, 16, shared_pages=[2, 3])
        with pytest.raises(ValueError, match="not live"):
            a.retain([2, 3])
        with pytest.raises(ValueError, match="over-freed"):
            a.drop([2, 3])
        r = cls(16, PAGE, 2, 32)
        with pytest.raises(ValueError, match="ring"):
            r.allocate(0, 32, ring_pages=3, shared_pages=[1])
    with pytest.raises(ValueError, match="multiple of the page size"):
        RadixPrefixCache(PageAllocator(16, PAGE, 2, 32), block_tokens=6)


# A local provider with the JAX default prefix_cache: true.
PROVIDERS = """[
  { "cached": { "type": "local", "engine": {
      "preset": "tiny-test", "kv_page_size": 16, "max_seq_len": 256,
      "prefill_chunk": 32, "max_batch_size": 4 } } },
]"""
RULES = [{"gateway_model_name": "gw/cached",
          "fallback_models": [{"provider": "cached", "model": "tiny"}]}]
AUTH = {"Authorization": "Bearer secret"}


@pytest.fixture
def app(tmp_path):
    (tmp_path / "providers.json").write_text(PROVIDERS)
    (tmp_path / "models_fallback_rules.json").write_text(json.dumps(RULES))
    settings = Settings(gateway_api_key="secret", fallback_provider="cached",
                        config_dir=tmp_path)
    return build_app(settings, loader=ConfigLoader(tmp_path, "cached"),
                     local_factory=functools.partial(make_local_provider,
                                                     device="cpu"))


def _body(stream=False):
    return {"model": "gw/cached", "stream": stream, "temperature": 0,
            "max_tokens": 6,
            "messages": [{"role": "user", "content": "hello " * 30}]}


async def test_usage_carries_cached_tokens(app):
    """A repeated prompt on a provider with the prefix cache on is served
    from resident blocks: the usage block of the second response, JSON and
    SSE alike, carries ``prompt_tokens_details.cached_tokens`` as the JAX
    server's does (the whole blocks of the prompt less its last token); a
    cold response carries none."""
    async with TestClient(TestServer(app)) as client:
        resp = await client.post("/v1/chat/completions", json=_body(),
                                 headers=AUTH)
        first = (await resp.json())["usage"]
        assert "prompt_tokens_details" not in first
        n = first["prompt_tokens"]
        resp = await client.post("/v1/chat/completions", json=_body(),
                                 headers=AUTH)
        usage = (await resp.json())["usage"]
        assert usage["prompt_tokens_details"] == {
            "cached_tokens": (n - 1) // 16 * 16}
        resp = await client.post("/v1/chat/completions",
                                 json=_body(stream=True), headers=AUTH)
        frames = list(SSEParser().feed(await resp.read()))
        assert frames[-2].json["usage"]["prompt_tokens_details"] == {
            "cached_tokens": (n - 1) // 16 * 16}
