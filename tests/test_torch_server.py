"""The port's gateway end to end on the CPU: the aiohttp app, the router's
rule → provider chain, the local provider and the engine on ``tiny-test``,
through the aiohttp test client — JSON and SSE chat completions, models,
health, auth, and a chain whose first target, a remote upstream, cannot
be reached."""
import functools
import json

import pytest
from aiohttp.test_utils import TestClient, TestServer

from llmapigateway_tpu_torch.config.loader import ConfigLoader
from llmapigateway_tpu_torch.config.settings import Settings
from llmapigateway_tpu_torch.providers.local import make_local_provider
from llmapigateway_tpu_torch.server.app import build_app
from llmapigateway_tpu_torch.utils.sse import SSEParser

PROVIDERS = """[
  // a remote upstream nothing listens on: the chain fails over past it
  { "upstream": { "baseUrl": "http://127.0.0.1:1/v1", "apikey": "K" } },
  { "local": { "type": "local", "engine": {
      "preset": "tiny-test", "kv_page_size": 16, "prefix_cache": false,
      "max_seq_len": 256, "prefill_chunk": 32, "max_batch_size": 4, } } },
]"""
RULES = [
    {"gateway_model_name": "gw/local",
     "fallback_models": [{"provider": "local", "model": "tiny"}]},
    {"gateway_model_name": "gw/chain",
     "fallback_models": [{"provider": "upstream", "model": "x"},
                         {"provider": "local", "model": "tiny"}]},
]


@pytest.fixture
def app(tmp_path):
    (tmp_path / "providers.json").write_text(PROVIDERS)
    (tmp_path / "models_fallback_rules.json").write_text(json.dumps(RULES))
    settings = Settings(gateway_api_key="secret", fallback_provider="local",
                        config_dir=tmp_path, db_dir=tmp_path / "db")
    return build_app(settings, loader=ConfigLoader(tmp_path, "local"),
                     local_factory=functools.partial(make_local_provider,
                                                     device="cpu"))


AUTH = {"Authorization": "Bearer secret"}


def _body(model="gw/local", stream=False, **kw):
    return {"model": model, "stream": stream, "temperature": 0,
            "max_tokens": 6,
            "messages": [{"role": "user", "content": "hello " * 30}], **kw}


async def test_json_and_sse_chat_completions(app):
    async with TestClient(TestServer(app)) as client:
        resp = await client.post("/v1/chat/completions", json=_body(),
                                 headers=AUTH)
        assert resp.status == 200
        data = await resp.json()
        assert data["object"] == "chat.completion"
        usage = data["usage"]
        assert usage["completion_tokens"] > 0
        assert usage["prompt_tokens"] > 200    # crosses KV pages and chunks
        assert data["choices"][0]["finish_reason"] in ("length", "stop")

        resp = await client.post("/v1/chat/completions",
                                 json=_body(stream=True), headers=AUTH)
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        parser = SSEParser()
        frames = list(parser.feed(await resp.read()))
        assert frames[-1].is_done
        chunks = [f.json for f in frames[:-1]]
        assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
        assert chunks[-1]["usage"]["completion_tokens"] > 0
        assert chunks[-1]["choices"][0]["finish_reason"] in ("length",
                                                             "stop")
        # Greedy: the streamed text is the JSON response's text.
        streamed = "".join(c["choices"][0]["delta"].get("content", "")
                           for c in chunks)
        assert streamed == data["choices"][0]["message"]["content"]


async def test_chain_skips_an_unported_provider(app):
    """An unreachable remote target fails over to the local one: the
    remote attempt fails at connect (no status), its breaker records the
    failure, and the local engine answers."""
    async with TestClient(TestServer(app)) as client:
        resp = await client.post("/v1/chat/completions",
                                 json=_body("gw/chain"), headers=AUTH)
        assert resp.status == 200
        assert (await resp.json())["usage"]["completion_tokens"] > 0
        resp = await client.get("/v1/api/health/providers", headers=AUTH)
        health = (await resp.json())["providers"]
        assert health["upstream"]["type"] == "remote_http"
        assert health["upstream"]["window_requests"] == 1
        assert health["upstream"]["failure_rate"] == 1.0
        assert health["local"]["failure_rate"] == 0.0


async def test_health_models_auth_and_errors(app):
    async with TestClient(TestServer(app)) as client:
        assert (await client.get("/health")).status == 200
        assert (await client.post("/v1/chat/completions",
                                  json=_body())).status == 401
        resp = await client.post("/v1/chat/completions", json=_body(),
                                 headers={"Authorization": "Bearer wrong"})
        assert resp.status == 403
        resp = await client.post("/v1/chat/completions", data="{nope",
                                 headers=AUTH)
        assert resp.status == 400
        resp = await client.post(
            "/v1/chat/completions",
            data='{"model": "gw/local", /* lenient */ "max_tokens": 2,'
                 '"messages": [],}',
            headers=AUTH)
        assert resp.status == 200
        resp = await client.get("/v1/models", headers=AUTH)
        ids = [m["id"] for m in (await resp.json())["data"]]
        assert ids[:2] == ["gw/local", "gw/chain"] and "local" in ids
