"""The rest of the port's HTTP surface held to the JAX package's app on the
CPU: the two apps serve copies of the same config files and the same
fake upstream (tests/fake_upstream.py), and must agree on the config
editor's GET/POST (status, body, the text saved, the config version), the
model lists in both agent formats, CORS, the request id (honoured or
refused, sent upstream, returned on JSON and SSE responses) and the UI
routes. Then the port's provider registry: a provider rebuilt when its
entry changed, reused when it did not, the old one closed after its
grace period; and a hot reload through the config API from a random-init
preset to a ``model_path`` checkpoint, served on the CPU."""
import asyncio
import functools
import json
import re

import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from llmapigateway_tpu.config.loader import ConfigLoader as JLoader
from llmapigateway_tpu.config.settings import Settings as JSettings
from llmapigateway_tpu.server.app import GatewayApp as JGatewayApp
from llmapigateway_tpu.server.app import build_app as jbuild_app
from llmapigateway_tpu.server.middleware import \
    cors_middleware as jcors_middleware
from llmapigateway_tpu_torch.config.loader import ConfigLoader
from llmapigateway_tpu_torch.config.schemas import ProviderDetails
from llmapigateway_tpu_torch.config.settings import Settings
from llmapigateway_tpu_torch.engine.checkpoint import load_checkpoint
from llmapigateway_tpu_torch.engine.engine import InferenceEngine
from llmapigateway_tpu_torch.providers.base import Provider
from llmapigateway_tpu_torch.providers.local import (LocalProvider,
                                                     make_local_provider)
from llmapigateway_tpu_torch.routing.router import ProviderRegistry
from llmapigateway_tpu_torch.server.app import build_app
from llmapigateway_tpu_torch.server.middleware import cors_middleware
from llmapigateway_tpu_torch.utils.sse import SSEParser
from test_torch_checkpoint import assert_trees_equal, write_checkpoint
from test_torch_engine import one_torch_thread
from tests.fake_upstream import FakeUpstream

assert one_torch_thread                  # the module-wide fixture, imported

KEY = "secret"
AUTH = {"Authorization": f"Bearer {KEY}"}
PROVIDERS = """[
  // the fake upstream, also the fallback provider
  {"fakeup": {"baseUrl": "%s", "apikey": "TESTKEY"}},
]"""
RULES = """[
  {"gateway_model_name": "gw/chat",
   "fallback_models": [{"provider": "fakeup", "model": "real-a"}]},
]"""


class Apps:
    """The JAX app and the port's, each on its own copy of the config
    files, with one fake upstream behind both."""

    def __init__(self, tmp_path):
        self.tmp = tmp_path

    async def __aenter__(self):
        self.upstream = FakeUpstream()
        self.up_server = TestServer(self.upstream.app)
        await self.up_server.start_server()
        url = f"http://{self.up_server.host}:{self.up_server.port}/v1"
        self.dirs = {}
        for side in ("jax", "port"):
            d = self.tmp / side
            d.mkdir()
            (d / "providers.json").write_text(PROVIDERS % url)
            (d / "models_fallback_rules.json").write_text(RULES)
            self.dirs[side] = d
        d = self.dirs["jax"]
        settings = JSettings(gateway_api_key=KEY, fallback_provider="fakeup",
                             base_dir=d, config_dir=d, db_dir=d / "db",
                             logs_dir=d / "logs")
        loader = JLoader(d, fallback_provider="fakeup")
        self.jax_gw = JGatewayApp(settings, loader)
        japp = jbuild_app(settings, loader, gateway=self.jax_gw)
        d = self.dirs["port"]
        papp = build_app(Settings(gateway_api_key=KEY,
                                  fallback_provider="fakeup", config_dir=d,
                                  db_dir=d / "db", logs_dir=d / "logs"),
                         loader=ConfigLoader(d, "fakeup"))
        self.port_gw = papp["gateway"]
        self.clients = {"jax": TestClient(TestServer(japp)),
                        "port": TestClient(TestServer(papp))}
        for c in self.clients.values():
            await c.start_server()
        return self

    async def __aexit__(self, *exc):
        for c in self.clients.values():
            await c.close()
        await self.up_server.close()
        # The JAX remote provider leaves httpx byte iterators to be closed
        # by tasks on this loop: let them finish.
        for _ in range(4):
            await asyncio.sleep(0.005)

    def loaders(self):
        return {"jax": self.jax_gw.loader, "port": self.port_gw.loader}

    async def both(self, method, path, **kw):
        """{side: (status, headers, body text)} of one request to each."""
        out = {}
        for side, client in self.clients.items():
            async with client.request(method, path, **kw) as resp:
                out[side] = (resp.status, resp.headers, await resp.text())
        return out


# (case, method, path, body): the config editor's API.
CONFIG_CASES = [
    ("get-rules", "GET", "/v1/config/models-rules", None),
    ("get-providers", "GET", "/v1/config/providers", None),
    ("save-rules", "POST", "/v1/config/models-rules",
     '[\n// renamed, comments kept\n{"gateway_model_name": "gw/renamed",\n'
     ' "fallback_models": [{"provider": "fakeup", "model": "real-b",},],},]'),
    ("save-providers", "POST", "/v1/config/providers",
     '[{"fakeup": {"baseUrl": "http://127.0.0.1:1/v1", "apikey": "K"}},\n'
     ' /* a second upstream */ {"other": {"baseUrl": "http://127.0.0.1:2"}}]'),
    ("unknown-provider", "POST", "/v1/config/models-rules",
     '[{"gateway_model_name": "x", "fallback_models": '
     '[{"provider": "ghost", "model": "m"}]}]'),
    ("no-providers", "POST", "/v1/config/providers", "[]"),
    ("fallback-provider-gone", "POST", "/v1/config/providers",
     '[{"other": {"baseUrl": "http://127.0.0.1:2"}}]'),
    ("syntax", "POST", "/v1/config/models-rules",
     '[{"gateway_model_name": '),
]


@pytest.mark.parametrize("case,method,path,body", CONFIG_CASES,
                         ids=[c[0] for c in CONFIG_CASES])
async def test_config_api_matches_jax(tmp_path, case, method, path, body):
    async with Apps(tmp_path) as apps:
        got = await apps.both(method, path, data=body, headers=AUTH)
        versions = {s: ld.version for s, ld in apps.loaders().items()}
        files = {s: {f.name: f.read_text() for f in d.glob("*.json")}
                 for s, d in apps.dirs.items()}
    (jstatus, _, jbody), (pstatus, _, pbody) = got["jax"], got["port"]
    assert pstatus == jstatus and versions["port"] == versions["jax"]
    assert files["port"]["models_fallback_rules.json"] == \
        files["jax"]["models_fallback_rules.json"]
    assert re.sub(r"http://[^\"]*", "URL", files["port"]["providers.json"]) \
        == re.sub(r"http://[^\"]*", "URL", files["jax"]["providers.json"])
    if method == "GET":
        assert re.sub(r"http://[^\"]*", "URL", pbody) == \
            re.sub(r"http://[^\"]*", "URL", jbody)
        return
    jdata, pdata = json.loads(jbody), json.loads(pbody)
    if case == "syntax":        # the two parsers word their errors apart
        assert pstatus == 400 and pdata["detail"] == jdata["detail"]
        assert pdata["errors"] and versions["port"] == 1
        return
    assert pdata == jdata
    assert versions["port"] == (2 if pstatus == 200 else 1)
    if body and pstatus == 200:
        which = "providers.json" if "providers" in path else \
            "models_fallback_rules.json"
        assert files["port"][which] == body      # verbatim, comments kept


async def test_saved_rules_route_at_once_and_json5_beyond_comments_is_refused(
        tmp_path):
    """A saved rule serves the next request. Unquoted keys, which the JAX
    package's json5 takes, get the port's 400 and are not saved."""
    async with Apps(tmp_path) as apps:
        client = apps.clients["port"]
        rules = ('[{"gateway_model_name": "gw/new", "fallback_models": '
                 '[{"provider": "fakeup", "model": "real-b"}]}]')
        resp = await client.post("/v1/config/models-rules", data=rules,
                                 headers=AUTH)
        assert resp.status == 200
        resp = await client.post("/v1/chat/completions", headers=AUTH, json={
            "model": "gw/new", "messages": []})
        assert resp.status == 200
        assert apps.upstream.requests[-1]["model"] == "real-b"
        unquoted = rules.replace('"gateway_model_name"', "gateway_model_name")
        got = await apps.both("POST", "/v1/config/models-rules",
                              data=unquoted, headers=AUTH)
        assert got["jax"][0] == 200 and got["port"][0] == 400
        assert json.loads(got["port"][2])["detail"] == \
            "invalid json5; file not saved"
        assert (apps.dirs["port"] / "models_fallback_rules.json"
                ).read_text() == rules
        assert apps.port_gw.loader.version == 2


@pytest.mark.parametrize("path", [
    "/v1/models", "/v1/models?includefallbackmodels=false",
    "/v1/models/AsOpenCodeFormat", "/v1/models/AsGitHubCopilotFormat",
    "/v1/models/AsGitHubCopilotFormat?includefallbackmodels=false"])
async def test_model_lists_match_jax(tmp_path, path):
    async with Apps(tmp_path) as apps:
        got = await apps.both("GET", path, headers=AUTH)

    def normal(text):
        data = json.loads(re.sub(r"http://127\.0\.0\.1:\d+", "HOST", text))
        for m in data.get("data", []) if isinstance(data, dict) else []:
            m.pop("created", None)
        return data
    assert got["port"][0] == got["jax"][0] == 200
    assert normal(got["port"][2]) == normal(got["jax"][2])


async def test_cors_and_the_request_id_match_jax(tmp_path):
    async with Apps(tmp_path) as apps:
        pre = await apps.both("OPTIONS", "/v1/chat/completions", headers={
            "Origin": "http://a.example",
            "Access-Control-Request-Method": "POST"})
        plain = await apps.both("OPTIONS", "/v1/chat/completions")
        ids = {}
        for supplied in ("client-id_1", "bad id!", None):
            headers = {**AUTH, **({"x-request-id": supplied}
                                  if supplied else {})}
            ids[supplied] = await apps.both("GET", "/v1/models",
                                            headers=headers)
        chats = {}
        for stream in (False, True):
            chats[stream] = await apps.both(
                "POST", "/v1/chat/completions",
                headers={**AUTH, "x-request-id": f"chat-{stream}"},
                json={"model": "gw/chat", "stream": stream,
                      "messages": [{"role": "user", "content": "hi"}]})
        seen = [h.get("x-request-id") for h in apps.upstream.headers_seen]
    cors = ("Access-Control-Allow-Origin", "Access-Control-Allow-Methods",
            "Access-Control-Allow-Headers")
    for side in ("jax", "port"):
        assert pre[side][0] == 204
        assert [pre[side][1].get(h) for h in cors] == \
            [pre["jax"][1].get(h) for h in cors]
        assert plain[side][0] == plain["jax"][0] and plain[side][0] in (
            404, 405)
        assert ids["client-id_1"][side][1]["x-request-id"] == "client-id_1"
        for refused in ("bad id!", None):
            assert re.fullmatch(r"[0-9a-f]{16}",
                                ids[refused][side][1]["x-request-id"])
        for stream in (False, True):
            status, headers, _ = chats[stream][side]
            assert status == 200
            assert headers["x-request-id"] == f"chat-{stream}"
    # Each app's two chat requests reached the upstream with their ids.
    assert seen == ["chat-False", "chat-False", "chat-True", "chat-True"]


async def test_cors_for_listed_origins_matches_jax():
    got = {}
    for side, mw in (("jax", jcors_middleware), ("port", cors_middleware)):
        app = web.Application(middlewares=[mw(["http://a.example"])])
        app.router.add_get("/x", lambda r: web.json_response({}))
        async with TestClient(TestServer(app)) as client:
            got[side] = []
            for origin in ("http://a.example", "http://evil.example", None):
                resp = await client.get("/x", headers={"Origin": origin}
                                        if origin else {})
                got[side].append((resp.headers.get(
                    "Access-Control-Allow-Origin"), resp.headers.get("Vary")))
    assert got["port"] == got["jax"]
    assert got["port"][0] == ("http://a.example", "Origin")


@pytest.mark.parametrize("path", [
    "/", "/v1/ui/rules-editor", "/v1/ui/usage-stats", "/static/editor.css",
    "/static/editor.js", "/static/usage-stats.css", "/static/usage-stats.js",
    "/static/missing.js"])
async def test_ui_routes_match_jax_without_auth(tmp_path, path):
    async with Apps(tmp_path) as apps:
        got = await apps.both("GET", path, allow_redirects=False)
    (jstatus, jheaders, _), (pstatus, pheaders, pbody) = got["jax"], \
        got["port"]
    assert pstatus == jstatus
    assert pheaders.get("Location") == jheaders.get("Location")
    assert pheaders.get("Content-Type") == jheaders.get("Content-Type")
    if pstatus == 200:
        assert pbody


# -- the provider registry ---------------------------------------------------

async def _until(cond, timeout_s=10.0):
    """Wait on the loop until ``cond()`` holds or the time is up."""
    loop = asyncio.get_running_loop()
    end = loop.time() + timeout_s
    while not cond() and loop.time() < end:
        await asyncio.sleep(0.01)


class StubProvider(Provider):
    type = "local"

    def __init__(self, name, details):
        self.name, self.details, self.closed = name, details, False
        self.engine = object()

    async def complete(self, request, observer):
        raise NotImplementedError

    async def close(self):
        self.closed = True


def _local(batch):
    return {"type": "local", "engine": {"preset": "tiny-test",
                                        "max_batch_size": batch}}


async def test_registry_rebuilds_a_changed_provider_and_retires_the_old(
        tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(ProviderRegistry, "RETIRE_AFTER_S", 0.01)
    (tmp_path / "providers.json").write_text(json.dumps(
        {"a": _local(2), "b": _local(4), "c": _local(8)}))
    (tmp_path / "models_fallback_rules.json").write_text("[]")
    loader = ConfigLoader(tmp_path)
    builds = []

    def factory(name, details):
        if name == "c":
            raise OSError("checkpoint shard truncated")
        builds.append(name)
        return StubProvider(name, details)
    registry = ProviderRegistry(loader, local_factory=factory)
    a1, b1 = await registry.get("a"), await registry.get("b")
    assert await registry.get("a") is a1 and builds == ["a", "b"]
    assert await registry.get("c") is None
    assert "provider c failed to build" in caplog.text
    v = loader.version
    loader.write_raw("providers", json.dumps(
        {"a": _local(3), "b": _local(4), "c": _local(8)}))
    assert loader.version == v + 1
    a2 = await registry.get("a")
    assert a2 is not a1 and a2.details.engine.max_batch_size == 3
    assert await registry.get("b") is b1 and builds == ["a", "b", "a"]
    assert not a1.closed                # in-flight requests may still use it
    await _until(lambda: a1.closed and not registry._retiring)
    assert a1.closed and not a2.closed and not registry._retiring
    assert {n for n, _ in registry.instantiated()} == {"a", "b"}
    assert set(registry.local_providers()) == {a2, b1}
    await registry.close()
    assert a2.closed and b1.closed and registry.instantiated() == []


HOT = {"preset": "tiny-test", "kv_page_size": 16, "prefix_cache": False,
       "max_seq_len": 256, "prefill_chunk": 32, "max_batch_size": 2,
       "dtype": "float32"}
CHAT = {"model": "gw/local", "temperature": 0, "max_tokens": 8,
        "messages": [{"role": "user", "content": "reload me " * 8}]}


async def test_hot_reload_from_a_preset_to_a_checkpoint_on_the_cpu(
        tmp_path, monkeypatch):
    monkeypatch.setattr(ProviderRegistry, "RETIRE_AFTER_S", 0.01)
    ckpt = write_checkpoint(tmp_path / "ckpt", "tiny-test")
    d = tmp_path / "config"
    d.mkdir()
    (d / "providers.json").write_text(json.dumps(
        [{"local": {"type": "local", "engine": HOT}}]))
    (d / "models_fallback_rules.json").write_text(json.dumps([
        {"gateway_model_name": "gw/local",
         "fallback_models": [{"provider": "local", "model": "tiny"}]}]))
    app = build_app(Settings(gateway_api_key=KEY, fallback_provider="local",
                             config_dir=d, db_dir=d / "db"),
                    loader=ConfigLoader(d, "local"),
                    local_factory=functools.partial(make_local_provider,
                                                    device="cpu"))
    gw = app["gateway"]
    saved = {**HOT, "model_path": str(ckpt)}
    direct = InferenceEngine(ProviderDetails.model_validate(
        {"type": "local", "engine": saved}).engine, device="cpu")
    async with TestClient(TestServer(app)) as client:
        assert (await client.post("/v1/chat/completions", json=CHAT,
                                  headers=AUTH)).status == 200
        old = (await gw.registry.get("local")).engine
        before = (d / "providers.json").read_text()
        resp = await client.post("/v1/config/providers", headers=AUTH,
                                 data=before.replace("}]", "}"))
        assert resp.status == 400 and gw.loader.version == 1
        assert (d / "providers.json").read_text() == before
        resp = await client.post("/v1/config/providers", headers=AUTH,
                                  data=json.dumps([{"local": {
                                      "type": "local", "engine": saved}}]))
        assert resp.status == 200
        assert (await resp.json())["config_version"] == 2
        resp = await client.post("/v1/chat/completions", json=CHAT,
                                 headers={**AUTH, "x-request-id": "hot-1"})
        assert resp.status == 200 and resp.headers["x-request-id"] == "hot-1"
        text = (await resp.json())["choices"][0]["message"]["content"]
        resp = await client.post("/v1/chat/completions", headers=AUTH,
                                 json={**CHAT, "stream": True})
        frames = SSEParser().feed(await resp.read())
        sse_text = "".join((f.json["choices"][0]["delta"].get("content")
                            or "") for f in frames
                           if f.json and f.json.get("choices"))
        new = (await gw.registry.get("local")).engine
        assert new is not old and new.cfg.model_path == str(ckpt)
        assert_trees_equal(load_checkpoint(ckpt, new.model_cfg,
                                           dtype=new.dtype), new.params)
        await _until(lambda: old.params is None)
        assert old.params is None and old.cache is None   # retired, closed
    provider = LocalProvider("direct", direct)
    req = provider._build_genrequest(CHAT)
    await direct.submit(req)
    want = "".join([d.text async for d in direct.stream(req)])
    await direct.close()
    assert text == sse_text == want and len(req.generated) == 8
