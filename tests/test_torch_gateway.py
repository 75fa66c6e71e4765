"""The port's gateway around the engine against the JAX package's, on the
CPU: the same ``FaultPlan`` scenarios go through the JAX ``Router`` (httpx
provider) and the port's ``Router`` (aiohttp provider), each against its
own fresh ``FakeUpstream`` on a loopback port, and must agree on the
served target, the attempts, the terminal status and ``retry_after_s``,
the relayed text and ``[DONE]``, the retry sleeps, what the upstream saw
(bodies and headers) and the usage rows written. Then a chain from a
failing remote upstream to the port's local engine (tiny-test) answers as
the local rule alone does, and an overloaded engine's 429 carries the
JAX formula's ``Retry-After``."""
import asyncio
import dataclasses
import functools
import json
import math
import time

import pytest
from aiohttp.test_utils import TestClient, TestServer

import llmapigateway_tpu.config.loader as jloader
import llmapigateway_tpu.db.rotation as jrotation
import llmapigateway_tpu.providers.base as jbase
import llmapigateway_tpu.reliability.breaker as jbreaker
import llmapigateway_tpu.routing.router as jrouter
import llmapigateway_tpu.server.usage_capture as jcapture
import llmapigateway_tpu_torch.config.loader as tloader
import llmapigateway_tpu_torch.db.rotation as trotation
import llmapigateway_tpu_torch.providers.base as tbase
import llmapigateway_tpu_torch.reliability.breaker as tbreaker
import llmapigateway_tpu_torch.routing.router as trouter
import llmapigateway_tpu_torch.server.usage_capture as tcapture
from llmapigateway_tpu.engine.engine import InferenceEngine as JEngine
from llmapigateway_tpu_torch.config.loader import ConfigLoader
from llmapigateway_tpu_torch.config.settings import Settings
from llmapigateway_tpu_torch.engine.engine import GenRequest
from llmapigateway_tpu_torch.providers.local import make_local_provider
from llmapigateway_tpu_torch.server.app import build_app
from llmapigateway_tpu_torch.utils.sse import SSEParser
from tests.fake_upstream import FakeUpstream, FaultPlan
from tests.test_torch_engine import one_torch_thread  # noqa: F401

PACKAGES = {
    "jax": dict(loader=jloader, rotation=jrotation, base=jbase,
                breaker=jbreaker, router=jrouter, capture=jcapture),
    "port": dict(loader=tloader, rotation=trotation, base=tbase,
                 breaker=tbreaker, router=trouter, capture=tcapture),
}
# Headers the router or provider set, compared case-insensitively.
SENT_HEADERS = ("authorization", "content-type", "http-referer", "x-title",
                "x-custom")
UPSTREAM_KEY = "UPKEY"


class FakeClock:
    def __init__(self) -> None:
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


def overloaded_provider(base, name: str, hint: float):
    """A local stand-in of ``base``'s Provider contract that sheds every
    request as an overloaded engine does, with a Retry-After hint."""
    class Overloaded(base.Provider):
        type = "local"

        async def complete(self, request, observer):
            return None, base.CompletionError(
                "engine admission queue is full", status=503,
                kind="overload", retry_after_s=hint)
    provider = Overloaded()
    provider.name = name
    return provider


def _providers(url: str, breaker: dict | None) -> list:
    remote = {"baseUrl": url, "apikey": UPSTREAM_KEY}
    if breaker is not None:
        remote["breaker"] = breaker
    return [{"openrouter": remote},
            {"backup": {"baseUrl": url, "apikey": UPSTREAM_KEY}},
            {"local-a": {"type": "local", "engine": {"preset": "tiny-test"}}},
            {"local-b": {"type": "local", "engine": {"preset": "tiny-test"}}}]


def _target(provider="openrouter", model="real-a", **kw) -> dict:
    return {"provider": provider, "model": model, **kw}


PINNED = _target(providers_order=["Cerebras", "DeepInfra"],
                 custom_body_params={"top_k": 3, "seed": 7},
                 custom_headers={"X-Custom": "yes", "X-Title": "custom"})
BACKUP = _target("backup", "real-b")

# name → (plan, rule fields, steps, providers' breaker block); a step is
# (clock advance in seconds, stream).
SCENARIOS = {
    "json-healthy": (FaultPlan(), {"fallback_models": [PINNED]},
                     [(0, False)], None),
    "sse-healthy": (FaultPlan(), {"fallback_models": [PINNED]},
                    [(0, True)], None),
    "fail-next-retries": (
        FaultPlan(fail_next=2),
        {"fallback_models": [_target(retry_count=2, retry_delay=0.01)]},
        [(0, True)], None),
    "fail-statuses-429-429-0": (
        FaultPlan(fail_statuses=[429, 429, 0]),
        {"fallback_models": [_target(retry_count=2, retry_delay=0.5)]},
        [(0, False)], None),
    "inband-error-falls-back": (
        FaultPlan(inband_error_next=1),
        {"fallback_models": [_target(), BACKUP]}, [(0, True)], None),
    "inband-error-json-falls-back": (
        FaultPlan(inband_error_next=1),
        {"fallback_models": [_target(), BACKUP]}, [(0, False)], None),
    "midstream-error-in-band": (
        FaultPlan(midstream_error_after=2),
        {"fallback_models": [_target(), BACKUP]}, [(0, True)], None),
    "disconnect-after-frames": (
        FaultPlan(disconnect_after_frames=2),
        {"fallback_models": [_target(), BACKUP]}, [(0, True)], None),
    "omit-usage": (FaultPlan(omit_usage=True),
                   {"fallback_models": [_target()]},
                   [(0, True), (0, False)], None),
    "delay-beyond-timeout-alone": (
        FaultPlan(delay_s=0.4),
        {"fallback_models": [_target()], "timeout_ms": 200},
        [(0, True)], None),
    # The budget is the request's, not the attempt's: once the first
    # target has spent it, the second is never tried (504 in both).
    "delay-beyond-timeout-chain": (
        FaultPlan(delay_s=0.4),
        {"fallback_models": [_target(), BACKUP], "timeout_ms": 200},
        [(0, False)], None),
    "stall-after-frames-under-deadline": (
        FaultPlan(stall_after_frames=2, stall_s=0.5),
        {"fallback_models": [_target()], "timeout_ms": 250},
        [(0, True)], None),
    "provider-order-sub-loop": (
        FaultPlan(fail_next=2),
        {"fallback_models": [_target(
            use_provider_order_as_fallback=True,
            providers_order=["A", "B", "C"])]},
        [(0, True)], None),
    "rotation": (FaultPlan(),
                 {"fallback_models": [_target(), BACKUP],
                  "rotate_models": True},
                 [(0, False)] * 4, None),
    # Two failures open the breaker (min_requests 2); the third request
    # skips the target (429, Retry-After = the cooldown left); after the
    # cooldown the half-open probe succeeds and closes it.
    "breaker-open-skip-half-open-probe": (
        FaultPlan(fail_next=2),
        {"fallback_models": [_target()]},
        [(0, False), (1, False), (4, False), (10, True), (0, False)],
        {"min_requests": 2, "failure_threshold": 0.5, "cooldown_s": 10,
         "window_s": 30}),
    "all-overloaded": (FaultPlan(),
                       {"fallback_models": [_target("local-a", "tiny"),
                                            _target("local-b", "tiny")]},
                       [(0, False)], None),
}


class RowSink:
    """Stands in for the usage DB: keeps each inserted row (thread-safe
    appends from the collectors' executor threads)."""

    def __init__(self) -> None:
        self.rows: list[dict] = []

    def insert(self, rec) -> None:
        row = dataclasses.asdict(rec)
        for volatile in ("timestamp", "ttft_ms", "tokens_per_sec"):
            row.pop(volatile)
        self.rows.append(row)


def _consume_json(data: dict) -> dict:
    msg = data["choices"][0]["message"]
    return {"text": msg.get("content", ""), "done": None, "errors": [],
            "usage": data.get("usage")}


async def _consume_sse(frames) -> dict:
    parser, parsed = SSEParser(), []
    async for chunk in frames:
        parsed.extend(parser.feed(chunk))
    text, errors, done = [], [], False
    for frame in parsed:
        if frame.is_done:
            done = True
            continue
        obj = frame.json or {}
        if "error" in obj:
            errors.append(obj["error"].get("provider"))
        for ch in obj.get("choices") or []:
            text.append((ch.get("delta") or {}).get("content") or "")
    return {"text": "".join(text), "done": done, "errors": errors}


async def _run_gateway(pkg: str, tmp_path, name: str) -> dict:
    """One fresh upstream with the scenario's plan and one gateway of
    ``pkg`` in front of it; run the scenario's steps in turn."""
    plan, rule, steps, breaker = SCENARIOS[name]
    mods = PACKAGES[pkg]
    upstream = FakeUpstream()
    upstream.plan = dataclasses.replace(
        plan, fail_statuses=list(plan.fail_statuses),
        tokens=list(plan.tokens))
    server = TestServer(upstream.app)
    await server.start_server()
    cfg = tmp_path / pkg
    cfg.mkdir()
    (cfg / "providers.json").write_text(json.dumps(
        _providers(str(server.make_url("/v1")), breaker)))
    (cfg / "models_fallback_rules.json").write_text(json.dumps(
        [{"gateway_model_name": "gw/model", **rule}]))
    clock, sleeps, sink, collectors = FakeClock(), [], RowSink(), []

    async def fake_sleep(s: float) -> None:
        sleeps.append(s)

    def observer_factory(provider: str, model: str):
        c = mods["capture"].UsageCollector(provider=provider, model=model,
                                           usage_db=sink)
        collectors.append(c)
        return c

    hints = {"local-a": 2.5, "local-b": 7.25}
    loader = mods["loader"].ConfigLoader(cfg, fallback_provider="openrouter")
    registry = mods["router"].ProviderRegistry(
        loader, local_factory=lambda n, d: overloaded_provider(
            mods["base"], n, hints[n]))
    breakers = mods["breaker"].BreakerRegistry(loader, clock=clock)
    rotation = mods["rotation"].RotationDB(cfg / "db")
    router = mods["router"].Router(loader, registry, rotation,
                                   fallback_provider="openrouter",
                                   sleep=fake_sleep, breakers=breakers)
    results = []
    try:
        for advance, stream in steps:
            clock.t += advance
            n_before = len(upstream.requests)
            payload = {"model": "gw/model", "stream": stream,
                       "messages": [{"role": "user", "content": "hi"}]}
            out = await router.dispatch(payload, "client-key",
                                        observer_factory)
            step = {"provider": out.provider, "model": out.model,
                    "attempts": out.attempts,
                    "status": out.error.status if out.error else 200,
                    "kind": out.error.kind if out.error else "",
                    "retry_after_s": (round(out.error.retry_after_s, 6)
                                      if out.error and
                                      out.error.retry_after_s is not None
                                      else None),
                    "upstream_hits": len(upstream.requests) - n_before}
            if isinstance(out.result, mods["base"].JSONCompletion):
                step.update(_consume_json(out.result.data))
            elif out.result is not None:
                step.update(await _consume_sse(out.result.frames))
            step["breaker"] = {
                k: v for k, v in breakers.get("openrouter").snapshot().items()
                if k != "last_transition"}
            results.append(step)
        # Usage rows: every ended collector that saw text or usage writes
        # one, from an executor thread.
        want = sum(1 for c in collectors if c._ended and (c._usage or c._text))
        t_end = time.monotonic() + 5
        while len(sink.rows) < want and time.monotonic() < t_end:
            await asyncio.sleep(0.005)
    finally:
        await registry.close()
        rotation.close()
        await server.close()
        # Let async-generator finalizers the providers left behind run on
        # this loop before the next test.
        for _ in range(3):
            await asyncio.sleep(0.01)
    headers = [{k.lower(): v for k, v in h.items()
                if k.lower() in SENT_HEADERS} for h in upstream.headers_seen]
    return {"steps": results, "sleeps": sleeps,
            "upstream_bodies": upstream.requests, "upstream_headers": headers,
            "rows": sorted(sink.rows, key=json.dumps)}


@pytest.mark.parametrize("name", list(SCENARIOS))
async def test_one_upstream_two_gateways(tmp_path, name):
    jax_run = await _run_gateway("jax", tmp_path, name)
    port_run = await _run_gateway("port", tmp_path, name)
    for key in jax_run:
        assert port_run[key] == jax_run[key], (name, key)
    # Each scenario shows what it is about, so a fault both share fails.
    steps = port_run["steps"]
    bodies = port_run["upstream_bodies"]
    for body in bodies:
        assert "timeout_ms" not in body and body["model"] in ("real-a",
                                                              "real-b")
    if name.endswith("healthy"):
        assert steps[0]["status"] == 200 and steps[0]["text"] == "Hello world!"
        assert bodies[0]["usage"] == {"include": True}
        assert bodies[0]["provider"] == {"order": ["Cerebras", "DeepInfra"],
                                         "allow_fallbacks": False}
        assert bodies[0]["top_k"] == 3 and bodies[0]["seed"] == 7
        assert port_run["upstream_headers"][0] == {
            "authorization": f"Bearer {UPSTREAM_KEY}",
            "content-type": "application/json",
            "http-referer": trouter.REFERER, "x-title": "custom",
            "x-custom": "yes"}
        assert port_run["rows"][0]["prompt_tokens"] == 7
    expect = {
        "sse-healthy": dict(done=True, attempts=1),
        "fail-next-retries": dict(attempts=3, status=200),
        "fail-statuses-429-429-0": dict(attempts=3, status=200),
        "inband-error-falls-back": dict(attempts=2, provider="backup",
                                        done=True),
        "inband-error-json-falls-back": dict(attempts=2, provider="backup"),
        "midstream-error-in-band": dict(attempts=1, provider="openrouter",
                                        text="Hello ", done=False,
                                        errors=["openrouter"]),
        "disconnect-after-frames": dict(attempts=1, text="Hello ",
                                        done=False, errors=["openrouter"]),
        "delay-beyond-timeout-alone": dict(status=504, attempts=1),
        "delay-beyond-timeout-chain": dict(status=504, attempts=1),
        "stall-after-frames-under-deadline": dict(
            status=200, text="Hello ", done=False, errors=["openrouter"]),
        "provider-order-sub-loop": dict(attempts=3, status=200),
        "all-overloaded": dict(status=429, attempts=2, retry_after_s=7.25),
    }.get(name, {})
    for key, value in expect.items():
        assert steps[0][key] == value, (name, key, steps[0])
    if name == "fail-next-retries":
        assert port_run["sleeps"] == [0.01, 0.01]
    if name == "provider-order-sub-loop":
        assert [b["provider"]["order"] for b in bodies] == [["A"], ["B"],
                                                            ["C"]]
    if name == "rotation":
        assert [s["provider"] for s in steps] == ["openrouter", "backup"] * 2
    if name == "omit-usage":
        assert [r["total_tokens"] for r in port_run["rows"]] == [0, 0]
    if name.startswith("breaker"):
        assert [s["status"] for s in steps] == [503, 503, 429, 200, 200]
        assert [s["upstream_hits"] for s in steps] == [1, 1, 0, 1, 1]
        assert steps[2]["retry_after_s"] == 6.0       # opened 4 s before
        assert [s["breaker"]["state"] for s in steps] == [
            "closed", "open", "open", "closed", "closed"]


# ---------------------------------------------------------------------------
# Remote to local, and the retry-after repair, through the port's app
# ---------------------------------------------------------------------------

LOCAL_ENGINE = {"preset": "tiny-test", "kv_page_size": 16,
                "prefix_cache": False, "max_seq_len": 256,
                "prefill_chunk": 32, "max_batch_size": 2, "dtype": "float32"}


def _app(tmp_path, upstream_url: str):
    (tmp_path / "providers.json").write_text(json.dumps([
        {"upstream": {"baseUrl": upstream_url, "apikey": UPSTREAM_KEY}},
        {"local": {"type": "local", "engine": LOCAL_ENGINE}}]))
    (tmp_path / "models_fallback_rules.json").write_text(json.dumps([
        {"gateway_model_name": "gw/local",
         "fallback_models": [{"provider": "local", "model": "tiny"}]},
        {"gateway_model_name": "gw/chain",
         "fallback_models": [{"provider": "upstream", "model": "x",
                              "retry_count": 1},
                             {"provider": "local", "model": "tiny"}]}]))
    settings = Settings(fallback_provider="local", config_dir=tmp_path,
                        db_dir=tmp_path / "db")
    return build_app(settings, loader=ConfigLoader(tmp_path, "local"),
                     local_factory=functools.partial(make_local_provider,
                                                     device="cpu"))


def _chat(model: str, stream: bool) -> dict:
    return {"model": model, "stream": stream, "temperature": 0,
            "max_tokens": 6,
            "messages": [{"role": "user", "content": "fail over " * 8}]}


async def _text(resp) -> str:
    if resp.headers["Content-Type"].startswith("text/event-stream"):
        frames = list(SSEParser().feed(await resp.read()))
        assert frames[-1].is_done
        return "".join((c.get("delta") or {}).get("content") or ""
                       for f in frames[:-1]
                       for c in f.json.get("choices") or [])
    return (await resp.json())["choices"][0]["message"]["content"]


async def test_remote_failure_fails_over_to_the_local_engine(tmp_path):
    upstream = FakeUpstream()
    upstream.plan.fail_next = 100
    server = TestServer(upstream.app)
    await server.start_server()
    try:
        app = _app(tmp_path, str(server.make_url("/v1")))
        async with TestClient(TestServer(app)) as client:
            texts = {}
            for model in ("gw/local", "gw/chain"):
                for stream in (False, True):
                    resp = await client.post("/v1/chat/completions",
                                             json=_chat(model, stream))
                    assert resp.status == 200, await resp.text()
                    texts[model, stream] = await _text(resp)
            # Greedy: the chain's answers are the local rule's, JSON and
            # SSE alike, after two failed remote attempts each.
            assert texts["gw/chain", False] == texts["gw/local", False]
            assert texts["gw/chain", True] == texts["gw/local", True]
            assert texts["gw/local", True] == texts["gw/local", False]
            assert len(upstream.requests) == 4
            await asyncio.to_thread(app["gateway"].usage_recorder.flush)
            resp = await client.get("/v1/api/usage-records")
            records = (await resp.json())["records"]
            assert [r["provider"] for r in records] == ["local"] * 4
            assert all(r["completion_tokens"] > 0 for r in records)
            resp = await client.get("/v1/api/health/providers")
            health = (await resp.json())["providers"]
            assert health["upstream"]["window_requests"] == 4
            assert health["upstream"]["failure_rate"] == 1.0
            assert health["local"]["state"] == "closed"
    finally:
        await server.close()


class _JaxHint:
    """The JAX engine's ``retry_after_hint_s`` reads these four."""

    def __init__(self, step_stats, step_fit, wait, queue):
        self._ema_step_ms_stats = step_stats
        self._queue_wait_ema_ms = wait
        self._queue = queue
        self._step_ms_estimate = lambda: step_fit


@pytest.mark.parametrize("telemetry", [
    (250.0, None, 1500.0),      # 16 queued: 1.5 + 4 s
    (None, 4.2, 30.0),          # no steady pair yet: the fitted step
    (None, None, None),         # nothing measured: the 1 s floor
    (3000.0, None, 9000.0),     # the 30 s ceiling
])
async def test_overload_retry_after_is_the_engine_hint(tmp_path, telemetry):
    step_stats, step_fit, wait = telemetry
    app = _app(tmp_path, "http://127.0.0.1:1/v1")
    async with TestClient(TestServer(app)) as client:
        provider = await app["gateway"].registry.get("local")
        engine = provider.engine
        engine._ema_step_ms_stats = step_stats
        engine._queue_wait_ema_ms = wait
        engine._step_ms_estimate = lambda: step_fit
        # A full admission queue: the next submit is shed.
        while not engine._queue.full():
            engine._queue.put_nowait(GenRequest(prompt_ids=[1, 2],
                                                max_tokens=1))
        want = JEngine.retry_after_hint_s(
            _JaxHint(step_stats, step_fit, wait, engine._queue))
        assert engine.retry_after_hint_s() == want
        resp = await client.post("/v1/chat/completions",
                                 json=_chat("gw/local", False))
        assert resp.status == 429
        assert resp.headers["Retry-After"] == str(max(1, math.ceil(want)))


async def test_local_slo_outcome_and_deadline(tmp_path):
    """The local provider evaluates the request's SLO targets into its
    usage block and the usage row; a deadline that expires before the
    first token answers 504 and the engine drops the cancelled request."""
    app = _app(tmp_path, "http://127.0.0.1:1/v1")
    async with TestClient(TestServer(app)) as client:
        slos = []
        for ttft, tpot in (("100000", "100000"), ("0.001", None)):
            headers = {"x-slo-ttft-ms": ttft}
            if tpot:
                headers["x-slo-tpot-ms"] = tpot
            resp = await client.post("/v1/chat/completions",
                                     json=_chat("gw/local", False),
                                     headers=headers)
            slos.append((await resp.json())["usage"]["slo"])
        assert slos[0]["met"] and slos[0]["ttft_target_ms"] == 100000.0
        assert not slos[1]["met"] and slos[1]["phase"] in ("queued",
                                                           "prefill")
        assert slos[1]["attribution"]["decode_contention_ms"] == 0.0
        gw = app["gateway"]
        await asyncio.to_thread(gw.usage_recorder.flush)
        rows = gw.usage_db.latest(2, 0)
        assert [(r["slo_met"], r["slo_phase"]) for r in rows] == [
            (0, slos[1]["phase"]), (1, None)]

        engine = (await gw.registry.get("local")).engine
        step = engine._step

        async def late_step():
            await asyncio.sleep(0.3)
            return await step()
        engine._step = late_step
        resp = await client.post("/v1/chat/completions",
                                 json=_chat("gw/local", True),
                                 headers={"x-request-timeout-ms": "100"})
        assert resp.status == 504
        assert "deadline" in (await resp.json())["error"]["message"]
        t_end = time.monotonic() + 10
        while time.monotonic() < t_end and (
                engine.stats()["queued"] or engine.stats()["running"]):
            await asyncio.sleep(0.05)
        assert engine.stats()["free_slots"] == engine.B
        engine._step = step
