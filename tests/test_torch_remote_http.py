"""The port's remote provider (aiohttp) against the JAX package's (httpx)
on the same upstream bytes: SSE priming (first real frame before commit,
an in-band error before it falls back, ``[DONE]`` before any content is
an error, ``[DONE]`` in the priming chunk is kept, keep-alive comments
dropped, frames split across chunks), JSON bodies, HTTP errors, the
relayed bytes and the observer's events; then what only the transport
decides: timeouts under an expired deadline, a refused connection, the
models list, and an error frame that shares a chunk with the first
content frame."""
import asyncio
import json

import pytest
from aiohttp import web
from aiohttp.test_utils import TestServer

from llmapigateway_tpu.providers.base import CompletionRequest as JRequest
from llmapigateway_tpu.providers.remote_http import (
    RemoteHTTPProvider as JProvider)
from llmapigateway_tpu.reliability.deadline import Deadline as JDeadline
from llmapigateway_tpu_torch.providers.base import CompletionRequest
from llmapigateway_tpu_torch.providers.remote_http import RemoteHTTPProvider
from llmapigateway_tpu_torch.reliability.deadline import Deadline
from llmapigateway_tpu_torch.utils.sse import SSEParser


def _data(obj) -> bytes:
    return f"data: {obj if isinstance(obj, str) else json.dumps(obj)}\n\n".encode()


def _chunk(text: str) -> dict:
    return {"id": "c", "object": "chat.completion.chunk",
            "choices": [{"index": 0, "delta": {"content": text},
                         "finish_reason": None}]}


USAGE = {"prompt_tokens": 3, "completion_tokens": 2, "total_tokens": 5}
FINAL = {"id": "c", "choices": [{"index": 0, "delta": {},
                                 "finish_reason": "stop"}], "usage": USAGE}

# name → (status, content type, body chunks); each chunk is written and
# flushed on its own, 5 ms apart.
UPSTREAMS = {
    "sse-healthy": (200, "text/event-stream",
                    [_data(_chunk("Hel")), _data(_chunk("lo")), _data(FINAL),
                     _data("[DONE]")]),
    "sse-done-in-priming-chunk": (200, "text/event-stream",
                                  [_data(_chunk("Hi")) + _data(FINAL)
                                   + _data("[DONE]")]),
    "sse-keepalive-and-split-frames": (
        200, "text/event-stream",
        [b": keep-alive\n\n", b"data: " + json.dumps(_chunk("a")).encode()[:9],
         json.dumps(_chunk("a")).encode()[9:] + b"\n\n",
         b"event: x\r\ndata: " + json.dumps(_chunk("b")).encode() + b"\r\n\r\n",
         _data(FINAL), _data("[DONE]")]),
    "sse-done-before-content": (200, "text/event-stream",
                                [b": ping\n\n", _data("[DONE]")]),
    "sse-closed-before-data": (200, "text/event-stream", [b": ping\n\n"]),
    "sse-inband-error-first": (200, "text/event-stream",
                               [_data({"error": {"message": "busy"}}),
                                _data(_chunk("never"))]),
    "sse-detail-error-first": (200, "text/event-stream",
                               [_data({"detail": "bad model"})]),
    "sse-code-error-midstream": (200, "text/event-stream",
                                 [_data(_chunk("x")), _data({"code": 500}),
                                  _data(_chunk("never"))]),
    "sse-no-done-unterminated-tail": (200, "text/event-stream",
                                      [_data(_chunk("x")),
                                       b"data: " + json.dumps(FINAL).encode()]),
    "json-healthy": (200, "application/json",
                     [json.dumps({"id": "c", "object": "chat.completion",
                                  "choices": [{"index": 0, "message": {
                                      "role": "assistant", "content": "ok"},
                                      "finish_reason": "stop"}],
                                  "usage": USAGE}).encode()]),
    "json-inband-error": (200, "application/json",
                          [b'{"error": {"message": "quota"}}']),
    "json-not-json": (200, "application/json", [b"<html>oops</html>"]),
    "http-429": (429, "application/json",
                 [b'{"error": {"message": "slow down"}}']),
    "http-500-long-body": (500, "text/plain", [b"x" * 3000]),
}


class Recorder:
    """The observer's events; the first token counts once, as in the
    usage collector (the JAX provider calls it for every frame of the
    priming chunk)."""

    def __init__(self) -> None:
        self.events: list = []

    def on_first_token(self) -> None:
        if "first" not in self.events:
            self.events.append("first")

    def on_content_delta(self, text: str) -> None:
        self.events.append(("delta", text))

    def on_usage(self, usage) -> None:
        self.events.append(("usage", usage))

    def on_stream_end(self, error=None) -> None:
        self.events.append(("end", error))


async def _serve(chunks_by_path: dict) -> TestServer:
    async def handler(request: web.Request) -> web.StreamResponse:
        status, ctype, chunks = chunks_by_path[request.match_info["name"]]
        resp = web.StreamResponse(status=status,
                                  headers={"Content-Type": ctype})
        await resp.prepare(request)
        for chunk in chunks:
            await resp.write(chunk)
            await asyncio.sleep(0.005)
        await resp.write_eof()
        return resp
    app = web.Application()
    app.router.add_post("/{name}/chat/completions", handler)
    server = TestServer(app)
    await server.start_server()
    return server


async def _call(provider, request, stream: bool) -> dict:
    rec = Recorder()
    result, error = await provider.complete(request, rec)
    out = {"error": None if error is None else
           (error.status, error.kind, error.detail[:40], len(error.detail))}
    if result is None:
        out["frames"] = None
    elif stream:
        body = b"".join([f async for f in result.frames])
        out["frames"] = [f.json if f.json is not None else f.data
                         for f in SSEParser().feed(body)]
    else:
        out["frames"] = result.data
    out["events"] = rec.events
    return out


@pytest.mark.parametrize("name", list(UPSTREAMS))
async def test_relay_and_errors_match_jax(name):
    server = await _serve(UPSTREAMS)
    base = str(server.make_url(f"/{name}"))
    jprov = JProvider("up", base, api_key="K")
    tprov = RemoteHTTPProvider("up", base, api_key="K")
    stream = name.startswith("sse")
    payload = {"model": "m", "stream": stream, "messages": []}
    try:
        want = await _call(jprov, JRequest(payload=dict(payload),
                                           stream=stream), stream)
        got = await _call(tprov, CompletionRequest(payload=dict(payload),
                                                   stream=stream), stream)
    finally:
        await jprov.close()
        await tprov.close()
        await server.close()
        for _ in range(3):
            await asyncio.sleep(0.005)
    assert got == want
    if name == "sse-healthy":
        assert got["frames"][-1] == "[DONE]" and got["events"][0] == "first"
        assert ("usage", USAGE) in got["events"]
    if name == "http-500-long-body":
        assert got["error"][0] == 500 and got["error"][3] == 2000
    if name in ("sse-done-before-content", "sse-closed-before-data",
                "sse-inband-error-first", "json-not-json"):
        assert got["frames"] is None and got["error"][0] is None


async def test_error_frame_in_the_first_content_chunk_is_surfaced():
    """Frames after the first content frame in the same chunk are relayed
    as later frames are: an error among them ends the stream in-band and
    reaches the observer (the JAX provider passes such a frame on raw)."""
    server = await _serve({"x": (200, "text/event-stream", [
        _data(_chunk("a")) + _data({"error": {"message": "boom"}})
        + _data(_chunk("never"))])})
    prov = RemoteHTTPProvider("up", str(server.make_url("/x")))
    try:
        out = await _call(prov, CompletionRequest(
            payload={"model": "m"}, stream=True), True)
    finally:
        await prov.close()
        await server.close()
    assert out["frames"][-1] == {"error": {"message": "boom",
                                           "provider": "up"}}
    assert out["events"] == ["first", ("delta", "a"), ("end", "boom")]


async def test_transport_failures_are_classified_like_jax():
    """An expired deadline times out (kind "timeout"), a refused
    connection is a network error without a status; neither raises."""
    async def slow(request):
        await asyncio.sleep(0.3)
        return web.json_response({})
    app = web.Application()
    app.router.add_post("/v1/chat/completions", slow)
    server = TestServer(app)
    await server.start_server()
    url = str(server.make_url("/v1"))
    out = {}
    for tag, prov, req, dl in (
            ("jax", JProvider("up", url), JRequest, JDeadline),
            ("port", RemoteHTTPProvider("up", url), CompletionRequest,
             Deadline)):
        try:
            for stream in (False, True):
                _, err = await prov.complete(
                    req(payload={"model": "m", "stream": stream},
                        stream=stream, deadline=dl(0.05)), Recorder())
                out[tag, "deadline", stream] = (err.status, err.kind,
                                                err.retryable)
        finally:
            await prov.close()
        refused = (JProvider if tag == "jax" else RemoteHTTPProvider)(
            "dead", "http://127.0.0.1:1/v1")
        try:
            _, err = await refused.complete(
                req(payload={"model": "m"}, stream=False), Recorder())
            out[tag, "refused"] = (err.status, err.kind, err.retryable,
                                   err.detail.split(":")[0])
        finally:
            await refused.close()
    await server.close()
    for key in [k for k in out if k[0] == "port"]:
        assert out[key] == out[("jax",) + key[1:]], key
    assert out["port", "deadline", True] == (None, "timeout", True)
    assert out["port", "refused"][3] == "network error contacting dead"


async def test_list_models_matches_jax():
    async def models(request):
        return web.json_response({"object": "list",
                                  "data": [{"id": "a"}, {"id": "b"}]})
    app = web.Application()
    app.router.add_get("/v1/models", models)
    server = TestServer(app)
    await server.start_server()
    prov = RemoteHTTPProvider("up", str(server.make_url("/v1")) + "/")
    jprov = JProvider("up", str(server.make_url("/v1")))
    missing = RemoteHTTPProvider("up", str(server.make_url("/nope")))
    try:
        assert await prov.list_models() == await jprov.list_models() == [
            {"id": "a"}, {"id": "b"}]
        assert await missing.list_models() is None
    finally:
        for p in (prov, jprov, missing):
            await p.close()
        await server.close()
    assert prov._session is None         # close() released the session
