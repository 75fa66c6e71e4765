"""POST /v1/chat/completions — a thin HTTP shim over the router
(counterpart of the JAX package's ``server/chat.py``). The body is parsed
leniently (utils/json5lite.py: comments and trailing commas). Streaming
responses are committed (200, SSE headers) only after routing has produced
a primed stream, so a failure before the first token still falls back.

The request id (server/middleware.py) goes upstream with every attempt
and comes back on the response. The client's ``x-request-timeout-ms``
header (or ``timeout_ms`` body field) becomes the request's deadline budget
and ``x-slo-ttft-ms`` / ``x-slo-tpot-ms`` its SLO targets. An exhausted budget answers **504**
with the partial-attempt log; an all-overloaded or all-breaker-open chain
**429** with a numeric ``Retry-After`` from the engine's telemetry or the
breakers' cooldowns; anything else **503**. Each attempt gets a usage
collector (server/usage_capture.py) that records the completed one.
"""
from __future__ import annotations

import functools
import logging
import math

from aiohttp import web

from ..obs.slo import slo_from_headers
from ..providers.base import JSONCompletion, StreamingCompletion
from ..reliability.deadline import budget_ms_from_request
from ..utils import json5lite
from .middleware import client_api_key
from .usage_capture import UsageCollector

logger = logging.getLogger(__name__)


async def chat_completions(request: web.Request) -> web.StreamResponse:
    gw = request.app["gateway"]
    try:
        payload = json5lite.loads(await request.text())
        if not isinstance(payload, dict):
            raise ValueError("body must be a JSON object")
    except ValueError as e:
        return web.json_response(
            {"error": {"message": f"invalid request body: {e}", "code": 400}},
            status=400)
    if "model" not in payload:
        return web.json_response(
            {"error": {"message": "missing required field 'model'", "code": 400}},
            status=400)

    timeout_ms = budget_ms_from_request(request.headers, payload)
    slo = slo_from_headers(request.headers)
    observer_factory = functools.partial(_make_collector, payload=payload,
                                         gw=gw)
    outcome = await gw.router.dispatch(
        payload, client_api_key(request), observer_factory,
        timeout_ms=timeout_ms, request_id=request.get("request_id", ""),
        slo=slo)

    if outcome.error is not None or outcome.result is None:
        err = outcome.error
        detail = str(err) if err else "no providers succeeded"
        status = err.status if err and err.status in (429, 504) else 503
        headers = {}
        if status == 429:
            # Numeric Retry-After (RFC 9110 delay-seconds).
            headers["Retry-After"] = str(
                max(1, math.ceil(err.retry_after_s or 1.0)))
        message = {
            429: f"Gateway overloaded. {detail}",
            504: f"Request deadline exceeded. {detail}",
        }.get(status, f"All fallback models failed. Last error: {detail}")
        return web.json_response(
            {"error": {"message": message, "code": status,
                       "attempts": outcome.attempts}},
            status=status, headers=headers)

    result = outcome.result
    if isinstance(result, JSONCompletion):
        return web.json_response(result.data)

    assert isinstance(result, StreamingCompletion)
    headers = {"Content-Type": "text/event-stream",
               "Cache-Control": "no-cache", "X-Accel-Buffering": "no",
               "Connection": "keep-alive"}
    # A prepared response passes the request-id middleware by; set it here.
    if request.get("request_id"):
        headers["x-request-id"] = request["request_id"]
    resp = web.StreamResponse(status=200, headers=headers)
    # The status on the wire, for the request log should the stream die.
    request["prepared_status"] = 200
    await resp.prepare(request)
    try:
        async for frame in result.frames:
            await resp.write(frame)
        await resp.write_eof()
    except ConnectionResetError:
        # Client hung up mid-stream; closing the generator cancels the
        # engine slot (or the upstream stream) and records the usage of
        # what was streamed.
        logger.info("client disconnected mid-stream")
        await result.frames.aclose()
    return resp


def _make_collector(provider: str, model: str, *, payload: dict,
                    gw) -> UsageCollector:
    settings = gw.settings
    # The write-behind recorder duck-types UsageDB.insert: stream-end
    # observers enqueue instead of writing SQLite inline.
    return UsageCollector(
        provider=provider, model=model, usage_db=gw.usage_recorder,
        request_payload=payload if settings.log_chat_messages else {},
        logs_dir=settings.logs_dir,
        log_chat_messages=settings.log_chat_messages,
        log_file_limit=settings.log_file_limit)
