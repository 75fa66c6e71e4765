"""POST /v1/chat/completions — a thin HTTP shim over the router
(counterpart of the JAX package's ``server/chat.py``). The body is parsed
leniently (utils/json5lite.py: comments and trailing commas). Streaming
responses are committed (200, SSE headers) only after routing has produced
a primed stream, so a failure before the first token still falls back.
"""
from __future__ import annotations

import logging

from aiohttp import web

from ..providers.base import JSONCompletion, StreamingCompletion
from ..utils import json5lite

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

    outcome = await gw.router.dispatch(payload)

    if outcome.error is not None or outcome.result is None:
        err = outcome.error
        detail = str(err) if err else "no providers succeeded"
        status = 429 if err is not None and err.status == 429 else 503
        headers = {}
        if status == 429:
            headers["Retry-After"] = "1"
            message = f"Gateway overloaded. {detail}"
        else:
            message = f"All fallback models failed. Last error: {detail}"
        return web.json_response(
            {"error": {"message": message, "code": status,
                       "attempts": outcome.attempts}},
            status=status, headers=headers)

    result = outcome.result
    if isinstance(result, JSONCompletion):
        return web.json_response(result.data)

    assert isinstance(result, StreamingCompletion)
    resp = web.StreamResponse(status=200, headers={
        "Content-Type": "text/event-stream", "Cache-Control": "no-cache",
        "X-Accel-Buffering": "no", "Connection": "keep-alive"})
    await resp.prepare(request)
    try:
        async for frame in result.frames:
            await resp.write(frame)
        await resp.write_eof()
    except ConnectionResetError:
        # Client hung up mid-stream; closing the generator cancels the
        # engine slot.
        logger.info("client disconnected mid-stream")
        await result.frames.aclose()
    return resp
