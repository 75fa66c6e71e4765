"""Remote OpenAI-compatible HTTP provider over aiohttp's client
(counterpart of the JAX package's ``providers/remote_http.py``, which uses
httpx).

**First-frame priming**: when streaming, upstream SSE frames are consumed
until the first real data frame before the gateway commits to a 200
streaming response, so in-band upstream errors (which many vendors send
inside an SSE body with HTTP 200) still trigger fallback. Also:

* One pooled ``aiohttp.ClientSession`` per provider (keep-alive), made on
  first use inside the event loop and closed by :meth:`close`.
* SSE frames are parsed exactly once (:class:`~..utils.sse.SSEParser`);
  usage and content capture go through the :class:`UsageObserver` the
  router passes in.
* Mid-stream error frames end the stream in-band and are reported to the
  observer; usage frames are captured from the same parse.
"""
from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, AsyncIterator

import aiohttp

from ..reliability.deadline import Deadline
from ..utils.sse import (SSE_DONE, SSEFrame, SSEParser, format_sse,
                         frame_error_detail)
from .base import (
    CompletionError,
    CompletionRequest,
    CompletionResult,
    JSONCompletion,
    Provider,
    StreamingCompletion,
    UsageObserver,
)

logger = logging.getLogger(__name__)

# The reference's limits: 300 s per read, 60 s to connect. ``sock_read``
# bounds each read of the headers or the body, so a stream that stalls
# mid-way times out too; there is no cap on a healthy stream's total time.
READ_TIMEOUT_S = 300.0
CONNECT_TIMEOUT_S = 60.0
MODELS_TIMEOUT = aiohttp.ClientTimeout(total=None, sock_connect=10.0,
                                       sock_read=60.0)


def deadline_timeout(deadline: Deadline | None) -> aiohttp.ClientTimeout:
    """The per-attempt timeout, capped by the request's remaining deadline
    budget: an attempt never outlives the end-to-end budget the client
    asked for, and a read that stalls past it (headers or mid-stream)
    raises a timeout. With no deadline the 300 s / 60 s caps apply. An
    already-expired deadline gets a tiny positive timeout, so the
    transport raises its normal timeout (classified ``kind="timeout"``)."""
    read, connect = READ_TIMEOUT_S, CONNECT_TIMEOUT_S
    if deadline is not None:
        remaining = max(0.001, deadline.remaining())
        read, connect = min(read, remaining), min(connect, remaining)
    return aiohttp.ClientTimeout(total=None, sock_connect=connect,
                                 sock_read=read)


def _extract_content_delta(obj: dict[str, Any]) -> str:
    """The assistant text delta of a chat.completion(.chunk) frame
    (``delta.content`` or ``message.content``)."""
    try:
        choices = obj.get("choices")
        if not choices:
            return ""
        ch = choices[0]
        delta = ch.get("delta") or {}
        msg = ch.get("message") or {}
        return delta.get("content") or msg.get("content") or ""
    except (AttributeError, IndexError, TypeError):
        return ""


class RemoteHTTPProvider(Provider):
    type = "remote_http"

    def __init__(self, name: str, base_url: str, api_key: str | None = None):
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self._session: aiohttp.ClientSession | None = None

    def _client(self) -> aiohttp.ClientSession:
        # Made on first use: a session belongs to the running event loop,
        # and the registry builds providers in a worker thread.
        if self._session is None:
            self._session = aiohttp.ClientSession()
        return self._session

    def _headers(self, extra: dict[str, str]) -> dict[str, str]:
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        headers.update(extra)
        return headers

    async def complete(self, request: CompletionRequest,
                       observer: UsageObserver) -> CompletionResult:
        url = f"{self.base_url}/chat/completions"
        headers = self._headers(request.extra_headers)
        timeout = deadline_timeout(request.deadline)
        try:
            if request.stream:
                return await self._complete_streaming(
                    url, headers, request.payload, observer, timeout)
            return await self._complete_json(
                url, headers, request.payload, observer, timeout)
        except asyncio.TimeoutError as e:
            # Deadline-capped attempts land here; the router's budget check
            # decides whether this ends the whole request (504).
            return None, CompletionError(
                f"timeout contacting {self.name}: {type(e).__name__}",
                kind="timeout")
        except aiohttp.ClientError as e:
            return None, CompletionError(
                f"network error contacting {self.name}: {e}")
        except Exception as e:        # contract: never raise into the fallback loop
            logger.exception("unexpected provider failure (%s)", self.name)
            return None, CompletionError(f"provider {self.name} failed: {e}")

    # -- non-streaming -------------------------------------------------------
    async def _complete_json(self, url: str, headers: dict[str, str],
                             payload: dict[str, Any],
                             observer: UsageObserver,
                             timeout: aiohttp.ClientTimeout
                             ) -> CompletionResult:
        async with self._client().post(url, json=payload, headers=headers,
                                       timeout=timeout) as resp:
            text = await resp.text(errors="replace")
            status = resp.status
        if status >= 400:
            return None, CompletionError(text[:2000], status=status)
        try:
            data = json.loads(text)
        except ValueError:
            return None, CompletionError(
                f"non-JSON response from {self.name}: {text[:500]}")
        # In-band error with HTTP 200.
        detail = frame_error_detail(data)
        if detail is not None:
            return None, CompletionError(detail, status=status)
        observer.on_first_token()
        observer.on_content_delta(_extract_content_delta(data))
        if isinstance(data.get("usage"), dict):
            observer.on_usage(data["usage"])
        observer.on_stream_end()
        return JSONCompletion(data=data, provider=self.name,
                              model=str(payload.get("model", ""))), None

    # -- streaming -----------------------------------------------------------
    async def _complete_streaming(self, url: str, headers: dict[str, str],
                                  payload: dict[str, Any],
                                  observer: UsageObserver,
                                  timeout: aiohttp.ClientTimeout
                                  ) -> CompletionResult:
        resp = await self._client().post(url, json=payload, headers=headers,
                                         timeout=timeout)
        if resp.status >= 400:
            try:
                body = await resp.read()
            finally:
                resp.release()
            return None, CompletionError(
                body.decode("utf-8", "replace")[:2000], status=resp.status)

        # Priming: pull frames until the first real data frame so the chain
        # can still fall back on an in-band error. The frames after it in
        # the same chunk go to the relay, which treats them as it treats
        # every later frame (a mid-stream error there is surfaced in-band).
        parser = SSEParser()
        byte_iter = resp.content.iter_any()
        first: SSEFrame | None = None
        pending: list[SSEFrame] = []
        try:
            async for chunk in byte_iter:
                frames = list(parser.feed(chunk))
                for i, frame in enumerate(frames):
                    if frame.is_done:
                        # Stream ended before any content: an error.
                        resp.release()
                        return None, CompletionError(
                            f"{self.name} stream ended with no data")
                    obj = frame.json
                    if obj is None:
                        continue           # comment/keep-alive frame: drop
                    detail = frame_error_detail(obj)
                    if detail is not None:
                        resp.release()
                        return None, CompletionError(detail)
                    first, pending = frame, frames[i + 1:]
                    break
                if first is not None:
                    break
            if first is None:
                resp.release()
                return None, CompletionError(
                    f"{self.name} closed the stream before any data frame")
        except asyncio.TimeoutError as e:
            resp.release()
            return None, CompletionError(
                f"timeout during {self.name} stream priming: "
                f"{type(e).__name__}", kind="timeout")
        except aiohttp.ClientError as e:
            resp.release()
            return None, CompletionError(f"stream setup failed: {e}")

        observer.on_first_token()
        frames = self._relay(resp, byte_iter, parser, [first] + pending,
                             observer)
        return StreamingCompletion(frames=frames, provider=self.name,
                                   model=str(payload.get("model", ""))), None

    async def _relay(self, resp: aiohttp.ClientResponse,
                     byte_iter: AsyncIterator[bytes], parser: SSEParser,
                     frames: list[SSEFrame],
                     observer: UsageObserver) -> AsyncIterator[bytes]:
        """Yield the primed frames, then the rest of the stream, watching
        for mid-stream errors and usage."""
        error: str | None = None
        try:
            while True:
                for frame in frames:
                    if frame.is_done:
                        yield format_sse(SSE_DONE)
                        continue
                    obj = frame.json
                    if obj is not None:
                        detail = frame_error_detail(obj)
                        if detail is not None:
                            # Too late to fall back: surface in-band, stop.
                            error = detail
                            yield format_sse({"error": {"message": detail,
                                                        "provider": self.name}})
                            return
                        text = _extract_content_delta(obj)
                        if text:
                            observer.on_content_delta(text)
                        if isinstance(obj.get("usage"), dict):
                            observer.on_usage(obj["usage"])
                    yield format_sse(frame.data)
                chunk = await anext(byte_iter, None)
                if chunk is None:
                    break
                frames = list(parser.feed(chunk))
            for frame in parser.flush():
                if not frame.is_done:
                    yield format_sse(frame.data)
        except (aiohttp.ClientError, asyncio.TimeoutError) as e:
            # A dropped connection or a read stalled past its timeout.
            error = f"upstream stream error: {type(e).__name__}: {e}"
            yield format_sse({"error": {"message": error,
                                        "provider": self.name}})
        finally:
            observer.on_stream_end(error)
            resp.release()

    # -- models --------------------------------------------------------------
    async def list_models(self) -> list[dict[str, Any]] | None:
        """GET {base}/models; None when the upstream cannot list."""
        try:
            async with self._client().get(
                    f"{self.base_url}/models", headers=self._headers({}),
                    timeout=MODELS_TIMEOUT) as resp:
                if resp.status >= 400:
                    return None
                data = json.loads(await resp.text(errors="replace"))
            models = data.get("data") if isinstance(data, dict) else data
            return models if isinstance(models, list) else None
        except (aiohttp.ClientError, asyncio.TimeoutError, ValueError):
            return None

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None
