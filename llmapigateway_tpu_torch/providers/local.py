"""`local` provider: the in-process PyTorch engine behind the standard
provider contract (counterpart of the JAX package's ``providers/local.py``,
without its tracing, metrics and deadline hooks, which come with the
observability and reliability layers).

Streaming commits only after the first token exists (prefill admission +
first sample), so an engine failure before it can still fall back.
"""
from __future__ import annotations

import asyncio
import time
import uuid
from typing import Any, AsyncIterator

import torch

from ..config.schemas import ProviderDetails
from ..engine.engine import (EngineOverloaded, EngineUnavailable, GenRequest,
                             InferenceEngine)
from ..utils.sse import SSE_DONE, format_sse
from .base import (
    CompletionError,
    CompletionRequest,
    CompletionResult,
    JSONCompletion,
    Provider,
    StreamingCompletion,
    UsageObserver,
)


class LocalProvider(Provider):
    type = "local"

    def __init__(self, name: str, engine: InferenceEngine):
        self.name = name
        self.engine = engine

    # -- request translation ---------------------------------------------------
    def _build_genrequest(self, payload: dict[str, Any]) -> GenRequest:
        tok = self.engine.tokenizer
        messages = payload.get("messages") or []
        if not isinstance(messages, list):
            raise ValueError("'messages' must be a list")
        prompt_text = tok.apply_chat_template(messages,
                                              add_generation_prompt=True)
        prompt_ids = tok.encode(prompt_text)
        if tok.bos_id is not None and (not prompt_ids or
                                       prompt_ids[0] != tok.bos_id):
            prompt_ids = [tok.bos_id] + prompt_ids

        stop = payload.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        max_tokens = int(payload.get("max_completion_tokens")
                         or payload.get("max_tokens")
                         or self.engine.cfg.max_tokens_default)
        # OpenAI default: temperature=1 (sampled) when omitted; an explicit
        # 0 still means greedy.
        raw_temp = payload.get("temperature")
        temperature = 1.0 if raw_temp is None else float(raw_temp)
        top_p = float(payload.get("top_p", 1.0) or 1.0)
        top_k = int(payload.get("top_k", 0) or 0)
        presence = float(payload.get("presence_penalty") or 0.0)
        frequency = float(payload.get("frequency_penalty") or 0.0)
        return GenRequest(prompt_ids=prompt_ids, max_tokens=max_tokens,
                          temperature=temperature, top_p=top_p, top_k=top_k,
                          presence_penalty=presence,
                          frequency_penalty=frequency,
                          stop=[s for s in stop if s])

    def _usage(self, req: GenRequest) -> dict[str, Any]:
        n_gen = len(req.generated)
        usage: dict[str, Any] = {
            "prompt_tokens": len(req.prompt_ids),
            "completion_tokens": n_gen,
            "total_tokens": len(req.prompt_ids) + n_gen}
        if req.t_first_token is not None:
            usage["ttft_ms"] = round(
                (req.t_first_token - req.t_submit) * 1000.0, 2)
            if req.t_done and n_gen > 1 and req.t_done > req.t_first_token:
                usage["tokens_per_sec"] = round(
                    (n_gen - 1) / (req.t_done - req.t_first_token), 2)
        return usage

    # -- the provider contract -------------------------------------------------
    async def complete(self, request: CompletionRequest,
                       observer: UsageObserver) -> CompletionResult:
        payload = request.payload
        model_name = str(payload.get("model", self.name))
        try:
            req = self._build_genrequest(payload)
        except (ValueError, TypeError) as e:
            return None, CompletionError(
                f"invalid request for local engine: {e}", retryable=False)
        try:
            await self.engine.submit(req)
        except EngineOverloaded as e:
            # Overload is a failable provider condition: the router falls
            # back to the next target.
            return None, CompletionError(str(e), status=503, kind="overload")
        except EngineUnavailable as e:
            return None, CompletionError(str(e), status=503)

        # Wait for the first delta before committing: if the engine fails
        # before producing a token, the router can still fall back.
        stream_iter = self.engine.stream(req)
        try:
            first_delta = await anext(stream_iter)
        except StopAsyncIteration:
            return None, CompletionError("engine produced no output")
        if first_delta.error is not None:
            return None, CompletionError(first_delta.error)
        observer.on_first_token()

        if request.stream:
            frames = self._sse_frames(req, stream_iter, first_delta,
                                      model_name, observer)
            return StreamingCompletion(frames=frames, provider=self.name,
                                       model=model_name), None

        # Non-streaming: drain (the handler task's cancellation — a client
        # gone mid-generation — cancels the engine work).
        text_parts = [first_delta.text]
        finish = first_delta.finish_reason
        error = first_delta.error
        try:
            if finish is None:
                async for delta in stream_iter:
                    text_parts.append(delta.text)
                    finish = delta.finish_reason
                    error = delta.error
        except asyncio.CancelledError:
            req.cancelled = True
            raise
        if error is not None:
            observer.on_stream_end(error)
            return None, CompletionError(error)
        text = "".join(text_parts)
        usage = self._usage(req)
        observer.on_content_delta(text)
        observer.on_usage(usage)
        observer.on_stream_end()
        body = {
            "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": model_name,
            "choices": [{"index": 0,
                         "message": {"role": "assistant", "content": text},
                         "finish_reason": finish or "stop"}],
            "usage": usage,
        }
        return JSONCompletion(data=body, provider=self.name,
                              model=model_name), None

    async def _sse_frames(self, req: GenRequest, stream_iter: AsyncIterator,
                          first_delta, model_name: str,
                          observer: UsageObserver) -> AsyncIterator[bytes]:
        cid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())

        def chunk(delta_content: str | None, finish: str | None = None,
                  role: str | None = None,
                  usage: dict | None = None) -> bytes:
            delta: dict[str, Any] = {}
            if role:
                delta["role"] = role
            if delta_content:
                delta["content"] = delta_content
            body: dict[str, Any] = {
                "id": cid, "object": "chat.completion.chunk",
                "created": created, "model": model_name,
                "choices": [{"index": 0, "delta": delta,
                             "finish_reason": finish}]}
            if usage is not None:
                body["usage"] = usage
            return format_sse(body)

        error: str | None = None
        try:
            yield chunk(None, role="assistant")
            if first_delta.text:
                observer.on_content_delta(first_delta.text)
                yield chunk(first_delta.text)
            finish = first_delta.finish_reason
            if finish is None:
                async for delta in stream_iter:
                    if delta.error is not None:
                        error = delta.error
                        yield format_sse({"error": {"message": error,
                                                    "provider": self.name}})
                        return
                    if delta.text:
                        observer.on_content_delta(delta.text)
                        yield chunk(delta.text)
                    if delta.finish_reason is not None:
                        finish = delta.finish_reason
            usage = self._usage(req)
            observer.on_usage(usage)
            yield chunk(None, finish=finish or "stop", usage=usage)
            yield format_sse(SSE_DONE)
        finally:
            if req.finish_reason is None:
                # Client hung up mid-stream (generator closed early): tell
                # the engine to stop decoding and free the slot.
                req.cancelled = True
            observer.on_stream_end(error)

    async def list_models(self) -> list[dict[str, Any]] | None:
        return [{"id": self.name, "object": "model", "owned_by": "local_gpu",
                 "context_length": self.engine.S}]

    async def close(self) -> None:
        await self.engine.stop()


def make_local_provider(name: str, details: ProviderDetails,
                        device: str | torch.device = "cuda") -> LocalProvider:
    """Factory installed into the ProviderRegistry (server/app.py)."""
    if details.engine is None:
        raise ValueError(f"provider {name!r}: local provider requires 'engine'")
    return LocalProvider(name, InferenceEngine(details.engine, device=device))
