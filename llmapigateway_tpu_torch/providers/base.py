"""Provider abstraction: one call that returns ``(response, error)`` and
never raises into the fallback loop (counterpart of the JAX package's
``providers/base.py``). Streaming responses commit to HTTP 200 only after
the provider has produced its first real data frame, so errors can still
trigger fallback.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, AsyncIterator, Protocol


@dataclass
class CompletionError:
    """Why a provider call failed; feeds the fallback loop. ``kind``
    ``"overload"`` marks backpressure (engine queue full), which the router
    maps to HTTP 429 when every target failed that way."""
    detail: str
    status: int | None = None
    retryable: bool = True
    kind: str = ""                     # "" | "overload"

    def __str__(self) -> str:
        return f"[{self.status}] {self.detail}" if self.status else self.detail


class UsageObserver(Protocol):
    """Usage capture hooks the provider calls as it produces its stream."""

    def on_first_token(self) -> None: ...
    def on_content_delta(self, text: str) -> None: ...
    def on_usage(self, usage: dict[str, Any]) -> None: ...
    def on_stream_end(self, error: str | None = None) -> None: ...


@dataclass
class NullUsageObserver:
    def on_first_token(self) -> None: pass
    def on_content_delta(self, text: str) -> None: pass
    def on_usage(self, usage: dict[str, Any]) -> None: pass
    def on_stream_end(self, error: str | None = None) -> None: pass


@dataclass
class StreamingCompletion:
    """A committed streaming response: complete SSE-encoded byte frames
    (``data: ...\\n\\n``) ready to forward."""
    frames: AsyncIterator[bytes]
    provider: str = ""
    model: str = ""


@dataclass
class JSONCompletion:
    """A successful non-streaming response body (OpenAI chat.completion)."""
    data: dict[str, Any]
    provider: str = ""
    model: str = ""


CompletionResult = tuple[
    "StreamingCompletion | JSONCompletion | None", "CompletionError | None"]


@dataclass
class CompletionRequest:
    """Everything a provider needs for one attempt, post-routing: payload
    already rewritten to the provider-real model name with custom body
    params merged. (Per-rule ``custom_headers`` come with the remote
    providers, the only ones that send headers.)"""
    payload: dict[str, Any]
    stream: bool


class Provider(abc.ABC):
    """A completion backend. Implementations must never raise from
    :meth:`complete`; all failures become ``(None, CompletionError)``."""

    name: str = ""
    type: str = ""

    @abc.abstractmethod
    async def complete(self, request: CompletionRequest,
                       observer: UsageObserver) -> CompletionResult:
        ...

    async def list_models(self) -> list[dict[str, Any]] | None:
        """Optional: the provider's /models inventory (None = unsupported)."""
        return None

    async def close(self) -> None:
        pass
