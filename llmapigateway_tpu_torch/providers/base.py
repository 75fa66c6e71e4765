"""Provider abstraction: one call that returns ``(response, error)`` and
never raises into the fallback loop (counterpart of the JAX package's
``providers/base.py``). Two implementations: the remote OpenAI-compatible
upstream (providers/remote_http.py) and the in-process engine
(providers/local.py). Streaming responses commit to HTTP 200 only after
the provider has produced its first real data frame (remote: SSE priming;
local: the first token), so errors can still trigger fallback.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, AsyncIterator, Protocol

if TYPE_CHECKING:
    from ..obs.slo import SLOTargets
    from ..reliability.deadline import Deadline


@dataclass
class CompletionError:
    """Why a provider call failed; feeds the retry/fallback state machine.

    ``kind`` classifies failures the reliability layer treats specially:
    ``"overload"`` (engine queue full: the router maps an all-overload
    chain to HTTP 429 with ``retry_after_s``) and ``"timeout"`` (the
    attempt hit its deadline-capped transport timeout, which feeds the 504
    path). ``""`` is every other failure.
    """
    detail: str
    status: int | None = None
    retryable: bool = True
    kind: str = ""                     # "" | "overload" | "timeout"
    retry_after_s: float | None = None  # backpressure hint (kind="overload")

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
    params merged, and the headers a remote provider sends. ``deadline`` is
    the request's remaining end-to-end budget: remote providers cap their
    transport timeouts with it, the local provider bounds its first-token
    wait and decode drain and cancels the engine slot on expiry. ``slo``
    holds the request's latency targets, which never abort an attempt: the
    local provider evaluates them at stream end (obs/slo.py)."""
    payload: dict[str, Any]
    stream: bool
    extra_headers: dict[str, str] = field(default_factory=dict)
    deadline: "Deadline | None" = None
    slo: "SLOTargets | None" = None


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
