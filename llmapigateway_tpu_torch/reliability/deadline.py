"""Per-request deadline budgets (counterpart of the JAX package's
``reliability/deadline.py``).

One ``Deadline`` is created per chat request (server/chat.py → routing) and
flows through every layer that can wait: the router clamps retry sleeps and
remaining attempts against it, the remote provider caps its aiohttp
timeouts with it, and the local provider bounds its first-token wait and
decode drain with it (cancelling the engine slot on expiry). Exhaustion
maps to HTTP 504 with the partial-attempt log.

The clock is injectable so breaker and deadline tests run without sleeps.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Mapping

# Per-request budgets above this are treated as "no budget": the transport
# default (300 s per read) is already the effective ceiling.
MAX_BUDGET_MS = 3_600_000.0

TIMEOUT_HEADER = "x-request-timeout-ms"
TIMEOUT_BODY_FIELD = "timeout_ms"


class Deadline:
    """A monotonic time budget for one request.

    ``remaining()`` never goes below zero from the caller's point of view:
    use :meth:`expired` for the terminal check and :meth:`clamp` to bound a
    wait (sleep, transport timeout, first-token wait) by what is left.
    """

    __slots__ = ("budget_s", "_t0", "_clock")

    def __init__(self, budget_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.budget_s = float(budget_s)
        self._clock = clock
        self._t0 = clock()

    def elapsed(self) -> float:
        return self._clock() - self._t0

    def remaining(self) -> float:
        return max(0.0, self.budget_s - self.elapsed())

    def expired(self) -> bool:
        return self.elapsed() >= self.budget_s

    def clamp(self, seconds: float) -> float:
        """Bound a wait by the remaining budget (never negative)."""
        return max(0.0, min(float(seconds), self.remaining()))

    def __repr__(self) -> str:
        return (f"Deadline(budget={self.budget_s * 1000:.0f}ms, "
                f"remaining={self.remaining() * 1000:.0f}ms)")


def budget_ms_from_request(headers: Mapping[str, str],
                           payload: dict[str, Any]) -> float | None:
    """The client-requested budget in milliseconds, if any.

    Sources, highest precedence first: the ``x-request-timeout-ms`` header,
    then a ``timeout_ms`` body field. The body field is **popped** from the
    payload so it is never forwarded to an upstream that would reject an
    unknown parameter. Invalid or non-positive values are ignored (None);
    oversized values are treated as "no budget".
    """
    raw: Any = headers.get(TIMEOUT_HEADER)
    if raw is None:
        raw = payload.pop(TIMEOUT_BODY_FIELD, None)
    else:
        payload.pop(TIMEOUT_BODY_FIELD, None)
    if raw is None:
        return None
    try:
        ms = float(raw)
    except (TypeError, ValueError):
        return None
    if ms <= 0 or ms > MAX_BUDGET_MS:
        return None
    return ms
