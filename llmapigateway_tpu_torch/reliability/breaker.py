"""Per-provider circuit breakers (counterpart of the JAX package's
``reliability/breaker.py``).

A dead upstream must stop costing the chain its full
``retry_count x retry_delay x timeout`` on every request. Each provider
gets a breaker with the classic three states:

* **closed**: requests flow; outcomes are recorded into a sliding window.
  When the window holds at least ``min_requests`` samples and the failure
  rate reaches ``failure_threshold``, the breaker opens.
* **open**: the router skips this provider at once (the chain falls
  through with ~0 added latency). After ``cooldown_s`` the next
  ``allow()`` moves to half-open.
* **half-open**: exactly ONE probe request is let through. Success closes
  the breaker (window reset); failure opens it for another cooldown.

Every provider has a breaker, with the default settings when its entry
has no ``breaker`` block, as in the JAX registry. State transitions are
logged and exported by ``snapshot()`` for ``GET /v1/api/health/providers``.
Everything is event-loop-confined (the router is the only caller), so no
locking; the clock is injectable so tests drive open → half-open → closed
without sleeps.
"""
from __future__ import annotations

import logging
import time
from collections import deque
from typing import TYPE_CHECKING, Any, Callable

from ..config.schemas import BreakerSettings

if TYPE_CHECKING:
    from ..config.loader import ConfigLoader

logger = logging.getLogger(__name__)

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


def counts_as_breaker_failure(error: Any) -> bool:
    """Does a ``CompletionError`` indicate an *unhealthy provider*?

    Network errors and timeouts (no status), 5xx, upstream 429, and engine
    overload all do. Other 4xx mean the provider is alive and rejecting
    this particular request: recording those as failures would let one
    misbehaving client open the breaker for everyone.
    """
    if error is None:
        return False
    if getattr(error, "kind", "") in ("overload", "timeout"):
        return True
    status = getattr(error, "status", None)
    if status is None:
        return True                    # network-level failure
    return status >= 500 or status == 429


class CircuitBreaker:
    """Sliding-window failure-rate breaker for one provider."""

    def __init__(self, name: str, cfg: BreakerSettings,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.cfg = cfg
        self._clock = clock
        self._events: deque[tuple[float, bool]] = deque()   # (t, ok)
        self._state = CLOSED
        self._opened_at = 0.0
        self._probe_inflight = False
        self.opens = 0                 # lifetime open transitions
        self.last_transition: str | None = None

    # -- gate ---------------------------------------------------------------
    def allow(self) -> bool:
        """May a request be sent to this provider right now?

        In half-open state a True return RESERVES the single probe slot;
        the caller must follow up with record_success/record_failure, or
        release_probe when it never sent the probe.
        """
        if not self.cfg.enabled:
            return True
        if self._state == CLOSED:
            return True
        now = self._clock()
        if self._state == OPEN:
            if now - self._opened_at < self.cfg.cooldown_s:
                return False
            self._transition(HALF_OPEN, "cooldown elapsed; probing")
            self._probe_inflight = True
            return True
        # half-open: one probe at a time
        if self._probe_inflight:
            return False
        self._probe_inflight = True
        return True

    def release_probe(self) -> None:
        """Un-reserve a half-open probe that was never sent (the router
        reserved it with allow() but the request's deadline expired
        first). Without this the reservation would leak and the breaker
        would refuse traffic for good."""
        if self._state == HALF_OPEN:
            self._probe_inflight = False

    # -- outcome recording ---------------------------------------------------
    def record_success(self) -> None:
        if self._state == HALF_OPEN:
            self._probe_inflight = False
            self._events.clear()
            self._transition(CLOSED, "half-open probe succeeded")
            return
        self._push(ok=True)

    def record_failure(self) -> None:
        if self._state == HALF_OPEN:
            self._probe_inflight = False
            self._open("half-open probe failed")
            return
        self._push(ok=False)
        if (self._state == CLOSED and self.cfg.enabled
                and self._window_trips()):
            self._open(
                f"failure rate over last {self.cfg.window_s:g}s reached "
                f"{self.failure_rate():.0%}")

    # -- introspection -------------------------------------------------------
    @property
    def state(self) -> str:
        # An open breaker whose cooldown has lapsed is reported as open
        # until the next allow() starts the probe.
        return self._state

    def cooldown_remaining(self) -> float:
        if self._state != OPEN:
            return 0.0
        return max(0.0, self.cfg.cooldown_s
                   - (self._clock() - self._opened_at))

    def failure_rate(self) -> float:
        self._prune()
        if not self._events:
            return 0.0
        bad = sum(1 for _, ok in self._events if not ok)
        return bad / len(self._events)

    def snapshot(self) -> dict[str, Any]:
        self._prune()
        return {
            "state": self._state,
            "state_code": {CLOSED: 0.0, HALF_OPEN: 0.5, OPEN: 1.0}[self._state],
            "failure_rate": round(self.failure_rate(), 3),
            "window_requests": len(self._events),
            "cooldown_remaining_s": round(self.cooldown_remaining(), 2),
            "opens": self.opens,
            "last_transition": self.last_transition,
            "enabled": self.cfg.enabled,
        }

    # -- internals -----------------------------------------------------------
    def _push(self, ok: bool) -> None:
        self._events.append((self._clock(), ok))
        self._prune()

    def _prune(self) -> None:
        horizon = self._clock() - self.cfg.window_s
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()

    def _window_trips(self) -> bool:
        self._prune()
        if len(self._events) < self.cfg.min_requests:
            return False
        return self.failure_rate() >= self.cfg.failure_threshold

    def _open(self, why: str) -> None:
        self._opened_at = self._clock()
        self.opens += 1
        self._transition(OPEN, why)

    def _transition(self, new_state: str, why: str) -> None:
        old, self._state = self._state, new_state
        self.last_transition = f"{old}->{new_state}: {why}"
        logger.warning("breaker[%s] %s -> %s (%s)",
                       self.name, old, new_state, why)


class BreakerRegistry:
    """One breaker per provider name, its settings read from the loaded
    providers.json (a changed ``breaker`` block rebuilds that provider's
    breaker; unchanged providers keep their window)."""

    def __init__(self, loader: "ConfigLoader | None" = None,
                 clock: Callable[[], float] = time.monotonic):
        self._loader = loader
        self._clock = clock
        # name -> (settings fingerprint, breaker); event-loop confined
        self._breakers: dict[str, tuple[str, CircuitBreaker]] = {}

    def _settings_for(self, name: str) -> BreakerSettings:
        if self._loader is not None:
            details = self._loader.providers.get(name)
            if details is not None and details.breaker is not None:
                return details.breaker
        return BreakerSettings()

    def get(self, name: str) -> CircuitBreaker:
        cfg = self._settings_for(name)
        fingerprint = cfg.model_dump_json()
        cached = self._breakers.get(name)
        if cached is not None and cached[0] == fingerprint:
            return cached[1]
        breaker = CircuitBreaker(name, cfg, clock=self._clock)
        self._breakers[name] = (fingerprint, breaker)
        return breaker

    def snapshot(self) -> dict[str, dict[str, Any]]:
        """State of every breaker that has seen traffic (the health
        endpoint adds configured providers without traffic as closed)."""
        return {name: br.snapshot()
                for name, (_, br) in sorted(self._breakers.items())}
