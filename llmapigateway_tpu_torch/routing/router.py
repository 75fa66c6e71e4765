"""Routing: rule resolution, rotation, and the retry/fallback state machine
(counterpart of the JAX package's ``routing/router.py``).

* Rule lookup by gateway model name; unknown models become a synthetic
  single-target chain on the configured fallback provider with the model
  name passed through.
* Rotation: a persisted per-(client key, gateway model) round-robin start
  index (db/rotation.py) reorders the chain circularly; DB errors degrade
  to index 0, and the SQLite call runs off the event loop.
* Per target: ``retry_count`` extra attempts, sleeping ``retry_delay``
  seconds when ``0 < delay < 120``, the sleep clamped by the request's
  deadline; with ``use_provider_order_as_fallback`` each attempt tries the
  listed OpenRouter upstreams one at a time, each pinned.
* Every attempt gets a fresh deep-copied payload: the model rewritten to
  the provider-real name, OpenRouter's ``usage: {include: true}`` and
  ``provider.order``, the rule's ``custom_body_params``; headers
  ``HTTP-Referer``/``X-Title`` and the rule's ``custom_headers``.
* Reliability: a per-request deadline (client header or body > rule
  ``timeout_ms`` > gateway default), a circuit breaker per provider whose
  open state skips the target at once, and a fast exit from a target on a
  non-retryable failure or when its breaker has just opened.
* Terminal status: 504 when the deadline ran out, 429 when every failure
  was backpressure (engine overload or an open breaker; ``retry_after_s``
  the largest hint), 503 otherwise.

The JAX router's trace spans and metrics come with the observability
layer (ROADMAP.md, port queue item 14).
"""
from __future__ import annotations

import asyncio
import copy
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from ..config.loader import ConfigLoader, resolve_api_key
from ..config.schemas import FallbackModelRule, ModelFallbackConfig, ProviderDetails
from ..db.rotation import RotationDB
from ..obs.slo import SLOTargets, resolve_slo
from ..providers.base import (
    CompletionError,
    CompletionRequest,
    JSONCompletion,
    Provider,
    StreamingCompletion,
    UsageObserver,
)
from ..providers.remote_http import RemoteHTTPProvider
from ..reliability.breaker import BreakerRegistry, counts_as_breaker_failure
from ..reliability.deadline import Deadline

logger = logging.getLogger(__name__)

MAX_RETRY_DELAY_S = 120.0

# Sent upstream on every attempt (OpenRouter's app attribution); a rule's
# custom_headers override them.
REFERER = "https://llmapigateway-tpu.local"
TITLE = "LLM API Gateway (TPU)"


class ProviderRegistry:
    """Builds and caches the providers from the live config, each until its
    config entry changes. ``local`` providers are built through a pluggable
    factory (which fixes their device). A build runs in a worker thread
    outside the registry lock, so the event loop keeps serving, and other
    providers answer, while an engine loads; a per-name lock stops two
    requests building the same provider. A provider whose entry changed is
    retired: closed ``RETIRE_AFTER_S`` later, when no request it started
    can still be running."""

    # Outlives the longest request an old provider can still be serving
    # (the 300 s transport cap).
    RETIRE_AFTER_S = 330.0

    def __init__(self, loader: ConfigLoader,
                 local_factory: Callable[[str, ProviderDetails], Provider] | None = None):
        self._loader = loader
        self._local_factory = local_factory
        # name -> (fingerprint of its config entry, provider)
        self._cache: dict[str, tuple[str, Provider]] = {}   # guarded-by: _lock
        self._lock = asyncio.Lock()
        self._name_locks: dict[str, asyncio.Lock] = {}      # guarded-by: _lock
        self._retiring: set[asyncio.Task] = set()           # guarded-by: loop
        self._closed = False

    async def get(self, name: str) -> Provider | None:
        details = self._loader.providers.get(name)
        if details is None:
            return None
        fingerprint = details.model_dump_json()
        async with self._lock:
            cached = self._cache.get(name)
            if cached and cached[0] == fingerprint:
                return cached[1]
            name_lock = self._name_locks.setdefault(name, asyncio.Lock())
        async with name_lock:
            async with self._lock:
                cached = self._cache.get(name)
                if cached and cached[0] == fingerprint:
                    return cached[1]
                if cached:
                    # The entry changed: requests in flight may still use
                    # the old provider; close it once they cannot.
                    self._retire(cached[1])
                    del self._cache[name]
            try:
                provider = await asyncio.to_thread(self._build, name, details)
            except (ValueError, RuntimeError, OSError):
                # A refused knob, a missing device or package, a missing or
                # truncated checkpoint, the card out of memory: the target is
                # unavailable and the chain moves on; the log says why.
                logger.exception("provider %s failed to build", name)
                return None
            if provider is not None:
                async with self._lock:
                    if self._closed:
                        # Closed while this build ran: do not keep a live
                        # provider in a dead cache.
                        await provider.close()
                        return None
                    self._cache[name] = (fingerprint, provider)
            return provider

    def instantiated(self) -> list[tuple[str, Provider]]:
        """The providers built so far (building none)."""
        return [(name, prov) for name, (_, prov) in self._cache.items()]

    def local_providers(self) -> list[Provider]:
        """The built providers backed by an in-process engine."""
        return [prov for _, prov in self.instantiated()
                if getattr(prov, "engine", None) is not None]

    def _retire(self, provider: Provider) -> None:
        async def _close_later() -> None:
            try:
                await asyncio.sleep(self.RETIRE_AFTER_S)
                await provider.close()
            except asyncio.CancelledError:
                await provider.close()
                raise
        task = asyncio.get_running_loop().create_task(_close_later())
        self._retiring.add(task)
        task.add_done_callback(self._retiring.discard)

    def _build(self, name: str, details: ProviderDetails) -> Provider | None:
        if details.type == "local":
            if self._local_factory is None:
                logger.error("provider %s is type=local but no engine "
                             "factory is installed", name)
                return None
            return self._local_factory(name, details)
        return RemoteHTTPProvider(name=name, base_url=details.baseUrl or "",
                                  api_key=resolve_api_key(details))

    async def close(self) -> None:
        async with self._lock:
            self._closed = True
            for task in list(self._retiring):
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
            for _, provider in self._cache.values():
                await provider.close()
            self._cache.clear()


@dataclass
class RouteOutcome:
    """Terminal result of routing one request through the fallback chain."""
    result: StreamingCompletion | JSONCompletion | None
    error: CompletionError | None
    attempts: int = 0
    provider: str = ""
    model: str = ""
    errors: list[str] = field(default_factory=list)


class Router:
    def __init__(self, loader: ConfigLoader, registry: ProviderRegistry,
                 rotation_db: RotationDB, fallback_provider: str = "openrouter",
                 sleep: Callable[[float], Any] | None = None,
                 breakers: BreakerRegistry | None = None,
                 default_timeout_ms: float = 0.0,
                 clock: Callable[[], float] | None = None):
        self._loader = loader
        self._registry = registry
        self._rotation = rotation_db
        self._fallback_provider = fallback_provider
        self._sleep = sleep or asyncio.sleep     # injectable for tests
        self._breakers = breakers
        self._default_timeout_ms = default_timeout_ms
        self._clock = clock or time.monotonic    # injectable for tests

    # -- rule resolution -----------------------------------------------------
    def resolve_rule(self, gateway_model: str) -> ModelFallbackConfig:
        rule = self._loader.rules.get(gateway_model)
        if rule is not None:
            return rule
        # Unknown model → passthrough to the fallback provider.
        return ModelFallbackConfig(
            gateway_model_name=gateway_model,
            fallback_models=[FallbackModelRule(
                provider=self._fallback_provider, model=gateway_model)])

    async def _ordered_targets(self, rule: ModelFallbackConfig,
                               client_key: str) -> list[FallbackModelRule]:
        targets = list(rule.fallback_models)
        if rule.rotate_models and len(targets) > 1:
            start = await self._rotation.next_index_async(
                client_key, rule.gateway_model_name, len(targets))
            targets = targets[start:] + targets[:start]
        return targets

    # -- payload/header construction ------------------------------------------
    @staticmethod
    def _build_attempt(payload: dict[str, Any], target: FallbackModelRule,
                       provider_name: str,
                       pinned_order: list[str] | None,
                       deadline: Deadline | None = None,
                       request_id: str = "",
                       slo: SLOTargets | None = None) -> CompletionRequest:
        attempt = copy.deepcopy(payload)
        attempt["model"] = target.model
        if provider_name.lower() == "openrouter":
            # Ask OpenRouter to report usage and cost.
            attempt.setdefault("usage", {"include": True})
            order = pinned_order if pinned_order is not None else target.providers_order
            if order:
                attempt["provider"] = {"order": list(order),
                                       "allow_fallbacks": False}
        if target.custom_body_params:
            attempt.update(copy.deepcopy(target.custom_body_params))
        headers = {"HTTP-Referer": REFERER, "X-Title": TITLE}
        if request_id:
            # One id correlates gateway and upstream logs.
            headers["x-request-id"] = request_id
        if target.custom_headers:
            headers.update(target.custom_headers)
        stream = bool(attempt.get("stream", False))
        return CompletionRequest(payload=attempt, stream=stream,
                                 extra_headers=headers, deadline=deadline,
                                 slo=slo)

    # -- the state machine -----------------------------------------------------
    def _start_deadline(self, rule: ModelFallbackConfig,
                        timeout_ms: float | None) -> Deadline | None:
        """The request's time budget: the client's ask (header or body,
        parsed by the HTTP layer) > the rule's ``timeout_ms`` > the
        gateway-wide default; 0/None at every level = unbounded."""
        budget_ms = timeout_ms or rule.timeout_ms or self._default_timeout_ms
        if not budget_ms or budget_ms <= 0:
            return None
        return Deadline(budget_ms / 1000.0, clock=self._clock)

    async def dispatch(self, payload: dict[str, Any], client_key: str,
                       observer_factory: Callable[[str, str], UsageObserver],
                       timeout_ms: float | None = None,
                       request_id: str = "",
                       slo: SLOTargets | None = None) -> RouteOutcome:
        """Route one chat-completions payload through the fallback chain.

        ``observer_factory(provider, model)`` builds a fresh usage observer
        per attempt; only the successful attempt's observer sees a complete
        stream, so usage is recorded once. ``timeout_ms`` is the client's
        explicit budget, if any. ``request_id`` is sent upstream. ``slo``
        is the client's SLO ask; the rule's ``slo_ttft_ms`` /
        ``slo_tpot_ms`` fill unset fields.
        """
        gateway_model = str(payload.get("model", ""))
        rule = self.resolve_rule(gateway_model)
        targets = await self._ordered_targets(rule, client_key)
        deadline = self._start_deadline(rule, timeout_ms)
        slo = resolve_slo(slo, rule)

        outcome = RouteOutcome(result=None, error=None)
        n_overload = 0
        n_other = 0
        deadline_hit = False
        retry_hints: list[float] = []

        for target in targets:
            if deadline is not None and deadline.expired():
                deadline_hit = True
                break
            provider = await self._registry.get(target.provider)
            if provider is None:
                outcome.errors.append(
                    f"provider {target.provider!r} unavailable")
                n_other += 1
                continue

            breaker = (self._breakers.get(target.provider)
                       if self._breakers is not None else None)
            if breaker is not None and not breaker.allow():
                # Open breaker: fall through at once, no payload build, no
                # network, no retry sleeps for a known-dead upstream.
                cooldown = breaker.cooldown_remaining()
                outcome.errors.append(
                    f"{target.provider}/{target.model}: circuit open "
                    f"(retry in {cooldown:.1f}s)")
                retry_hints.append(cooldown)
                n_overload += 1
                continue

            # Sub-provider fallback: OpenRouter's upstreams one at a time,
            # each pinned; otherwise one attempt series with the whole
            # order pinned.
            if target.use_provider_order_as_fallback and target.providers_order:
                sub_orders: list[list[str] | None] = [
                    [sub] for sub in target.providers_order]
            else:
                sub_orders = [None]

            retries = max(0, int(target.retry_count))
            target_done = False          # non-retryable / deadline fast exit
            target_attempted = False     # any attempt actually sent?
            for attempt_idx in range(retries + 1):
                for sub_order in sub_orders:
                    if deadline is not None and deadline.expired():
                        deadline_hit = True
                        target_done = True
                        if breaker is not None and not target_attempted:
                            # allow() may have reserved the half-open
                            # probe; it was never sent: release it.
                            breaker.release_probe()
                        break
                    request = self._build_attempt(
                        payload, target, target.provider, sub_order, deadline,
                        request_id=request_id, slo=slo)
                    observer = observer_factory(target.provider, target.model)
                    outcome.attempts += 1
                    target_attempted = True
                    result, error = await provider.complete(request, observer)
                    if error is None and result is not None:
                        if breaker is not None:
                            breaker.record_success()
                        outcome.result = result
                        outcome.provider = target.provider
                        outcome.model = target.model
                        return outcome
                    breaker_opened = False
                    if breaker is not None:
                        if counts_as_breaker_failure(error):
                            breaker.record_failure()
                            # The window has judged this target dead: its
                            # remaining retries and sleeps would be waste.
                            breaker_opened = breaker.state == "open"
                        else:
                            # Alive but rejecting (plain 4xx).
                            breaker.record_success()
                    if error is not None and error.kind == "overload":
                        n_overload += 1
                        if error.retry_after_s is not None:
                            retry_hints.append(error.retry_after_s)
                    else:
                        n_other += 1
                    detail = str(error) if error else "empty response"
                    sub = f" (upstream={sub_order[0]})" if sub_order else ""
                    outcome.errors.append(
                        f"{target.provider}/{target.model}{sub}: {detail}")
                    logger.warning("attempt failed: %s", outcome.errors[-1])
                    if breaker_opened or (error is not None
                                          and not error.retryable):
                        target_done = True
                        break
                if target_done:
                    break
                if attempt_idx < retries and 0 < target.retry_delay < MAX_RETRY_DELAY_S:
                    # A retry_delay never outlives the request's deadline.
                    delay = (deadline.clamp(target.retry_delay)
                             if deadline is not None else target.retry_delay)
                    if delay > 0:
                        await self._sleep(delay)
            if deadline_hit:
                break

        if deadline is not None and (deadline_hit or deadline.expired()):
            budget_ms = deadline.budget_s * 1000.0
            outcome.error = CompletionError(
                detail=(f"deadline of {budget_ms:.0f} ms exhausted after "
                        f"{outcome.attempts} attempt(s): "
                        + ("; ".join(outcome.errors[-5:]) or "no attempts made")),
                status=504, retryable=False, kind="timeout")
        elif n_overload > 0 and n_other == 0 and outcome.errors:
            outcome.error = CompletionError(
                detail="all providers overloaded or shedding: "
                       + "; ".join(outcome.errors[-5:]),
                status=429, retryable=True, kind="overload",
                retry_after_s=max(retry_hints, default=1.0))
        else:
            outcome.error = CompletionError(
                detail="; ".join(outcome.errors[-5:]) or
                       f"no providers available for {gateway_model!r}",
                status=503, retryable=False)
        return outcome
