"""Routing: rule → provider chain, tried in order (counterpart of the JAX
package's ``routing/router.py``).

* Rule lookup by gateway model name; unknown models become a synthetic
  single-target chain on the configured fallback provider with the model
  name passed through.
* Per target: ``retry_count`` extra attempts, sleeping ``retry_delay``
  seconds when ``0 < delay < 120``; every attempt gets a fresh deep-copied
  payload with the model rewritten to the provider-real name and the
  rule's ``custom_body_params`` merged.
* All targets exhausted → a terminal error the server maps to HTTP 503
  (429 when every failure was engine overload).

Providers are the port's local engines. Rotation, circuit breakers,
deadlines, SLO targets, the usage DB and remote HTTP providers are not
ported yet: a ``remote_http`` target is reported unavailable and the chain
moves on, and a rule that would use one of the others on a local target
(``rotate_models`` over several targets, ``timeout_ms``, ``slo_*``,
``use_provider_order_as_fallback``) is refused at config load
(config/loader.py ``refuse_unported``). ``providers_order`` and
``custom_headers`` are inert for a local target, in the JAX router too.
"""
from __future__ import annotations

import asyncio
import copy
import logging
from dataclasses import dataclass, field
from typing import Any, Callable

from ..config.loader import ConfigLoader
from ..config.schemas import FallbackModelRule, ModelFallbackConfig, ProviderDetails
from ..providers.base import (
    CompletionError,
    CompletionRequest,
    JSONCompletion,
    NullUsageObserver,
    Provider,
    StreamingCompletion,
)

logger = logging.getLogger(__name__)

MAX_RETRY_DELAY_S = 120.0


class ProviderRegistry:
    """Builds and caches the port's providers from the config. ``local``
    providers are built through a pluggable factory (which fixes their
    device); a build runs in a worker thread so the event loop keeps
    serving while an engine initializes."""

    def __init__(self, loader: ConfigLoader,
                 local_factory: Callable[[str, ProviderDetails], Provider] | None = None):
        self._loader = loader
        self._local_factory = local_factory
        self._cache: dict[str, Provider] = {}
        self._lock = asyncio.Lock()

    async def get(self, name: str) -> Provider | None:
        details = self._loader.providers.get(name)
        if details is None:
            return None
        async with self._lock:
            provider = self._cache.get(name)
            if provider is None:
                try:
                    provider = await asyncio.to_thread(self._build, name,
                                                       details)
                except (ValueError, RuntimeError):
                    # A refused knob or a missing device: the target is
                    # unavailable and the chain moves on; the log says why.
                    logger.exception("provider %s failed to build", name)
                    return None
                if provider is not None:
                    self._cache[name] = provider
            return provider

    def _build(self, name: str, details: ProviderDetails) -> Provider | None:
        if details.type != "local":
            logger.error("provider %s: type %r is not ported to the PyTorch "
                         "gateway yet (ROADMAP.md, port queue: remote "
                         "providers)", name, details.type)
            return None
        if self._local_factory is None:
            logger.error("provider %s is type=local but no engine factory "
                         "is installed", name)
            return None
        return self._local_factory(name, details)

    async def close(self) -> None:
        async with self._lock:
            for provider in self._cache.values():
                await provider.close()
            self._cache.clear()


@dataclass
class RouteOutcome:
    """Terminal result of routing one request through the fallback chain."""
    result: StreamingCompletion | JSONCompletion | None
    error: CompletionError | None
    attempts: int = 0
    errors: list[str] = field(default_factory=list)


class Router:
    def __init__(self, loader: ConfigLoader, registry: ProviderRegistry,
                 fallback_provider: str = "openrouter"):
        self._loader = loader
        self._registry = registry
        self._fallback_provider = fallback_provider

    def resolve_rule(self, gateway_model: str) -> ModelFallbackConfig:
        rule = self._loader.rules.get(gateway_model)
        if rule is not None:
            return rule
        # Unknown model → passthrough to the fallback provider.
        return ModelFallbackConfig(
            gateway_model_name=gateway_model,
            fallback_models=[FallbackModelRule(
                provider=self._fallback_provider, model=gateway_model)])

    @staticmethod
    def _build_attempt(payload: dict[str, Any],
                       target: FallbackModelRule) -> CompletionRequest:
        attempt = copy.deepcopy(payload)
        attempt["model"] = target.model
        if target.custom_body_params:
            attempt.update(copy.deepcopy(target.custom_body_params))
        return CompletionRequest(payload=attempt,
                                 stream=bool(attempt.get("stream", False)))

    async def dispatch(self, payload: dict[str, Any]) -> RouteOutcome:
        """Route one chat-completions payload through the fallback chain.
        Usage is not recorded yet (the usage DB is not ported): every
        attempt gets a null observer."""
        gateway_model = str(payload.get("model", ""))
        rule = self.resolve_rule(gateway_model)
        outcome = RouteOutcome(result=None, error=None)
        n_overload = n_other = 0
        for target in rule.fallback_models:
            provider = await self._registry.get(target.provider)
            if provider is None:
                outcome.errors.append(
                    f"provider {target.provider!r} unavailable")
                n_other += 1
                continue
            retries = max(0, int(target.retry_count))
            for attempt_idx in range(retries + 1):
                request = self._build_attempt(payload, target)
                outcome.attempts += 1
                result, error = await provider.complete(request,
                                                        NullUsageObserver())
                if error is None and result is not None:
                    outcome.result = result
                    return outcome
                if error is not None and error.kind == "overload":
                    n_overload += 1
                else:
                    n_other += 1
                outcome.errors.append(
                    f"{target.provider}/{target.model}: "
                    f"{error if error else 'empty response'}")
                logger.warning("attempt failed: %s", outcome.errors[-1])
                if error is not None and not error.retryable:
                    break
                if attempt_idx < retries and \
                        0 < target.retry_delay < MAX_RETRY_DELAY_S:
                    await asyncio.sleep(target.retry_delay)
        if n_overload and not n_other:
            outcome.error = CompletionError(
                detail="all providers overloaded: "
                       + "; ".join(outcome.errors[-5:]),
                status=429, kind="overload")
        else:
            outcome.error = CompletionError(
                detail="; ".join(outcome.errors[-5:]) or
                       f"no providers available for {gateway_model!r}",
                status=503, retryable=False)
        return outcome
