"""Config loading with validation (the load half of the JAX package's
``config/loader.py``; hot reload and the raw-text editor come with the
config editor API). The files are JSON with comments and trailing commas
(utils/json5lite.py).

Load + validate both files at startup with the semantic cross-checks (every
rule's provider must exist, the fallback provider must exist) and the
refusal of provider and rule knobs the port has not ported
(:func:`refuse_unported`). Library code raises :class:`ConfigError`; the
entry point decides process fate.
"""
from __future__ import annotations

import logging
import threading
from pathlib import Path
from typing import Any

from pydantic import ValidationError

from ..utils import json5lite
from .schemas import (ConfigError, ModelFallbackConfig, ProviderDetails,
                      not_ported)

logger = logging.getLogger(__name__)

PROVIDERS_FILE = "providers.json"
RULES_FILE = "models_fallback_rules.json"


def parse_providers(raw: Any) -> dict[str, ProviderDetails]:
    """Validate the parsed providers document → {name: ProviderDetails}.

    Accepts a list of single-key dicts, plus a plain mapping
    {name: details} for convenience.
    """
    entries: list[tuple[str, Any]] = []
    if isinstance(raw, dict):
        entries = list(raw.items())
    elif isinstance(raw, list):
        for item in raw:
            if not isinstance(item, dict) or len(item) != 1:
                raise ConfigError(
                    "each providers.json entry must be a single-key object "
                    f"{{name: details}}, got: {item!r}")
            entries.append(next(iter(item.items())))
    else:
        raise ConfigError("providers.json must be a list or object")

    providers: dict[str, ProviderDetails] = {}
    for name, details in entries:
        if name in providers:
            raise ConfigError(f"duplicate provider name {name!r}")
        try:
            pd = ProviderDetails.model_validate(details)
            pd.validate_semantics(name)
        except (ValidationError, ValueError) as e:
            raise ConfigError(f"provider {name!r} invalid: {e}") from e
        providers[name] = pd
    if not providers:
        raise ConfigError("providers.json defines no providers")
    return providers


def parse_rules(raw: Any) -> dict[str, ModelFallbackConfig]:
    """Validate the parsed rules document → {gateway_model_name: config}.
    The last duplicate wins."""
    if not isinstance(raw, list):
        raise ConfigError("models_fallback_rules.json must be a list of rules")
    rules: dict[str, ModelFallbackConfig] = {}
    for item in raw:
        try:
            rule = ModelFallbackConfig.model_validate(item)
        except ValidationError as e:
            raise ConfigError(f"invalid fallback rule: {e}") from e
        rules[rule.gateway_model_name] = rule
    return rules


def cross_validate(providers: dict[str, ProviderDetails],
                   rules: dict[str, ModelFallbackConfig],
                   fallback_provider: str | None = None) -> None:
    """Semantic checks across the two files."""
    for model_name, cfg in rules.items():
        for fm in cfg.fallback_models:
            if fm.provider not in providers:
                raise ConfigError(
                    f"rule {model_name!r} references unknown provider {fm.provider!r}")
    if fallback_provider and fallback_provider not in providers:
        raise ConfigError(
            f"FALLBACK_PROVIDER {fallback_provider!r} not in providers.json")


def refuse_unported(providers: dict[str, ProviderDetails],
                    rules: dict[str, ModelFallbackConfig]) -> None:
    """Raise :class:`~.schemas.NotPorted` (a ``ConfigError`` and a
    ``ValueError``) for a provider or rule knob whose feature the port
    lacks, naming its ROADMAP item, so a config never silently means
    something else here. The port serves local providers only (a
    ``remote_http`` target is unavailable and the chain moves on), so only
    knobs that reach a local provider are refused, and of those only what
    the JAX router applies to a chain of local providers:

    * a local provider's enabled ``breaker`` (breakers and deadlines);
    * on a rule with a local target: ``rotate_models`` over more than one
      target (rotation), ``timeout_ms``, ``slo_ttft_ms`` and ``slo_tpot_ms``
      (breakers and deadlines);
    * on a local target: ``use_provider_order_as_fallback`` with a
      ``providers_order``, which makes the JAX router try the target once
      per listed sub-provider (remote providers).

    Inert in the JAX router for a local target, and so accepted:
    ``providers_order`` alone (it is sent to OpenRouter only),
    ``custom_headers`` (the local provider reads no headers), and
    ``rotate_models`` on a one-target chain.
    """
    for name, details in providers.items():
        if (details.type == "local" and details.breaker is not None
                and details.breaker.enabled):
            raise not_ported(f"provider {name!r}: breaker",
                             "breakers and deadlines")
    for model_name, rule in rules.items():
        local = [fm for fm in rule.fallback_models
                 if providers.get(fm.provider) is not None
                 and providers[fm.provider].type == "local"]
        if not local:
            continue
        where = f"rule {model_name!r}"
        if rule.rotate_models and len(rule.fallback_models) > 1:
            raise not_ported(f"{where}: rotate_models", "rotation")
        for knob in ("timeout_ms", "slo_ttft_ms", "slo_tpot_ms"):
            if getattr(rule, knob):
                raise not_ported(f"{where}: {knob}", "breakers and deadlines")
        for fm in local:
            if fm.use_provider_order_as_fallback and fm.providers_order:
                raise not_ported(
                    f"{where}, target {fm.provider!r}: "
                    f"use_provider_order_as_fallback", "remote providers")


class ConfigLoader:
    """Owns the validated provider map and fallback rules. Readers get an
    immutable snapshot reference."""

    def __init__(self, config_dir: Path | str = ".",
                 fallback_provider: str | None = None):
        self.config_dir = Path(config_dir)
        self.fallback_provider = fallback_provider
        self._lock = threading.Lock()
        self._providers: dict[str, ProviderDetails] = {}    # guarded-by: _lock
        self._rules: dict[str, ModelFallbackConfig] = {}    # guarded-by: _lock
        self.load()

    @property
    def providers_path(self) -> Path:
        return self.config_dir / PROVIDERS_FILE

    @property
    def rules_path(self) -> Path:
        return self.config_dir / RULES_FILE

    def _read_config(self, path: Path) -> Any:
        try:
            text = path.read_text()
        except OSError as e:
            raise ConfigError(f"cannot read {path}: {e}") from e
        try:
            return json5lite.loads(text)
        except ValueError as e:
            raise ConfigError(f"{path.name} is not valid JSON (comments and trailing commas allowed): {e}") from e

    def load(self) -> None:
        """Load of both files; raises ConfigError on any problem."""
        providers = parse_providers(self._read_config(self.providers_path))
        rules = parse_rules(self._read_config(self.rules_path))
        cross_validate(providers, rules, self.fallback_provider)
        refuse_unported(providers, rules)
        with self._lock:
            self._providers = providers
            self._rules = rules
        logger.info("config loaded: %d providers, %d gateway models",
                    len(providers), len(rules))

    @property
    def providers(self) -> dict[str, ProviderDetails]:
        with self._lock:
            return self._providers

    @property
    def rules(self) -> dict[str, ModelFallbackConfig]:
        with self._lock:
            return self._rules
