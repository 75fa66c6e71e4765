"""Config loading with validation, validate-then-swap hot reload and
raw-text access for the config editor (counterpart of the JAX package's
``config/loader.py``). The files are JSON with comments and trailing commas
(utils/json5lite.py): text that the JAX package's ``json5`` takes beyond
that (unquoted keys, single quotes) is refused here.

Load + validate both files at startup with the semantic cross-checks (every
rule's provider must exist, the fallback provider must exist). A reload or
an editor save builds and validates a whole new snapshot before swapping it
in, so the loader never holds a broken config; a save writes the file only
after its text validated. Library code raises :class:`ConfigError`; the
entry point decides process fate.
"""
from __future__ import annotations

import logging
import os
import threading
from pathlib import Path
from typing import Any

from pydantic import ValidationError

from ..utils import json5lite
from .schemas import ConfigError, ModelFallbackConfig, ProviderDetails

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


def resolve_api_key(details: ProviderDetails) -> str | None:
    """The provider's API key: ``apikey`` names an environment variable if
    one is set, else it is the literal key."""
    if not details.apikey:
        return None
    return os.environ.get(details.apikey) or details.apikey


class ConfigLoader:
    """Owns the validated provider map and fallback rules, with hot reload.
    Readers get an immutable snapshot reference; a reload swaps in a whole
    new validated snapshot under the lock."""

    def __init__(self, config_dir: Path | str = ".",
                 fallback_provider: str | None = None):
        self.config_dir = Path(config_dir)
        self.fallback_provider = fallback_provider
        self._lock = threading.Lock()
        self._providers: dict[str, ProviderDetails] = {}    # guarded-by: _lock
        self._rules: dict[str, ModelFallbackConfig] = {}    # guarded-by: _lock
        # Bumped on every successful (re)load or save.
        self._version = 0           # guarded-by: _lock
        self.load()

    @property
    def providers_path(self) -> Path:
        return self.config_dir / PROVIDERS_FILE

    @property
    def rules_path(self) -> Path:
        return self.config_dir / RULES_FILE

    def _path(self, which: str) -> Path:
        if which == "providers":
            return self.providers_path
        if which == "rules":
            return self.rules_path
        raise ValueError(f"unknown config file {which!r}")

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
        with self._lock:
            self._providers = providers
            self._rules = rules
            self._version += 1
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

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    # -- hot reload (validate, then swap; never partial) ---------------------
    def reload_providers(self) -> tuple[bool, str | None]:
        """Re-read providers.json: (True, None) after swapping it in, or
        (False, reason) with the old snapshot kept."""
        try:
            providers = parse_providers(self._read_config(self.providers_path))
            cross_validate(providers, self.rules, self.fallback_provider)
        except ConfigError as e:
            logger.error("providers reload rejected: %s", e)
            return False, str(e)
        with self._lock:
            self._providers = providers
            self._version += 1
        logger.info("providers hot-reloaded: %d providers", len(providers))
        return True, None

    def reload_rules(self) -> tuple[bool, str | None]:
        """Re-read the rules, validated against the current providers."""
        try:
            rules = parse_rules(self._read_config(self.rules_path))
            cross_validate(self.providers, rules, None)
        except ConfigError as e:
            logger.error("rules reload rejected: %s", e)
            return False, str(e)
        with self._lock:
            self._rules = rules
            self._version += 1
        logger.info("rules hot-reloaded: %d gateway models", len(rules))
        return True, None

    # -- raw text for the config editor (comments kept) ----------------------
    def read_raw(self, which: str) -> str:
        """The text of ``"providers"`` or ``"rules"`` as it is on disk."""
        return self._path(which).read_text()

    def write_raw(self, which: str, text: str) -> None:
        """Validate ``text`` (parse, schema, cross-checks), then write it
        verbatim, comments kept, and swap in its snapshot. Raises
        ConfigError (or ValueError on a syntax error) with the file and the
        snapshot unchanged."""
        path = self._path(which)
        parsed = json5lite.loads(text)      # raises on a syntax error
        if which == "providers":
            providers = parse_providers(parsed)
            cross_validate(providers, self.rules, self.fallback_provider)
            path.write_text(text)
            with self._lock:
                self._providers = providers
                self._version += 1
        else:
            rules = parse_rules(parsed)
            cross_validate(self.providers, rules, None)
            path.write_text(text)
            with self._lock:
                self._rules = rules
                self._version += 1
