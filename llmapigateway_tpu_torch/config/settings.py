"""Environment-driven settings (the JAX package's ``config/settings.py``,
reduced to what the port's server reads).

Construct ``Settings.from_env()`` explicitly: it reads a ``.env`` file if
present, then the process environment (env wins).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path


def _load_dotenv(path: Path) -> dict[str, str]:
    """Minimal .env parser: KEY=VALUE lines, '#' comments, optional quotes."""
    out: dict[str, str] = {}
    try:
        text = path.read_text()
    except OSError:
        return out
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, val = line.partition("=")
        key = key.strip()
        val = val.strip()
        if len(val) >= 2 and val[0] == val[-1] and val[0] in "\"'":
            val = val[1:-1]
        if key:
            out[key] = val
    return out


@dataclass
class Settings:
    """Resolved gateway settings (the fields the port's server reads; the
    JAX package's logging, CORS, usage and tracing settings come with those
    layers). All fields overridable via environment."""

    gateway_api_key: str | None = None
    fallback_provider: str = "openrouter"
    gateway_host: str = "0.0.0.0"
    gateway_port: int = 9100
    log_level: str = "INFO"
    config_dir: Path | None = None

    @classmethod
    def from_env(cls) -> "Settings":
        base = Path.cwd()
        merged = _load_dotenv(base / ".env")
        merged.update(os.environ)
        config_dir = Path(merged.get("CONFIG_DIR", "."))
        return cls(
            gateway_api_key=merged.get("GATEWAY_API_KEY") or None,
            fallback_provider=merged.get("FALLBACK_PROVIDER", "openrouter"),
            gateway_host=merged.get("GATEWAY_HOST", "0.0.0.0"),
            gateway_port=int(merged.get("GATEWAY_PORT", "9100")),
            log_level=merged.get("LOG_LEVEL", "INFO").upper(),
            config_dir=config_dir if config_dir.is_absolute()
            else base / config_dir,
        )
