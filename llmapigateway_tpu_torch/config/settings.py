"""Environment-driven settings (the JAX package's ``config/settings.py``,
reduced to what the port's server reads, with the same names and
defaults).

Construct ``Settings.from_env()`` explicitly: it reads a ``.env`` file if
present, then the process environment (env wins).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
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


def _as_bool(val: str | None, default: bool = False) -> bool:
    if val is None:
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")


@dataclass
class Settings:
    """Resolved gateway settings (the fields the port's server reads; the
    JAX package's debug and tracing settings come with those layers). All
    fields overridable via environment."""

    gateway_api_key: str | None = None
    fallback_provider: str = "openrouter"
    gateway_host: str = "0.0.0.0"
    gateway_port: int = 9100
    # CORS origins (ALLOWED_ORIGINS, comma-separated); "*" allows any.
    allowed_origins: list[str] = field(default_factory=lambda: ["*"])
    log_file_limit: int = 15
    log_chat_messages: bool = False
    usage_retention_days: int = 180
    log_level: str = "INFO"
    # Gateway-wide default request time budget in ms. Per-request header
    # or body and per-rule `timeout_ms` take precedence; 0 = unbounded
    # (each attempt still bounded by the transport's 300 s read cap).
    default_request_timeout_ms: float = 0.0
    config_dir: Path | None = None
    db_dir: Path | None = None          # rotation.db, tokens_usage.db
    logs_dir: Path | None = None        # chat transcripts

    @classmethod
    def from_env(cls) -> "Settings":
        base = Path.cwd()
        merged = _load_dotenv(base / ".env")
        merged.update(os.environ)

        origins = [o.strip() for o in merged.get("ALLOWED_ORIGINS", "*")
                   .split(",") if o.strip()] or ["*"]

        def _path(key: str, default: str) -> Path:
            p = Path(merged.get(key, default))
            return p if p.is_absolute() else base / p

        return cls(
            gateway_api_key=merged.get("GATEWAY_API_KEY") or None,
            fallback_provider=merged.get("FALLBACK_PROVIDER", "openrouter"),
            gateway_host=merged.get("GATEWAY_HOST", "0.0.0.0"),
            gateway_port=int(merged.get("GATEWAY_PORT", "9100")),
            allowed_origins=origins,
            log_file_limit=int(merged.get("LOG_FILE_LIMIT", "15")),
            usage_retention_days=int(merged.get("USAGE_RETENTION_DAYS",
                                                "180")),
            log_chat_messages=_as_bool(merged.get("LOG_CHAT_MESSAGES"),
                                       False),
            log_level=merged.get("LOG_LEVEL", "INFO").upper(),
            default_request_timeout_ms=float(
                merged.get("DEFAULT_REQUEST_TIMEOUT_MS", "0") or 0),
            config_dir=_path("CONFIG_DIR", "."),
            db_dir=_path("DB_DIR", "db"),
            logs_dir=_path("LOGS_DIR", "logs"),
        )
