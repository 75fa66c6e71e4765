"""Application composition: config, DBs, breakers, router, providers, HTTP
app (counterpart of the JAX package's ``server/app.py``).

``python -m llmapigateway_tpu_torch`` serves like ``python main.py``, with
the port's engine behind ``type: "local"`` providers on the device given by
``--device`` (``cuda`` by default). Routes: ``/health``; ``/`` (to the
config editor); the OpenAI-compatible ``/v1/chat/completions`` and
``/v1/models`` with its agent formats; the config editor's API
(``/v1/config/*``) and pages (``/v1/ui/*``, ``/static``); the usage stats
and provider health APIs (``/v1/api/*``).
"""
from __future__ import annotations

import asyncio
import functools
import logging
from pathlib import Path
from typing import Callable

from aiohttp import web

from ..config.loader import ConfigLoader
from ..config.settings import Settings
from ..db.recorder import UsageRecorder
from ..db.rotation import RotationDB
from ..db.usage import UsageDB
from ..providers.base import Provider
from ..providers.local import make_local_provider
from ..reliability.breaker import BreakerRegistry
from ..routing.router import ProviderRegistry, Router
from . import chat, config_api, models_api, stats_api
from .middleware import (
    auth_middleware,
    cors_middleware,
    request_id_header_middleware,
    request_logging_middleware,
)

logger = logging.getLogger(__name__)

STATIC_DIR = Path(__file__).resolve().parent.parent / "static"

RETENTION_SWEEP_S = 24 * 3600


class GatewayApp:
    """Holds the gateway's singletons; attached to the aiohttp app as
    ``app["gateway"]``. The usage ledger and the rotation state live under
    ``settings.db_dir``."""

    def __init__(self, settings: Settings, loader: ConfigLoader,
                 local_factory: Callable[..., Provider] | None = None):
        self.settings = settings
        self.loader = loader
        self.usage_db = UsageDB(settings.db_dir or "db")
        # Write-behind: stream-end observers enqueue, one flusher thread
        # writes SQLite; close() drains it before the DB closes.
        self.usage_recorder = UsageRecorder(self.usage_db)
        self.rotation_db = RotationDB(settings.db_dir or "db")
        self.registry = ProviderRegistry(loader, local_factory=local_factory)
        self.breakers = BreakerRegistry(loader)
        self.router = Router(
            loader, self.registry, self.rotation_db,
            fallback_provider=settings.fallback_provider,
            breakers=self.breakers,
            default_timeout_ms=settings.default_request_timeout_ms)

    async def close(self) -> None:
        await self.registry.close()
        # Recorder before DB: drain the queue while the connection is open.
        await asyncio.to_thread(self.usage_recorder.close)
        self.usage_db.close()
        self.rotation_db.close()


async def _health(request: web.Request) -> web.Response:
    return web.json_response({"status": "ok"})


async def _root_redirect(request: web.Request) -> web.Response:
    raise web.HTTPFound("/v1/ui/rules-editor")


def _static_page(filename: str):
    async def handler(request: web.Request) -> web.Response:
        path = STATIC_DIR / filename
        if not path.exists():
            return web.json_response({"detail": f"{filename} not found"},
                                     status=404)
        text = await asyncio.to_thread(path.read_text)
        return web.Response(text=text, content_type="text/html")
    return handler


def build_app(settings: Settings | None = None,
              loader: ConfigLoader | None = None,
              local_factory: Callable[..., Provider] | None = None
              ) -> web.Application:
    """Build the aiohttp application. All dependencies injectable for tests;
    ``local_factory`` builds the ``type: "local"`` providers (e.g.
    ``functools.partial(make_local_provider, device="cpu")``)."""
    settings = settings or Settings.from_env()
    if loader is None:
        loader = ConfigLoader(settings.config_dir or ".",
                              fallback_provider=settings.fallback_provider)
    gw = GatewayApp(settings, loader, local_factory=local_factory)

    app = web.Application(middlewares=[
        cors_middleware(settings.allowed_origins),
        request_id_header_middleware(),
        request_logging_middleware(),
        auth_middleware(settings.gateway_api_key),
    ])
    app["gateway"] = gw
    app.router.add_get("/health", _health)
    app.router.add_get("/", _root_redirect)

    app.router.add_post("/v1/chat/completions", chat.chat_completions)
    app.router.add_get("/v1/models", models_api.get_models)
    app.router.add_get("/v1/models/AsOpenCodeFormat",
                       models_api.get_models_as_opencode)
    app.router.add_get("/v1/models/AsGitHubCopilotFormat",
                       models_api.get_models_as_github_copilot)

    app.router.add_get("/v1/config/models-rules", config_api.get_rules_text)
    app.router.add_post("/v1/config/models-rules", config_api.save_rules)
    app.router.add_get("/v1/config/providers", config_api.get_providers_text)
    app.router.add_post("/v1/config/providers", config_api.save_providers)
    app.router.add_get("/v1/ui/rules-editor",
                       _static_page("rules-editor.html"))
    app.router.add_get("/v1/ui/usage-stats", _static_page("usage-stats.html"))

    app.router.add_get("/v1/api/usage-stats/{period}",
                       stats_api.get_usage_stats)
    app.router.add_get("/v1/api/usage-records", stats_api.get_usage_records)
    app.router.add_get("/v1/api/health/providers",
                       stats_api.get_provider_health)
    if STATIC_DIR.exists():
        app.router.add_static("/static", STATIC_DIR)

    async def _retention_loop() -> None:
        while True:
            removed = await asyncio.to_thread(
                gw.usage_db.cleanup_old_records,
                settings.usage_retention_days)
            if removed:
                logger.info("usage retention: removed %d old rows", removed)
            await asyncio.sleep(RETENTION_SWEEP_S)

    async def _on_startup(app: web.Application) -> None:
        app["retention_task"] = asyncio.get_running_loop().create_task(
            _retention_loop())

    async def _on_cleanup(app: web.Application) -> None:
        task = app.get("retention_task")
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        await gw.close()

    app.on_startup.append(_on_startup)
    app.on_cleanup.append(_on_cleanup)
    return app


def run(settings: Settings | None = None, device: str = "cuda") -> None:
    settings = settings or Settings.from_env()
    logging.basicConfig(level=settings.log_level,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    app = build_app(settings, local_factory=functools.partial(
        make_local_provider, device=device))
    web.run_app(app, host=settings.gateway_host, port=settings.gateway_port,
                access_log=None)
