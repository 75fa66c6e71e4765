"""Application composition: config, router, providers, HTTP app
(counterpart of the JAX package's ``server/app.py``).

``python -m llmapigateway_tpu_torch`` serves like ``python main.py``, with
the port's engine behind ``type: "local"`` providers on the device given by
``--device`` (``cuda`` by default).
"""
from __future__ import annotations

import functools
import logging
from typing import Callable

from aiohttp import web

from ..config.loader import ConfigLoader
from ..config.settings import Settings
from ..providers.base import Provider
from ..providers.local import make_local_provider
from ..routing.router import ProviderRegistry, Router
from . import chat, models_api
from .middleware import auth_middleware

logger = logging.getLogger(__name__)


class GatewayApp:
    """Holds the gateway's singletons; attached to the aiohttp app as
    ``app["gateway"]``."""

    def __init__(self, settings: Settings, loader: ConfigLoader,
                 local_factory: Callable[..., Provider] | None = None):
        self.settings = settings
        self.loader = loader
        self.registry = ProviderRegistry(loader, local_factory=local_factory)
        self.router = Router(loader, self.registry,
                             fallback_provider=settings.fallback_provider)

    async def close(self) -> None:
        await self.registry.close()


async def _health(request: web.Request) -> web.Response:
    return web.json_response({"status": "ok"})


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

    app = web.Application(middlewares=[auth_middleware(settings.gateway_api_key)])
    app["gateway"] = gw
    app.router.add_get("/health", _health)
    app.router.add_post("/v1/chat/completions", chat.chat_completions)
    app.router.add_get("/v1/models", models_api.get_models)

    async def _on_cleanup(app: web.Application) -> None:
        await gw.close()

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
