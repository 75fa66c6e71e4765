"""Bearer auth (the auth half of the JAX package's ``server/middleware.py``;
CORS, request logging and tracing come with the observability layer).

Every endpoint but ``/health`` is protected; the gateway is open when no
key is configured.
"""
from __future__ import annotations

from aiohttp import web

UNPROTECTED_PATHS = frozenset(("/health",))


def auth_middleware(gateway_api_key: str | None):
    @web.middleware
    async def middleware(request: web.Request, handler):
        if not gateway_api_key or request.path in UNPROTECTED_PATHS:
            return await handler(request)
        auth = request.headers.get("Authorization", "")
        if not auth.startswith("Bearer "):
            return web.json_response(
                {"error": {"message": "Missing bearer token", "code": 401}},
                status=401)
        if auth[len("Bearer "):].strip() != gateway_api_key:
            return web.json_response(
                {"error": {"message": "Invalid API key", "code": 403}},
                status=403)
        return await handler(request)

    return middleware
