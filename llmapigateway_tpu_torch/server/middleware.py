"""aiohttp middlewares: CORS, the request id, request logging and bearer
auth (counterpart of the JAX package's ``server/middleware.py``, without
its metrics and trace spans, which come with the observability layer).

* CORS for the configured origins (``ALLOWED_ORIGINS``); a genuine
  preflight answers 204 on any route.
* Every observed request gets an id: the client's ``x-request-id`` when it
  has a safe shape, else a generated one. Handlers read it from
  ``request["request_id"]``; the router sends it upstream and every
  response carries it back (streamed responses set it themselves).
* Request logging: a start line (method, path, client, headers with
  secrets masked, a chat body with message and tool contents redacted) and
  an end line (status, duration); ``/health`` is not logged.
* Auth: every ``/v1/*`` endpoint is protected but the UI pages (a browser
  cannot attach a bearer header; the data APIs they call stay protected);
  open when no key is configured.
"""
from __future__ import annotations

import json
import logging
import re
import time
import uuid

from aiohttp import web

logger = logging.getLogger("gateway.request")

UNPROTECTED_PATHS = frozenset(("/health", "/metrics", "/", "/favicon.ico"))

# Not logged: probes poll them every few seconds.
UNOBSERVED_PATHS = frozenset(("/health", "/metrics"))

# A client's x-request-id is honoured only in this shape; anything else
# (too long, characters that would corrupt logs or upstream headers) gets a
# generated id.
_REQUEST_ID_RE = re.compile(r"[A-Za-z0-9_-]{1,64}")

SENSITIVE_HEADERS = frozenset(
    ("authorization", "api-key", "x-api-key", "proxy-authorization", "cookie"))


def resolve_request_id(request: web.Request) -> str:
    supplied = request.headers.get("x-request-id", "")
    if supplied and _REQUEST_ID_RE.fullmatch(supplied):
        return supplied
    return uuid.uuid4().hex[:16]


def mask_headers(headers: dict[str, str]) -> dict[str, str]:
    """Secret-bearing headers masked for the log."""
    out = {}
    for k, v in headers.items():
        if k.lower() in SENSITIVE_HEADERS and v:
            out[k] = v[:12] + "****" if len(v) > 16 else "****"
        else:
            out[k] = v
    return out


def cors_middleware(allowed_origins: list[str]):
    allow_all = "*" in allowed_origins

    @web.middleware
    async def middleware(request: web.Request, handler):
        origin = request.headers.get("Origin")
        preflight = (request.method == "OPTIONS" and origin
                     and "Access-Control-Request-Method" in request.headers)
        if preflight:
            # Only a genuine preflight skips routing; a plain OPTIONS to a
            # route still answers as the router says.
            resp = web.Response(status=204)
        else:
            resp = await handler(request)
        if origin and (allow_all or origin in allowed_origins):
            resp.headers["Access-Control-Allow-Origin"] = "*" if allow_all else origin
            resp.headers["Access-Control-Allow-Methods"] = "GET, POST, OPTIONS"
            resp.headers["Access-Control-Allow-Headers"] = "Authorization, Content-Type"
        if not allow_all:
            # Every response varies by origin (a cache must not serve one
            # made for another origin, or for none); append to the
            # handler's own Vary.
            vary = resp.headers.get("Vary")
            if vary is None:
                resp.headers["Vary"] = "Origin"
            elif "origin" not in vary.lower():
                resp.headers["Vary"] = vary + ", Origin"
        return resp

    return middleware


def _redacted_payload(raw: bytes) -> dict | None:
    """A chat-completions body with its message and tool contents redacted:
    its shape and parameters are diagnostic, its contents private."""
    try:
        payload = json.loads(raw)
    except ValueError:
        return None
    if not isinstance(payload, dict):
        return None
    for key in ("messages", "tools"):
        val = payload.get(key)
        if isinstance(val, list):
            payload[key] = f"<redacted: {len(val)} {key}>"
        elif val is not None:
            payload[key] = "<redacted>"
    return payload


def request_logging_middleware(clock=time.monotonic):
    """Sets the request id and logs each request's start and end."""
    @web.middleware
    async def middleware(request: web.Request, handler):
        if request.path in UNOBSERVED_PATHS:
            return await handler(request)
        req_id = resolve_request_id(request)
        request["request_id"] = req_id
        start = clock()
        log_extra = {
            "request_id": req_id, "method": request.method,
            "path": request.path, "client": request.remote,
            "headers": mask_headers(dict(request.headers))}
        if (request.method == "POST"
                and request.path.endswith("/chat/completions")):
            # aiohttp caches the body, so the handler can read it again.
            payload = _redacted_payload(await request.read())
            if payload is not None:
                log_extra["payload"] = payload
        logger.info("request start", extra=log_extra)
        stream_error = False
        try:
            resp = await handler(request)
            status = resp.status
            return resp
        except web.HTTPException as e:
            status = e.status
            raise
        except Exception:
            # A streaming handler that raised after committing put its
            # status on the wire already: log that, not a 500.
            prepared = request.get("prepared_status")
            stream_error = prepared is not None
            status = prepared if prepared is not None else 500
            raise
        finally:
            end_extra = {
                "request_id": req_id, "method": request.method,
                "path": request.path, "status": status,
                "duration_ms": round((clock() - start) * 1000.0, 2)}
            if stream_error:
                end_extra["stream_error"] = True
            logger.info("request end", extra=end_extra)

    return middleware


def request_id_header_middleware():
    @web.middleware
    async def middleware(request: web.Request, handler):
        resp = await handler(request)
        req_id = request.get("request_id")
        # A streamed response is on the wire when the handler returns; it
        # set the header itself.
        if req_id and not resp.prepared:
            resp.headers["x-request-id"] = req_id
        return resp

    return middleware


def auth_middleware(gateway_api_key: str | None):
    @web.middleware
    async def middleware(request: web.Request, handler):
        if not gateway_api_key or request.path in UNPROTECTED_PATHS \
                or request.path.startswith("/static") \
                or request.path.startswith("/v1/ui/") \
                or request.method == "OPTIONS":
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


def client_api_key(request: web.Request) -> str:
    """The client's bearer token, the rotation identity ("anonymous"
    without one)."""
    auth = request.headers.get("Authorization", "")
    if auth.startswith("Bearer "):
        return auth[len("Bearer "):].strip()
    return "anonymous"
