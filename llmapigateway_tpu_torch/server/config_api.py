"""Config editor API: raw-text GET/POST of the two config files and hot
reload (counterpart of the JAX package's ``server/config_api.py``).

The text is served and saved verbatim, so comments survive. A save is
validated (parse, schema, cross-checks) before the file is written; a
validation or syntax failure answers 400 ``{detail, errors}``, which the
editor UI renders, with the file and the config version unchanged. A
failed write answers 500; a save answers 200 with the new
``config_version``. A provider whose entry changed is rebuilt at its next
request (routing/router.py ``ProviderRegistry``). The loader's file I/O
runs in a worker thread, off the event loop.
"""
from __future__ import annotations

import asyncio

from aiohttp import web

from ..config.schemas import ConfigError


async def _get(request: web.Request, which: str) -> web.Response:
    gw = request.app["gateway"]
    try:
        text = await asyncio.to_thread(gw.loader.read_raw, which)
    except OSError as e:
        return web.json_response({"detail": str(e)}, status=404)
    return web.Response(text=text, content_type="text/plain")


async def get_rules_text(request: web.Request) -> web.Response:
    return await _get(request, "rules")


async def get_providers_text(request: web.Request) -> web.Response:
    return await _get(request, "providers")


async def _save(request: web.Request, which: str) -> web.Response:
    gw = request.app["gateway"]
    text = await request.text()
    try:
        await asyncio.to_thread(gw.loader.write_raw, which, text)
    except ConfigError as e:
        return web.json_response(
            {"detail": "validation failed; file not saved",
             "errors": [str(e)]}, status=400)
    except ValueError as e:      # syntax error
        return web.json_response(
            {"detail": "invalid json5; file not saved", "errors": [str(e)]},
            status=400)
    except OSError as e:
        return web.json_response({"detail": f"write failed: {e}"}, status=500)
    return web.json_response({"status": "ok", "reloaded": True,
                              "config_version": gw.loader.version})


async def save_rules(request: web.Request) -> web.Response:
    return await _save(request, "rules")


async def save_providers(request: web.Request) -> web.Response:
    return await _save(request, "providers")
