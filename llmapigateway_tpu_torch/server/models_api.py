"""GET /v1/models: the gateway's rule models (``owned_by: "llmgateway"``,
listed first) and the fallback provider's own model list (counterpart of
the JAX package's ``server/models_api.py``; the agent-integration formats
come later). ``?includefallbackmodels=false`` lists the rule models only.
"""
from __future__ import annotations

import time
from typing import Any

from aiohttp import web


async def get_models(request: web.Request) -> web.Response:
    gw = request.app["gateway"]
    created = int(time.time())
    merged: list[dict[str, Any]] = [
        {"id": name, "object": "model", "created": created,
         "owned_by": "llmgateway"} for name in gw.loader.rules]
    if request.query.get("includefallbackmodels", "true").lower() != "false":
        provider = await gw.registry.get(gw.settings.fallback_provider)
        upstream = (await provider.list_models() or []) if provider else []
        seen = {m["id"] for m in merged}
        merged += [m for m in upstream
                   if isinstance(m, dict) and m.get("id") not in seen]
    return web.json_response({"object": "list", "data": merged})
