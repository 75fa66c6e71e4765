"""GET /v1/models and the agent-integration formats (counterpart of the
JAX package's ``server/models_api.py``).

* ``/v1/models`` — the gateway's rule models (``owned_by: "llmgateway"``,
  listed first) and the fallback provider's own model list, read from the
  live loader (hot reloads show at once).
* ``/v1/models/AsOpenCodeFormat`` — an opencode.json provider block:
  context and output limits, input modalities (``file`` → ``pdf``),
  reasoning-effort variants.
* ``/v1/models/AsGitHubCopilotFormat`` — chatLanguageModels.json entries:
  tool calling always on, vision from the input modalities, reasoning
  efforts; the gateway's own models get vision and reasoning.

``?includefallbackmodels=false`` lists the rule models only.
"""
from __future__ import annotations

import time
from typing import Any

from aiohttp import web

REASONING_VARIANTS = ["none", "minimal", "low", "medium", "high", "xhigh"]
# Limits used when the upstream's metadata has none.
OPENCODE_DEFAULT_CONTEXT, OPENCODE_DEFAULT_OUTPUT = 200_000, 32_000
COPILOT_DEFAULT_CONTEXT, COPILOT_DEFAULT_OUTPUT = 400_000, 60_000


def _gateway_models(gw) -> list[dict[str, Any]]:
    created = int(time.time())
    return [{"id": name, "object": "model", "created": created,
             "owned_by": "llmgateway"} for name in gw.loader.rules]


async def _upstream_models(request: web.Request, gw) -> list[dict[str, Any]]:
    if request.query.get("includefallbackmodels", "true").lower() == "false":
        return []
    provider = await gw.registry.get(gw.settings.fallback_provider)
    if provider is None:
        return []
    return await provider.list_models() or []


def _listed(gateway_models, upstream):
    """(upstream models by id, every model to list: the gateway's first,
    then the upstream's not among them, once each)."""
    upstream_by_id = {m.get("id"): m for m in upstream if isinstance(m, dict)}
    gateway_ids = {g["id"] for g in gateway_models}
    return upstream_by_id, gateway_models + [
        u for i, u in upstream_by_id.items() if i not in gateway_ids]


async def get_models(request: web.Request) -> web.Response:
    gw = request.app["gateway"]
    merged = _gateway_models(gw)
    seen = {m["id"] for m in merged}
    merged += [m for m in await _upstream_models(request, gw)
               if isinstance(m, dict) and m.get("id") not in seen]
    return web.json_response({"object": "list", "data": merged})


def _extract_modalities(model: dict[str, Any]) -> tuple[list[str], list[str]]:
    arch = model.get("architecture") or {}
    inputs = arch.get("input_modalities") or ["text"]
    outputs = arch.get("output_modalities") or ["text"]
    inputs = ["pdf" if m == "file" else m for m in inputs]
    return inputs, outputs


def _reasoning_variants(model: dict[str, Any]) -> list[str]:
    supported = model.get("supported_parameters") or []
    if "reasoning" in supported or "include_reasoning" in supported:
        return REASONING_VARIANTS
    return []


async def get_models_as_opencode(request: web.Request) -> web.Response:
    gw = request.app["gateway"]
    upstream_by_id, models = _listed(_gateway_models(gw),
                                     await _upstream_models(request, gw))
    models_block: dict[str, Any] = {}
    for m in models:
        mid = m["id"]
        meta = upstream_by_id.get(mid, m)
        top = meta.get("top_provider") or {}
        context = top.get("context_length") or meta.get("context_length") \
            or OPENCODE_DEFAULT_CONTEXT
        output = top.get("max_completion_tokens") or OPENCODE_DEFAULT_OUTPUT
        inputs, _ = _extract_modalities(meta)
        entry: dict[str, Any] = {
            "name": meta.get("name", mid),
            "limit": {"context": context, "output": output},
            "modalities": {"input": inputs, "output": ["text"]},
        }
        variants = _reasoning_variants(meta)
        if variants or m.get("owned_by") == "llmgateway":
            entry["variants"] = {
                v: {"reasoning_effort": v}
                for v in (variants or REASONING_VARIANTS) if v != "none"}
        models_block[mid] = entry

    host = request.host or f"localhost:{gw.settings.gateway_port}"
    return web.json_response({
        "llmgateway": {
            "npm": "@ai-sdk/openai-compatible",
            "name": "LLM Gateway (TPU)",
            "options": {"baseURL": f"http://{host}/v1",
                        "apiKey": "{env:GATEWAY_API_KEY}"},
            "models": models_block,
        }
    })


async def get_models_as_github_copilot(request: web.Request) -> web.Response:
    gw = request.app["gateway"]
    upstream_by_id, models = _listed(_gateway_models(gw),
                                     await _upstream_models(request, gw))
    out: list[dict[str, Any]] = []
    for m in models:
        mid = m["id"]
        meta = upstream_by_id.get(mid, m)
        is_local = m.get("owned_by") == "llmgateway"
        inputs, _ = _extract_modalities(meta)
        top = meta.get("top_provider") or {}
        entry = {
            "id": mid,
            "name": meta.get("name", mid),
            "toolCalling": True,
            "vision": "image" in inputs or is_local,
            "maxInputTokens": top.get("context_length")
                or meta.get("context_length") or COPILOT_DEFAULT_CONTEXT,
            "maxOutputTokens": top.get("max_completion_tokens")
                or COPILOT_DEFAULT_OUTPUT,
        }
        if _reasoning_variants(meta) or is_local:
            entry["reasoningEfforts"] = [v for v in REASONING_VARIANTS
                                         if v != "none"]
        out.append(entry)
    return web.json_response(out)
