"""Usage statistics and provider health (counterpart of the JAX package's
``server/stats_api.py``).

``GET /v1/api/usage-stats/{period}`` with period ∈ {hour, day, week,
month} over windows of 24 h / 2 w / 15 w / 365 d, the paginated
``GET /v1/api/usage-records``, and ``GET /v1/api/health/providers``: the
circuit breaker of each provider (state, windowed failure rate, cooldown
remaining, lifetime opens, last transition). Configured providers without
traffic report as closed, so the operator sees the whole roster.
"""
from __future__ import annotations

import datetime as dt

from aiohttp import web

_WINDOWS = {
    "hour": dt.timedelta(hours=24),
    "day": dt.timedelta(weeks=2),
    "week": dt.timedelta(weeks=15),
    "month": dt.timedelta(days=365),
}


async def get_usage_stats(request: web.Request) -> web.Response:
    gw = request.app["gateway"]
    period = request.match_info["period"]
    window = _WINDOWS.get(period)
    if window is None:
        return web.json_response(
            {"detail": f"period must be one of {sorted(_WINDOWS)}"}, status=400)
    now = dt.datetime.now()
    start = (now - window).strftime("%Y-%m-%d %H:%M:%S")
    end = now.strftime("%Y-%m-%d %H:%M:%S")
    rows = await gw.usage_db.aggregated_async(period, start, end)
    return web.json_response({"period": period, "data": rows})


async def get_usage_records(request: web.Request) -> web.Response:
    gw = request.app["gateway"]
    try:
        limit = max(1, min(200, int(request.query.get("limit", "25"))))
        offset = max(0, int(request.query.get("offset", "0")))
    except ValueError:
        return web.json_response({"detail": "limit/offset must be ints"},
                                 status=400)
    rows = await gw.usage_db.latest_async(limit, offset)
    total = await gw.usage_db.total_count_async()
    return web.json_response({"records": rows, "total": total,
                              "limit": limit, "offset": offset})


async def get_provider_health(request: web.Request) -> web.Response:
    """GET /v1/api/health/providers — breaker state per provider."""
    gw = request.app["gateway"]
    snapshot = gw.breakers.snapshot()
    providers = {}
    for name, details in sorted(gw.loader.providers.items()):
        entry = snapshot.pop(name, None) or {
            "state": "closed", "state_code": 0.0,
            "failure_rate": 0.0, "window_requests": 0,
            "cooldown_remaining_s": 0.0, "opens": 0, "last_transition": None,
            "enabled": (details.breaker.enabled
                        if details.breaker is not None else True),
        }
        entry["type"] = details.type
        providers[name] = entry
    # Breakers of providers no longer in the config still report.
    for name, entry in snapshot.items():
        entry["type"] = "removed"
        providers[name] = entry
    return web.json_response({"providers": providers})
