"""Token-usage ledger in SQLite with period aggregation (counterpart of
the JAX package's ``db/usage.py``: the same file name, ``tokens_usage.db``,
and schema).

Timestamped rows of prompt/completion/total/reasoning/cached tokens, cost,
model and provider, with per-request serving metrics (``ttft_ms``,
``tokens_per_sec``) and the SLO outcome (``slo_met``, ``slo_phase``);
strftime-bucketed aggregation with TTFT percentiles, paginated latest
records, a count, and the retention sweep. Inserts never raise into the
serving path.
"""
from __future__ import annotations

import asyncio
import logging
import sqlite3
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

logger = logging.getLogger(__name__)

_PERIOD_FMT = {"hour": "%Y-%m-%d %H:00", "day": "%Y-%m-%d",
               "week": "%Y-%W", "month": "%Y-%m"}


@dataclass
class UsageRecord:
    model: str = ""
    provider: str = ""
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0
    reasoning_tokens: int = 0
    cached_tokens: int = 0
    cost: float = 0.0
    ttft_ms: float | None = None
    tokens_per_sec: float | None = None
    # SLO outcome: 1/0 when the request carried targets (None = no SLO),
    # and the violated phase (queued / prefill / decode) when it missed.
    slo_met: int | None = None
    slo_phase: str | None = None
    timestamp: str = field(default_factory=lambda: time.strftime("%Y-%m-%d %H:%M:%S"))


class UsageDB:
    def __init__(self, db_dir: Path | str = "db"):
        path = Path(db_dir)
        path.mkdir(parents=True, exist_ok=True)
        self._path = path / "tokens_usage.db"
        self._lock = threading.Lock()
        # One shared connection; every statement runs under the lock
        # (check_same_thread=False makes cross-thread use legal, not safe).
        self._conn = sqlite3.connect(self._path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        with self._lock:
            self._conn.execute(
                """CREATE TABLE IF NOT EXISTS tokens_usage (
                       id INTEGER PRIMARY KEY AUTOINCREMENT,
                       timestamp TEXT NOT NULL,
                       prompt_tokens INTEGER DEFAULT 0,
                       completion_tokens INTEGER DEFAULT 0,
                       total_tokens INTEGER DEFAULT 0,
                       reasoning_tokens INTEGER DEFAULT 0,
                       cached_tokens INTEGER DEFAULT 0,
                       cost REAL DEFAULT 0,
                       model TEXT,
                       provider TEXT,
                       ttft_ms REAL,
                       tokens_per_sec REAL,
                       slo_met INTEGER,
                       slo_phase TEXT
                   )""")
            # Ledgers written before the SLO columns existed gain them in
            # place (their rows stay NULL).
            cols = {r[1] for r in self._conn.execute(
                "PRAGMA table_info(tokens_usage)")}
            for col, decl in (("slo_met", "INTEGER"), ("slo_phase", "TEXT")):
                if col not in cols:
                    self._conn.execute(
                        f"ALTER TABLE tokens_usage ADD COLUMN {col} {decl}")
            self._conn.execute(
                "CREATE INDEX IF NOT EXISTS idx_tokens_usage_ts "
                "ON tokens_usage(timestamp)")
            self._conn.commit()

    # -- writes --------------------------------------------------------------
    def insert(self, rec: UsageRecord) -> None:
        """Insert one usage row; errors are logged, never raised (the ledger
        must not break serving)."""
        try:
            with self._lock:
                self._conn.execute(
                    """INSERT INTO tokens_usage
                       (timestamp, prompt_tokens, completion_tokens, total_tokens,
                        reasoning_tokens, cached_tokens, cost, model, provider,
                        ttft_ms, tokens_per_sec, slo_met, slo_phase)
                       VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)""",
                    (rec.timestamp, rec.prompt_tokens, rec.completion_tokens,
                     rec.total_tokens, rec.reasoning_tokens, rec.cached_tokens,
                     rec.cost, rec.model, rec.provider, rec.ttft_ms,
                     rec.tokens_per_sec, rec.slo_met, rec.slo_phase))
                self._conn.commit()
        except sqlite3.Error:
            logger.exception("usage insert failed (ignored)")

    def cleanup_old_records(self, days: int = 180) -> int:
        """Delete rows older than `days`; returns count removed."""
        try:
            with self._lock:
                # Rows are stamped in local time; compare in local time too.
                cur = self._conn.execute(
                    "DELETE FROM tokens_usage WHERE timestamp < "
                    "datetime('now', 'localtime', ?)", (f"-{int(days)} days",))
                self._conn.commit()
                return cur.rowcount
        except sqlite3.Error:
            logger.exception("usage cleanup failed (ignored)")
            return 0

    # -- reads ---------------------------------------------------------------
    def aggregated(self, period: str, start: str, end: str) -> list[dict[str, Any]]:
        """SUM per (period-bucket, model) between start/end timestamps.
        period ∈ {hour, day, week, month}."""
        fmt = _PERIOD_FMT.get(period)
        if fmt is None:
            raise ValueError(f"unknown period {period!r}")
        with self._lock:
            cur = self._conn.execute(
                f"""SELECT strftime('{fmt}', timestamp) AS period, model,
                           SUM(prompt_tokens) AS prompt_tokens,
                           SUM(completion_tokens) AS completion_tokens,
                           SUM(total_tokens) AS total_tokens,
                           SUM(reasoning_tokens) AS reasoning_tokens,
                           SUM(cached_tokens) AS cached_tokens,
                           SUM(cost) AS cost,
                           COUNT(*) AS requests,
                           AVG(ttft_ms) AS avg_ttft_ms,
                           AVG(tokens_per_sec) AS avg_tokens_per_sec,
                           SUM(slo_met) AS slo_met_requests,
                           COUNT(slo_met) AS slo_requests
                    FROM tokens_usage
                    WHERE timestamp >= ? AND timestamp <= ?
                    GROUP BY period, model
                    ORDER BY period DESC, model""",
                (start, end))
            rows = [dict(r) for r in cur.fetchall()]
            # p50/p95 TTFT per bucket (a mean hides tail stalls). SQLite
            # has no percentile aggregate, so pull the raw column and fold
            # in Python; volumes are bounded by the retention sweep.
            cur = self._conn.execute(
                f"""SELECT strftime('{fmt}', timestamp) AS period, model,
                           ttft_ms
                    FROM tokens_usage
                    WHERE timestamp >= ? AND timestamp <= ?
                      AND ttft_ms IS NOT NULL""",
                (start, end))
            samples: dict[tuple[str, str], list[float]] = {}
            for period_b, model, ttft in cur.fetchall():
                samples.setdefault((period_b, model), []).append(float(ttft))
        def pct(vals: list[float], q: float) -> float:
            vals = sorted(vals)
            i = q * (len(vals) - 1)
            lo, hi = int(i), min(int(i) + 1, len(vals) - 1)
            return vals[lo] + (vals[hi] - vals[lo]) * (i - lo)
        for row in rows:
            vals = samples.get((row["period"], row["model"]))
            row["ttft_p50_ms"] = round(pct(vals, 0.50), 1) if vals else None
            row["ttft_p95_ms"] = round(pct(vals, 0.95), 1) if vals else None
        return rows

    def latest(self, limit: int = 25, offset: int = 0) -> list[dict[str, Any]]:
        with self._lock:
            cur = self._conn.execute(
                "SELECT * FROM tokens_usage ORDER BY id DESC LIMIT ? OFFSET ?",
                (limit, offset))
            return [dict(r) for r in cur.fetchall()]

    def total_count(self) -> int:
        with self._lock:
            cur = self._conn.execute("SELECT COUNT(*) FROM tokens_usage")
            return int(cur.fetchone()[0])

    async def aggregated_async(self, period: str, start: str, end: str):
        return await asyncio.to_thread(self.aggregated, period, start, end)

    async def latest_async(self, limit: int = 25, offset: int = 0):
        return await asyncio.to_thread(self.latest, limit, offset)

    async def total_count_async(self) -> int:
        return await asyncio.to_thread(self.total_count)

    def close(self) -> None:
        with self._lock:
            self._conn.close()
