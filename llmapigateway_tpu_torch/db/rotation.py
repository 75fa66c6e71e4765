"""Per-(api-key, gateway-model) round-robin rotation state in SQLite
(counterpart of the JAX package's ``db/rotation.py``: the same file name,
``rotation.db``, and schema).

Rotation indices survive restarts; first use yields index 0; later calls
advance ``(last+1) % total`` atomically; any DB error degrades to index 0
rather than failing the request. One connection is kept per instance, and
async callers go through :meth:`next_index_async` (a worker thread), so
the event loop never waits on SQLite.
"""
from __future__ import annotations

import asyncio
import logging
import sqlite3
import threading
from pathlib import Path

logger = logging.getLogger(__name__)


class RotationDB:
    def __init__(self, db_dir: Path | str = "db"):
        path = Path(db_dir)
        path.mkdir(parents=True, exist_ok=True)
        self._path = path / "rotation.db"
        self._lock = threading.Lock()
        # One shared connection; every statement runs under the lock
        # (check_same_thread=False makes cross-thread use legal, not safe).
        self._conn = sqlite3.connect(self._path, check_same_thread=False)
        with self._lock:
            self._conn.execute(
                """CREATE TABLE IF NOT EXISTS model_rotation (
                       api_key TEXT NOT NULL,
                       gateway_model TEXT NOT NULL,
                       last_model_index INTEGER NOT NULL,
                       PRIMARY KEY (api_key, gateway_model)
                   )""")
            self._conn.commit()

    def next_index(self, api_key: str, gateway_model: str, total: int) -> int:
        """Advance and persist the rotation pointer; 0 on first use or error."""
        if total <= 0:
            return 0
        try:
            with self._lock:
                cur = self._conn.execute(
                    "SELECT last_model_index FROM model_rotation "
                    "WHERE api_key=? AND gateway_model=?",
                    (api_key, gateway_model))
                row = cur.fetchone()
                if row is None:
                    idx = 0
                    self._conn.execute(
                        "INSERT INTO model_rotation VALUES (?,?,?)",
                        (api_key, gateway_model, idx))
                else:
                    idx = (row[0] + 1) % total
                    self._conn.execute(
                        "UPDATE model_rotation SET last_model_index=? "
                        "WHERE api_key=? AND gateway_model=?",
                        (idx, api_key, gateway_model))
                self._conn.commit()
                return idx
        except sqlite3.Error:
            logger.exception("rotation db error; degrading to index 0")
            return 0

    async def next_index_async(self, api_key: str, gateway_model: str,
                               total: int) -> int:
        return await asyncio.to_thread(self.next_index, api_key,
                                       gateway_model, total)

    def close(self) -> None:
        with self._lock:
            self._conn.close()
