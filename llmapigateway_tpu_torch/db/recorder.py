"""Write-behind usage recording (counterpart of the JAX package's
``db/recorder.py``).

Producers enqueue :class:`~..db.usage.UsageRecord` rows into a bounded
in-memory queue (never blocking the serving path; a full queue drops the
row and counts it), and ONE background flusher thread drains them into
the ledger. The flusher touches SQLite only, never a device tensor.

Durability: rows are flushed eagerly (the flusher waits only when the
queue is empty), ``flush()`` blocks until everything enqueued so far is
written, and ``close()`` drains before returning, so a graceful shutdown
persists the usage of interrupted streams. It duck-types
``UsageDB.insert``, so :class:`~..server.usage_capture.UsageCollector`
takes either.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any

logger = logging.getLogger(__name__)


class UsageRecorder:
    """Bounded write-behind queue in front of a :class:`UsageDB`."""

    def __init__(self, usage_db: Any, maxsize: int = 1024):
        self._db = usage_db
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, maxsize))
        self._closed = False
        # Invariant: enqueued == flushed + in queue (drops never enter the
        # queue), so flush() can wait on plain ints (one writer each).
        self._enqueued = 0
        self._flushed = 0
        self._dropped = 0
        self._thread = threading.Thread(target=self._flush_loop,
                                        daemon=True, name="usage-recorder")
        self._thread.start()

    # -- producer side (duck-types UsageDB.insert) --------------------------
    def insert(self, rec: Any) -> None:
        """Enqueue one usage row; NEVER blocks the serving path. A full
        queue drops the row and counts it: losing a ledger row beats
        stalling a stream's end."""
        if self._closed:
            # Late stragglers after shutdown go straight through: the
            # DB's insert never raises.
            self._db.insert(rec)
            return
        try:
            self._queue.put_nowait(rec)
            self._enqueued += 1
        except queue.Full:
            self._dropped += 1

    # -- flusher ------------------------------------------------------------
    def _flush_loop(self) -> None:
        while not self._closed or not self._queue.empty():
            try:
                rec = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                self._db.insert(rec)    # UsageDB.insert never raises
            finally:
                self._flushed += 1

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Block until every row enqueued before this call is written (or
        the timeout passes). True when fully drained."""
        target = self._enqueued
        deadline = time.monotonic() + timeout_s
        while self._flushed < target:
            if time.monotonic() > deadline:
                logger.warning("usage recorder flush timed out with "
                               "%d rows pending", target - self._flushed)
                return False
            time.sleep(0.002)
        return True

    def close(self, timeout_s: float = 5.0) -> None:
        """Drain the queue and stop the flusher. Idempotent."""
        if self._closed:
            return
        self.flush(timeout_s)
        self._closed = True
        self._thread.join(timeout=timeout_s)
        if self._thread.is_alive():
            logger.warning("usage recorder flusher did not exit cleanly")

    def stats(self) -> dict[str, Any]:
        return {
            "usage_recorder_queued": self._queue.qsize(),
            "usage_recorder_capacity": self._queue.maxsize,
            "usage_recorder_enqueued_total": self._enqueued,
            "usage_recorder_flushed_total": self._flushed,
            "usage_recorder_dropped_total": self._dropped,
        }
