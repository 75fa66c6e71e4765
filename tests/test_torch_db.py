"""The port's usage ledger, rotation state, write-behind recorder and
usage capture against the JAX package's, on the same inputs in fresh
``tmp_path`` databases: rotation index sequences, usage aggregates and
their TTFT percentiles, latest records, counts and the retention sweep
(fixed timestamps), usage-field extraction and transcripts."""
import dataclasses
import datetime
import threading
import time

import pytest

from llmapigateway_tpu.db.recorder import UsageRecorder as JRecorder
from llmapigateway_tpu.db.rotation import RotationDB as JRotation
from llmapigateway_tpu.db.usage import UsageDB as JUsage
from llmapigateway_tpu.db.usage import UsageRecord as JRecord
from llmapigateway_tpu.server import usage_capture as jcapture
from llmapigateway_tpu_torch.db.recorder import UsageRecorder
from llmapigateway_tpu_torch.db.rotation import RotationDB
from llmapigateway_tpu_torch.db.usage import UsageDB, UsageRecord
from llmapigateway_tpu_torch.server import usage_capture as tcapture


def test_rotation_index_sequences_match_jax(tmp_path):
    jdb, tdb = JRotation(tmp_path / "j"), RotationDB(tmp_path / "t")
    calls = [("k1", "gw/a", 3)] * 5 + [("k2", "gw/a", 3), ("k1", "gw/b", 2),
                                       ("k1", "gw/a", 2), ("k1", "gw/a", 5),
                                       ("k1", "gw/a", 0), ("k2", "gw/a", 3)]
    try:
        want = [jdb.next_index(*c) for c in calls]
        got = [tdb.next_index(*c) for c in calls]
        assert got == want
        assert got[:5] == [0, 1, 2, 0, 1]
        # Same file name and schema: the JAX package reads the port's DB.
        tdb.close()
        reread = JRotation(tmp_path / "t")
        assert reread.next_index("k1", "gw/a", 5) == \
            jdb.next_index("k1", "gw/a", 5)
        reread.close()
    finally:
        jdb.close()


async def test_rotation_async_offload(tmp_path):
    db = RotationDB(tmp_path)
    try:
        assert [await db.next_index_async("k", "m", 2)
                for _ in range(3)] == [0, 1, 0]
    finally:
        db.close()


def _records(cls):
    rows = []
    for i, (stamp, model, ttft) in enumerate([
            ("2026-01-05 10:15:00", "m1", 120.0),
            ("2026-01-05 10:45:00", "m1", 80.0),
            ("2026-01-05 10:50:00", "m1", None),
            ("2026-01-05 11:05:00", "m2", 300.0),
            ("2026-01-06 09:00:00", "m1", 95.5),
            ("2026-02-01 00:00:00", "m2", 40.0),
            ("2001-01-01 00:00:00", "old", 1.0)]):
        rows.append(cls(model=model, provider=f"p{i % 2}",
                        prompt_tokens=10 * i, completion_tokens=i + 1,
                        total_tokens=11 * i + 1, reasoning_tokens=i % 3,
                        cached_tokens=4 * (i % 2), cost=0.001 * i,
                        ttft_ms=ttft, tokens_per_sec=None if i == 2 else
                        20.0 + i, slo_met=None if i % 3 == 0 else i % 2,
                        slo_phase="prefill" if i == 1 else None,
                        timestamp=stamp))
    return rows


def test_usage_ledger_matches_jax(tmp_path):
    jdb, tdb = JUsage(tmp_path / "j"), UsageDB(tmp_path / "t")
    try:
        for jr, tr in zip(_records(JRecord), _records(UsageRecord)):
            jdb.insert(jr)
            tdb.insert(tr)
        window = ("2026-01-01 00:00:00", "2026-12-31 23:59:59")
        for period in ("hour", "day", "week", "month"):
            assert tdb.aggregated(period, *window) == \
                jdb.aggregated(period, *window)
        hours = tdb.aggregated("hour", *window)
        m1 = next(r for r in hours if r["period"] == "2026-01-05 10:00")
        assert m1["requests"] == 3 and m1["ttft_p50_ms"] == 100.0
        with pytest.raises(ValueError):
            tdb.aggregated("year", *window)
        for limit, offset in ((25, 0), (2, 1), (3, 5)):
            assert tdb.latest(limit, offset) == jdb.latest(limit, offset)
        assert tdb.total_count() == jdb.total_count() == 7
        # A retention whose cutoff falls in mid-2025 takes the 2001 row
        # only.
        days = (datetime.datetime.now() - datetime.datetime(2025, 6, 1)).days
        assert tdb.cleanup_old_records(days) == \
            jdb.cleanup_old_records(days) == 1
        assert tdb.total_count() == 6
    finally:
        jdb.close()
        tdb.close()


async def test_usage_ledger_async_reads(tmp_path):
    db = UsageDB(tmp_path)
    try:
        db.insert(UsageRecord(model="m", timestamp="2026-01-05 10:00:00"))
        db.insert(UsageRecord(model="m", timestamp="2026-01-05 10:30:00"))
        rows = await db.aggregated_async("day", "2026-01-01 00:00:00",
                                         "2026-01-31 00:00:00")
        assert rows[0]["requests"] == 2
        assert len(await db.latest_async(1, 0)) == 1
        assert await db.total_count_async() == 2
    finally:
        db.close()


class _SlowDB:
    """A ledger whose inserts take a while (the flusher must wait for
    them) and which records the thread that wrote each row."""

    def __init__(self) -> None:
        self.rows, self.threads = [], set()

    def insert(self, rec) -> None:
        time.sleep(0.002)
        self.rows.append(rec)
        self.threads.add(threading.current_thread().name)


@pytest.mark.parametrize("cls", [JRecorder, UsageRecorder],
                         ids=["jax", "port"])
def test_recorder_flush_makes_rows_durable_and_close_drains(cls):
    db = _SlowDB()
    rec = cls(db, maxsize=64)
    for i in range(20):
        rec.insert(i)
    assert rec.flush(timeout_s=5.0)
    assert db.rows == list(range(20)) and db.threads == {"usage-recorder"}
    for i in range(20, 60):
        rec.insert(i)
    rec.close(timeout_s=5.0)
    assert db.rows == list(range(60))
    assert not rec._thread.is_alive()
    rec.insert(60)                     # after close: straight through
    assert db.rows[-1] == 60
    stats = rec.stats()
    assert stats["usage_recorder_flushed_total"] == 60
    assert stats["usage_recorder_dropped_total"] == 0
    rec.close()                        # idempotent


def test_recorder_counts_drops_when_full():
    gate = threading.Event()

    class Blocked(_SlowDB):
        def insert(self, rec):
            gate.wait(5.0)
            super().insert(rec)
    db = Blocked()
    rec = UsageRecorder(db, maxsize=2)
    for i in range(6):
        rec.insert(i)
    dropped = rec.stats()["usage_recorder_dropped_total"]
    gate.set()
    rec.close(timeout_s=5.0)
    # One row in the flusher's hands, two queued, the rest dropped.
    assert dropped in (3, 4) and len(db.rows) == 6 - dropped


@pytest.mark.parametrize("usage", [
    {},
    {"prompt_tokens": 12, "completion_tokens": 30, "total_tokens": 42},
    {"prompt_tokens": 5, "completion_tokens": 9,
     "completion_tokens_details": {"reasoning_tokens": 4},
     "prompt_tokens_details": {"cached_tokens": 3}, "cost": 0.25},
    {"prompt_tokens": 5, "completion_tokens": 2, "reasoning_tokens": 7,
     "cached_tokens": 1, "total_cost": "0.5"},
    {"prompt_tokens": 3, "completion_tokens": 4,
     "slo": {"met": False, "phase": "queued"}},
    {"prompt_tokens": 3, "completion_tokens": 4, "slo": {"met": True}},
    {"prompt_tokens": None, "completion_tokens": None, "slo": "bad"},
])
def test_usage_fields_match_jax(usage):
    assert tcapture.extract_usage_fields(usage) == \
        jcapture.extract_usage_fields(usage)


def test_collector_records_once_and_writes_transcripts(tmp_path):
    """One completed attempt writes one row (outside a loop: inline) and,
    with chat logging on, one transcript; both packages alike."""
    payload = {"messages": [{"role": "user", "content": "hi"}, "raw"]}
    out = {}
    for name, mod in (("jax", jcapture), ("port", tcapture)):
        sink = _SlowDB()
        logs = tmp_path / name
        c = mod.UsageCollector(provider="p", model="m", usage_db=sink,
                               request_payload=payload, logs_dir=logs,
                               log_chat_messages=True, log_file_limit=2)
        c.on_first_token()
        c.on_content_delta("Hello ")
        c.on_content_delta("")
        c.on_content_delta("world")
        c.on_usage({"prompt_tokens": 2, "completion_tokens": 3,
                    "total_tokens": 5})
        c.on_stream_end()
        c.on_stream_end("again")           # recorded once
        for i in range(3):
            mod.write_transcript(logs, 2, payload, f"t{i}", {"k": i})
            time.sleep(0.002)              # distinct millisecond names
        row = dataclasses.asdict(sink.rows[0])
        for volatile in ("timestamp", "ttft_ms", "tokens_per_sec"):
            row.pop(volatile)
        texts = sorted(p.read_text().split("\n", 1)[1]
                       for p in logs.glob("*.txt"))
        out[name] = (len(sink.rows), row, texts)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 1 and len(out["port"][2]) == 2
