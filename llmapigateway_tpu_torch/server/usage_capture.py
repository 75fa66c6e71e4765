"""Per-request usage capture: the usage ledger, TTFT and tokens/s, and
chat transcripts (counterpart of the JAX package's
``server/usage_capture.py``).

Providers parse their own stream once and feed this observer directly:

* usage extraction including reasoning and cached token details and cost,
  with reasoning subtracted from completion tokens, and the SLO outcome;
* one ledger row per completed attempt, written off the event loop, that
  never breaks serving;
* per-request transcript files ``<logs_dir>/YYYY-MM-DD_HH-MM-SS.mmm.txt``
  with a token/cost header, only when ``LOG_CHAT_MESSAGES`` is on, pruned
  beyond ``LOG_FILE_LIMIT``.
"""
from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from ..db.usage import UsageDB, UsageRecord

logger = logging.getLogger(__name__)


def extract_usage_fields(usage: dict[str, Any]) -> dict[str, Any]:
    """Normalize an OpenAI-style usage object."""
    prompt = int(usage.get("prompt_tokens") or 0)
    completion = int(usage.get("completion_tokens") or 0)
    total = int(usage.get("total_tokens") or (prompt + completion))
    details = usage.get("completion_tokens_details") or {}
    reasoning = int(details.get("reasoning_tokens") or
                    usage.get("reasoning_tokens") or 0)
    pdetails = usage.get("prompt_tokens_details") or {}
    cached = int(pdetails.get("cached_tokens") or usage.get("cached_tokens") or 0)
    cost = float(usage.get("cost") or usage.get("total_cost") or 0.0)
    # Completion tokens are reported net of reasoning tokens.
    completion = max(0, completion - reasoning)
    # SLO outcome block (providers/local.py): persisted so the ledger can
    # answer which requests missed their SLO and why.
    slo = usage.get("slo")
    slo_met = slo_phase = None
    if isinstance(slo, dict) and "met" in slo:
        slo_met = 1 if slo.get("met") else 0
        slo_phase = slo.get("phase")
    return {"prompt_tokens": prompt, "completion_tokens": completion,
            "total_tokens": total, "reasoning_tokens": reasoning,
            "cached_tokens": cached, "cost": cost,
            "slo_met": slo_met, "slo_phase": slo_phase}


def write_transcript(logs_dir: Path, limit: int, request_payload: dict[str, Any],
                     response_text: str, meta: dict[str, Any]) -> None:
    """Write one transcript file and prune beyond `limit` (blocking; callers
    offload to a thread)."""
    try:
        logs_dir.mkdir(parents=True, exist_ok=True)
        now = time.time()
        stamp = time.strftime("%Y-%m-%d_%H-%M-%S", time.localtime(now))
        name = f"{stamp}.{int((now % 1) * 1000):03d}.txt"
        lines = ["=== LLM Gateway chat transcript ==="]
        for k, v in meta.items():
            lines.append(f"{k}: {v}")
        lines.append("\n--- request messages ---")
        for msg in request_payload.get("messages", []) or []:
            role = msg.get("role", "?") if isinstance(msg, dict) else "?"
            content = msg.get("content", "") if isinstance(msg, dict) else str(msg)
            lines.append(f"[{role}] {content}")
        lines.append("\n--- assistant response ---")
        lines.append(response_text)
        (logs_dir / name).write_text("\n".join(lines))
        # Prune the oldest transcripts beyond the cap.
        transcripts = sorted(p for p in logs_dir.glob("*.txt"))
        for p in transcripts[:-limit] if limit > 0 else []:
            p.unlink(missing_ok=True)
    except OSError:
        logger.exception("transcript write failed (ignored)")


@dataclass
class UsageCollector:
    """One attempt's observer. Only a completed stream records usage."""
    provider: str
    model: str
    usage_db: UsageDB | None = None
    request_payload: dict[str, Any] = field(default_factory=dict)
    logs_dir: Path | None = None
    log_chat_messages: bool = False
    log_file_limit: int = 15

    _t_start: float = field(default_factory=time.monotonic)
    _t_first: float | None = None
    _t_end: float | None = None
    _text: list[str] = field(default_factory=list)
    _usage: dict[str, Any] | None = None
    _ended: bool = False

    # -- observer protocol ----------------------------------------------------
    def on_first_token(self) -> None:
        if self._t_first is None:
            self._t_first = time.monotonic()

    def on_content_delta(self, text: str) -> None:
        if text:
            self._text.append(text)

    def on_usage(self, usage: dict[str, Any]) -> None:
        self._usage = usage

    def on_stream_end(self, error: str | None = None) -> None:
        if self._ended:
            return
        self._ended = True
        self._t_end = time.monotonic()
        # SQLite fsync + transcript write/prune are blocking I/O; offload so a
        # stream's finally-block never stalls the event loop.
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if loop is not None:
            loop.run_in_executor(None, self._record_safe, error)
        else:
            self._record_safe(error)

    # -- recording ------------------------------------------------------------
    def _record_safe(self, error: str | None) -> None:
        try:
            self._record(error)
        except Exception:
            logger.exception("usage record failed (ignored)")

    @property
    def ttft_ms(self) -> float | None:
        if self._t_first is None:
            return None
        return (self._t_first - self._t_start) * 1000.0

    def _record(self, error: str | None) -> None:
        fields = extract_usage_fields(self._usage or {})
        completion_tokens = fields["completion_tokens"] + fields["reasoning_tokens"]
        tps = None
        if self._t_first is not None and self._t_end is not None \
                and completion_tokens > 1 and self._t_end > self._t_first:
            tps = (completion_tokens - 1) / (self._t_end - self._t_first)

        rec = UsageRecord(model=self.model, provider=self.provider,
                          ttft_ms=self.ttft_ms, tokens_per_sec=tps, **fields)
        if self.usage_db is not None and (self._usage or self._text):
            self.usage_db.insert(rec)

        if self.log_chat_messages and self.logs_dir is not None:
            meta = {"provider": self.provider, "model": self.model,
                    "prompt_tokens": fields["prompt_tokens"],
                    "completion_tokens": fields["completion_tokens"],
                    "reasoning_tokens": fields["reasoning_tokens"],
                    "cached_tokens": fields["cached_tokens"],
                    "cost": fields["cost"],
                    "ttft_ms": self.ttft_ms, "tokens_per_sec": tps,
                    "error": error or ""}
            write_transcript(self.logs_dir, self.log_file_limit,
                             self.request_payload, "".join(self._text), meta)
