"""Per-request SLO targets and outcomes (counterpart of the JAX package's
``obs/slo.py``).

* :class:`SLOTargets`: a request's TTFT/TPOT targets, from the
  ``x-slo-ttft-ms`` / ``x-slo-tpot-ms`` headers (the client's ask wins) or
  the gateway model rule's ``slo_ttft_ms`` / ``slo_tpot_ms`` fields,
  mirroring the deadline budget's precedence.
* :func:`evaluate`: the outcome, computed at stream end from the engine
  request's timestamps (submit, admitted, first token, done), with a TTFT
  violation attributed to the phase that spent the budget: ``queued``
  (waiting for a slot) or ``prefill`` (admission to first token).

The outcome rides the request's usage block into the usage DB row
(``slo_met`` / ``slo_phase``). The JAX package also splits the prefill
window by the decode bursts its flight recorder saw in it
(``decode_contention``); the port has no flight recorder yet, so it
attributes as the JAX function does without one and
``decode_contention_ms`` is always 0.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

# Attribution phases, in the order the budget is spent. TPOT violations
# are always "decode".
PHASE_QUEUED = "queued"
PHASE_PREFILL = "prefill"
PHASE_DECODE_CONTENTION = "decode_contention"
PHASE_DECODE = "decode"


@dataclass(frozen=True)
class SLOTargets:
    """A request's latency targets in milliseconds; None = no target."""
    ttft_ms: float | None = None
    tpot_ms: float | None = None

    @property
    def defined(self) -> bool:
        return self.ttft_ms is not None or self.tpot_ms is not None


def _positive_ms(raw: Any) -> float | None:
    try:
        val = float(raw)
    except (TypeError, ValueError):
        return None
    return val if val > 0 else None


def slo_from_headers(headers: Any) -> SLOTargets:
    """Parse the client's SLO ask. Invalid or non-positive values are
    ignored: a malformed SLO header must not fail the request (it shapes
    attribution, never admission)."""
    return SLOTargets(
        ttft_ms=_positive_ms(headers.get("x-slo-ttft-ms")),
        tpot_ms=_positive_ms(headers.get("x-slo-tpot-ms")))


def resolve_slo(header_slo: SLOTargets | None, rule: Any) -> SLOTargets:
    """Per-field precedence: client header > gateway-model rule. ``rule``
    is a ModelFallbackConfig (or None); its 0-valued fields mean unset,
    as ``timeout_ms`` does."""
    h = header_slo or SLOTargets()
    rule_ttft = _positive_ms(getattr(rule, "slo_ttft_ms", 0) or 0)
    rule_tpot = _positive_ms(getattr(rule, "slo_tpot_ms", 0) or 0)
    return SLOTargets(ttft_ms=h.ttft_ms if h.ttft_ms is not None
                      else rule_ttft,
                      tpot_ms=h.tpot_ms if h.tpot_ms is not None
                      else rule_tpot)


def evaluate(req: Any, slo: SLOTargets) -> dict[str, Any] | None:
    """SLO outcome for one finished engine request.

    ``req`` is a GenRequest whose lifecycle timestamps are set (t_submit
    always; t_admitted, t_first_token, t_done when the request got that
    far). None when no target is defined; otherwise the targets, the
    measured values, ``met``, and on a violation the attributed ``phase``
    with the per-phase breakdown it was computed from.
    """
    if not slo.defined:
        return None
    out: dict[str, Any] = {}
    if slo.ttft_ms is not None:
        out["ttft_target_ms"] = slo.ttft_ms
    if slo.tpot_ms is not None:
        out["tpot_target_ms"] = slo.tpot_ms

    ttft_ms = None
    if req.t_first_token is not None:
        ttft_ms = 1000.0 * (req.t_first_token - req.t_submit)
        out["ttft_ms"] = round(ttft_ms, 2)
    tpot_ms = None
    n_gen = len(req.generated)
    if (req.t_first_token is not None and req.t_done is not None
            and n_gen > 1 and req.t_done > req.t_first_token):
        tpot_ms = 1000.0 * (req.t_done - req.t_first_token) / (n_gen - 1)
        out["tpot_ms"] = round(tpot_ms, 3)

    phase = None
    if slo.ttft_ms is not None and (
            ttft_ms is None or ttft_ms > slo.ttft_ms):
        # TTFT violated (a request that never produced a token counts as
        # violated). queued = submit → admission; prefill = admission →
        # first token.
        t_admit = req.t_admitted
        t_first = req.t_first_token
        end = t_first if t_first is not None else (
            req.t_done if req.t_done is not None else None)
        queued_ms = (1000.0 * (t_admit - req.t_submit)
                     if t_admit is not None
                     else (1000.0 * (end - req.t_submit) if end else 0.0))
        prefill_ms = (1000.0 * (end - t_admit)
                      if t_admit is not None and end is not None
                      and end > t_admit else 0.0)
        contention_ms = 0.0
        shares = ((queued_ms, PHASE_QUEUED),
                  (prefill_ms, PHASE_PREFILL),
                  (contention_ms, PHASE_DECODE_CONTENTION))
        phase = max(shares)[1]
        out["attribution"] = {
            "queued_ms": round(queued_ms, 2),
            "prefill_ms": round(prefill_ms, 2),
            "decode_contention_ms": round(contention_ms, 2),
        }
    elif slo.tpot_ms is not None and tpot_ms is not None \
            and tpot_ms > slo.tpot_ms:
        phase = PHASE_DECODE

    out["met"] = phase is None
    if phase is not None:
        out["phase"] = phase
    return out
