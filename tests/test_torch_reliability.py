"""The port's reliability layer against the JAX package's on the same
inputs, with injected clocks and no sleeps: circuit-breaker state traces
and snapshots, failure classification, deadline budgets and their
transport timeouts, and SLO targets and outcomes."""
from types import SimpleNamespace

import httpx
import pytest

from llmapigateway_tpu.config.schemas import BreakerSettings as JSettings
from llmapigateway_tpu.obs import slo as jslo
from llmapigateway_tpu.providers.base import CompletionError as JError
from llmapigateway_tpu.providers.remote_http import (
    deadline_timeout as jdeadline_timeout)
from llmapigateway_tpu.reliability import breaker as jbreaker
from llmapigateway_tpu.reliability import deadline as jdeadline
from llmapigateway_tpu_torch.config.schemas import BreakerSettings
from llmapigateway_tpu_torch.obs import slo as tslo
from llmapigateway_tpu_torch.providers.base import CompletionError
from llmapigateway_tpu_torch.providers.remote_http import deadline_timeout
from llmapigateway_tpu_torch.reliability import breaker as tbreaker
from llmapigateway_tpu_torch.reliability import deadline as tdeadline


class FakeClock:
    def __init__(self) -> None:
        self.t = 500.0

    def __call__(self) -> float:
        return self.t


F, S = "fail", "ok"
# (breaker settings, events): an event is "allow", "ok", "fail",
# "release" or a float (seconds the clock moves).
BREAKER_CASES = {
    "opens-at-threshold-then-probe-closes": (
        dict(min_requests=3, failure_threshold=0.5, cooldown_s=5.0,
             window_s=10.0),
        [S, F, 1.0, F, "allow", 2.0, "allow", 5.0, "allow", "allow", S,
         "allow", F]),
    "probe-fails-reopens-then-window-ages-out": (
        dict(min_requests=2, failure_threshold=1.0, cooldown_s=3.0,
             window_s=4.0),
        [F, F, "allow", 3.0, "allow", F, 1.0, "allow", 2.5, "allow", S,
         F, 5.0, F, "allow"]),
    "released-probe-is-taken-again": (
        dict(min_requests=1, failure_threshold=0.5, cooldown_s=1.0,
             window_s=30.0),
        [F, 1.0, "allow", "allow", "release", "allow", "release", "release",
         "allow", S]),
    "disabled-never-opens": (
        dict(enabled=False, min_requests=1, failure_threshold=0.1),
        [F, F, F, "allow", 100.0, "allow", S]),
    "defaults-five-requests": (
        {}, [F, S, F, F, "allow", F, "allow", 14.9, "allow", 0.2, "allow",
             "allow", F, 29.0, "allow"]),
}


def _trace(mod, settings_cls, cfg: dict, events: list) -> list:
    clock = FakeClock()
    br = mod.CircuitBreaker("p", settings_cls(**cfg), clock=clock)
    trace = []
    for ev in events:
        out = None
        if isinstance(ev, float):
            clock.t += ev
        elif ev == "allow":
            out = br.allow()
        elif ev == "release":
            br.release_probe()
        elif ev == S:
            br.record_success()
        else:
            br.record_failure()
        trace.append((ev, out, br.state, br.cooldown_remaining(),
                      br.failure_rate(), br.snapshot()))
    return trace


@pytest.mark.parametrize("name", list(BREAKER_CASES))
def test_breaker_state_traces_match_jax(name):
    cfg, events = BREAKER_CASES[name]
    want = _trace(jbreaker, JSettings, cfg, events)
    got = _trace(tbreaker, BreakerSettings, cfg, events)
    assert got == want
    states = {t[2] for t in got}
    if name.startswith("disabled"):
        assert states == {"closed"}
    else:
        assert "open" in states


def test_breaker_registry_defaults_and_rebuild_match_jax():
    """Every provider gets a breaker (defaults without a ``breaker``
    block); a changed block rebuilds it, an unchanged one keeps its
    window."""
    def loader(blocks):
        return SimpleNamespace(providers={
            name: SimpleNamespace(breaker=block)
            for name, block in blocks.items()})
    for mod, cls in ((jbreaker, JSettings), (tbreaker, BreakerSettings)):
        blocks = {"a": None, "b": cls(min_requests=1)}
        reg = mod.BreakerRegistry(loader(blocks), clock=FakeClock())
        a, b = reg.get("a"), reg.get("b")
        assert a.cfg == cls() and b.cfg.min_requests == 1
        b.record_failure()
        assert reg.get("b") is b and b.state == "open"
        blocks["b"] = cls(min_requests=2)
        reg._loader = loader(blocks)
        assert reg.get("b") is not b and reg.get("b").state == "closed"
        assert reg.get("unknown").cfg == cls()
    assert (tbreaker.BreakerRegistry(loader({"a": None})).snapshot()
            == jbreaker.BreakerRegistry(loader({"a": None})).snapshot() == {})


@pytest.mark.parametrize("error", [
    None, dict(detail="x"), dict(detail="x", status=500),
    dict(detail="x", status=503, kind="overload"),
    dict(detail="x", kind="timeout"), dict(detail="x", status=429),
    dict(detail="x", status=400), dict(detail="x", status=404),
    dict(detail="x", status=200)])
def test_breaker_failure_classification_matches_jax(error):
    got = tbreaker.counts_as_breaker_failure(
        None if error is None else CompletionError(**error))
    want = jbreaker.counts_as_breaker_failure(
        None if error is None else JError(**error))
    assert got == want


@pytest.mark.parametrize("headers,body", [
    ({}, {}),
    ({"x-request-timeout-ms": "1500"}, {"timeout_ms": 99}),
    ({}, {"timeout_ms": 2500}),
    ({}, {"timeout_ms": "250.5"}),
    ({"x-request-timeout-ms": "abc"}, {"timeout_ms": 10}),
    ({}, {"timeout_ms": -5}),
    ({}, {"timeout_ms": 0}),
    ({}, {"timeout_ms": None}),
    ({}, {"timeout_ms": 3_600_001}),
    ({"x-request-timeout-ms": "3600000"}, {}),
    ({}, {"timeout_ms": [1]}),
])
def test_deadline_budget_from_request_matches_jax(headers, body):
    jpayload = {"model": "m", **body}
    tpayload = {"model": "m", **body}
    want = jdeadline.budget_ms_from_request(headers, jpayload)
    assert tdeadline.budget_ms_from_request(headers, tpayload) == want
    assert tpayload == jpayload and "timeout_ms" not in tpayload


@pytest.mark.parametrize("budget_s", [0.2, 2.0, 500.0])
def test_deadline_and_its_transport_timeout_match_jax(budget_s):
    jclock, tclock = FakeClock(), FakeClock()
    jd = jdeadline.Deadline(budget_s, clock=jclock)
    td = tdeadline.Deadline(budget_s, clock=tclock)
    for step in (0.0, 0.1, 0.15, 1.0, 100.0, 1000.0):
        jclock.t += step
        tclock.t += step
        assert (td.elapsed(), td.remaining(), td.expired()) == (
            jd.elapsed(), jd.remaining(), jd.expired())
        assert td.clamp(0.5) == jd.clamp(0.5)
        # httpx's read/connect caps are aiohttp's per-read/connect caps.
        jt, tt = jdeadline_timeout(jd), deadline_timeout(td)
        assert (tt.sock_read, tt.sock_connect) == (jt.read, jt.connect)
        assert tt.total is None
    jt, tt = jdeadline_timeout(None), deadline_timeout(None)
    assert isinstance(jt, httpx.Timeout)
    assert (tt.sock_read, tt.sock_connect) == (jt.read, jt.connect)


@pytest.mark.parametrize("headers,rule", [
    ({}, None),
    ({"x-slo-ttft-ms": "200"}, None),
    ({"x-slo-ttft-ms": "oops", "x-slo-tpot-ms": "-1"},
     SimpleNamespace(slo_ttft_ms=300.0, slo_tpot_ms=0.0)),
    ({"x-slo-tpot-ms": "25"},
     SimpleNamespace(slo_ttft_ms=300.0, slo_tpot_ms=40.0)),
])
def test_slo_targets_match_jax(headers, rule):
    jh, th = jslo.slo_from_headers(headers), tslo.slo_from_headers(headers)
    assert (th.ttft_ms, th.tpot_ms) == (jh.ttft_ms, jh.tpot_ms)
    jr, tr = jslo.resolve_slo(jh, rule), tslo.resolve_slo(th, rule)
    assert (tr.ttft_ms, tr.tpot_ms, tr.defined) == (
        jr.ttft_ms, jr.tpot_ms, jr.defined)


def _req(submit, admitted, first, done, n_gen):
    return SimpleNamespace(t_submit=submit, t_admitted=admitted,
                           t_first_token=first, t_done=done,
                           generated=[0] * n_gen)


@pytest.mark.parametrize("req,targets", [
    (_req(0.0, 0.01, 0.05, 0.5, 10), (100.0, 60.0)),    # met
    (_req(0.0, 0.2, 0.25, 0.5, 10), (100.0, None)),     # queued
    (_req(0.0, 0.01, 0.3, 0.5, 10), (100.0, None)),     # prefill
    (_req(0.0, 0.01, 0.05, 2.0, 10), (None, 60.0)),     # decode
    (_req(0.0, None, None, 0.4, 0), (100.0, None)),     # never a token
    (_req(0.0, None, None, None, 0), (100.0, 5.0)),
    (_req(0.0, 0.0, 0.0, 0.0, 1), (None, None)),        # no target
])
def test_slo_outcome_matches_jax_without_a_flight_recorder(req, targets):
    ttft, tpot = targets
    want = jslo.evaluate(req, jslo.SLOTargets(ttft, tpot), None)
    assert tslo.evaluate(req, tslo.SLOTargets(ttft, tpot)) == want
