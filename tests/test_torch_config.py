"""The port's refusal of knobs it accepts in the schema but has not
ported: a non-default value raises a ``ValueError`` naming its ROADMAP.md
Queue 1 item at engine build; what the JAX package itself leaves inert for
the configuration (and the knobs with no meaning off the TPU) stays
accepted, and a default config still builds. The provider and rule knobs
of the gateway around the engine (breaker, deadline, SLO, rotation and
sub-provider knobs) build and are applied to a chain with a local
target."""
import json

import pytest

from llmapigateway_tpu_torch.config.loader import ConfigLoader
from llmapigateway_tpu_torch.config.schemas import (ConfigError,
                                                    LocalEngineConfig)
from llmapigateway_tpu_torch.db.rotation import RotationDB
from llmapigateway_tpu_torch.engine.engine import InferenceEngine
from llmapigateway_tpu_torch.obs.slo import resolve_slo
from llmapigateway_tpu_torch.providers.base import (CompletionError,
                                                    NullUsageObserver,
                                                    Provider)
from llmapigateway_tpu_torch.reliability.breaker import BreakerRegistry
from llmapigateway_tpu_torch.routing.router import Router

ENGINE = dict(preset="tiny-test", kv_layout="paged", kv_page_size=16,
              prefix_cache=False, max_batch_size=2, max_seq_len=64,
              prefill_chunk=16, dtype="float32")


def _files(tmp_path, where, patch):
    """providers.json (a local engine and a remote upstream) and a rule
    file whose rule "gw/model" chains the local engine first and the
    upstream second (``"rule"``), or the local engine alone
    (``"rule-one"``), or the upstream alone (``"rule-remote"``); ``patch``
    goes onto the local provider (``"provider"``), the rule, or its local
    target (``"target"``)."""
    local = {"type": "local", "engine": ENGINE}
    upstream = {"baseUrl": "http://127.0.0.1:1/v1", "apikey": "K"}
    if where == "provider":
        local.update(patch)
    if where == "provider-remote":
        upstream.update(patch)
    target = {"provider": "local", "model": "tiny"}
    if where == "target":
        target.update(patch)
    chain = {"rule-one": [target],
             "rule-remote": [{"provider": "upstream", "model": "x"},
                             {"provider": "upstream", "model": "y"}]}.get(
        where, [target, {"provider": "upstream", "model": "x"}])
    rule = {"gateway_model_name": "gw/model", "fallback_models": chain}
    if where.startswith("rule"):
        rule.update(patch)
    (tmp_path / "providers.json").write_text(json.dumps(
        [{"local": local}, {"upstream": upstream}]))
    (tmp_path / "models_fallback_rules.json").write_text(json.dumps([rule]))


APPLIED = "applied"
CASES = [
    # Refused: applied by the JAX engine to a local provider.
    ("engine", {"supervisor": {"watchdog_ms": 500.0}},
     "disaggregation, supervision, observability"),
    ("engine", {"supervisor": {"max_restarts": 1}},
     "disaggregation, supervision, observability"),
    # Applied: each builds, and the router or breaker registry applies it
    # to the local target (the ids of these cases keep the tag "refused").
    ("provider", {"breaker": {"enabled": True}}, APPLIED),
    ("provider", {"breaker": {"failure_threshold": 0.9}}, APPLIED),
    ("rule", {"rotate_models": "true"}, APPLIED),
    ("rule", {"timeout_ms": 60000}, APPLIED),
    ("rule", {"slo_ttft_ms": 200}, APPLIED),
    ("rule", {"slo_tpot_ms": 20}, APPLIED),
    ("target", {"use_provider_order_as_fallback": True,
                "providers_order": ["Cerebras", "DeepInfra"]}, APPLIED),
    # Accepted: inert in the JAX package for this configuration, or with
    # no meaning off the TPU, or the defaults spelled out.
    ("engine", {}, None),
    ("engine", {"ttft_target_ms": 0.0, "supervisor": {}}, None),
    # The burst-depth controller, ported with the compiled, pipelined
    # decode step.
    ("engine", {"ttft_target_ms": 200.0}, None),
    ("engine", {"compilation_cache_dir": "xla-cache"}, None),
    ("engine", {"debug_nans": True}, None),
    ("engine", {"prewarm_sampler_variants": False}, None),
    ("engine", {"profile_annotations": False}, None),
    ("provider", {}, None),
    ("provider", {"breaker": {"enabled": False}}, None),
    ("provider-remote", {"breaker": {"enabled": True}}, None),
    ("rule-one", {"rotate_models": True}, None),
    ("rule-remote", {"rotate_models": True, "timeout_ms": 60000}, None),
    ("target", {"providers_order": ["Cerebras", "DeepInfra"]}, None),
    ("target", {"use_provider_order_as_fallback": True}, None),
    ("target", {"custom_headers": {"X-Title": "my-gateway"}}, None),
]


class _Failing(Provider):
    """A local target that fails every attempt; counts its calls."""

    def __init__(self) -> None:
        self.name = "local"
        self.calls = 0

    async def complete(self, request, observer):
        self.calls += 1
        return None, CompletionError("scripted failure", status=500)


class _Registry:
    def __init__(self, providers):
        self.providers = providers

    async def get(self, name):
        return self.providers.get(name)


async def _check_applied(tmp_path, loader, where, patch) -> None:
    """The knob reaches the local target through the router or the
    breaker registry, as in the JAX router."""
    rotation = RotationDB(tmp_path / "db")
    try:
        await _check_router(loader, rotation, where, patch)
    finally:
        rotation.close()


async def _check_router(loader, rotation, where, patch) -> None:
    rule = loader.rules["gw/model"]
    local = _Failing()
    router = Router(loader, _Registry({"local": local}), rotation,
                    fallback_provider="local",
                    breakers=BreakerRegistry(loader))
    if where == "provider":
        breaker = BreakerRegistry(loader).get("local")
        for key, value in patch["breaker"].items():
            assert getattr(breaker.cfg, key) == value
        assert breaker.cfg.enabled
    elif "rotate_models" in patch:
        orders = [[t.provider for t in await router._ordered_targets(
            rule, "key")] for _ in range(3)]
        assert orders == [["local", "upstream"], ["upstream", "local"],
                          ["local", "upstream"]]
    elif "timeout_ms" in patch:
        assert router._start_deadline(rule, None).budget_s == 60.0
    elif "slo_ttft_ms" in patch or "slo_tpot_ms" in patch:
        slo = resolve_slo(None, rule)
        assert (slo.ttft_ms, slo.tpot_ms) == (patch.get("slo_ttft_ms"),
                                              patch.get("slo_tpot_ms"))
    else:
        # One attempt per listed sub-provider, then the chain moves on.
        out = await router.dispatch({"model": "gw/model", "messages": []},
                                    "key", lambda p, m: NullUsageObserver())
        assert local.calls == 2 and out.attempts == 2


@pytest.mark.parametrize(
    "where,patch,item", CASES,
    ids=[f"{w}-{'-'.join(p) or 'default'}-{'refused' if i else 'accepted'}"
         for w, p, i in CASES])
async def test_unported_knobs_are_refused_and_inert_ones_accepted(
        tmp_path, where, patch, item):
    if where == "engine":
        cfg = LocalEngineConfig(**{**ENGINE, **patch})
        if item:
            with pytest.raises(ValueError, match=f"ROADMAP.md.*{item}"):
                InferenceEngine(cfg, device="cpu")
        else:
            assert InferenceEngine(cfg, device="cpu").paged
        return
    _files(tmp_path, where, patch)
    loader = ConfigLoader(tmp_path, "local")
    assert set(loader.providers) == {"local", "upstream"}
    assert list(loader.rules) == ["gw/model"]
    if item == APPLIED:
        await _check_applied(tmp_path, loader, where, patch)


def test_refusals_are_config_errors():
    """Every refusal still raised is a ValueError and a ConfigError."""
    with pytest.raises(ConfigError):
        InferenceEngine(LocalEngineConfig(
            **{**ENGINE, "supervisor": {"watchdog_ms": 1.0}}), device="cpu")
