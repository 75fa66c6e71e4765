"""The port's refusal of knobs it accepts in the schema but has not
ported: a non-default value raises a ``ValueError`` naming its ROADMAP.md
Queue 1 item, engine knobs at engine build and provider and rule knobs at
config load; what the JAX package itself leaves inert for the configuration
(and the knobs with no meaning off the TPU) stays accepted, and a default
config still builds."""
import json

import pytest

from llmapigateway_tpu_torch.config.loader import ConfigLoader
from llmapigateway_tpu_torch.config.schemas import (ConfigError,
                                                    LocalEngineConfig)
from llmapigateway_tpu_torch.engine.engine import InferenceEngine

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


BREAKERS = "breakers and deadlines"
CASES = [
    # Refused: applied by the JAX engine or router to a local provider.
    ("engine", {"ttft_target_ms": 200.0}, "compiled, pipelined decode step"),
    ("engine", {"supervisor": {"watchdog_ms": 500.0}},
     "disaggregation, supervision, observability"),
    ("engine", {"supervisor": {"max_restarts": 1}},
     "disaggregation, supervision, observability"),
    ("provider", {"breaker": {"enabled": True}}, BREAKERS),
    ("provider", {"breaker": {"failure_threshold": 0.9}}, BREAKERS),
    ("rule", {"rotate_models": "true"}, "rotation"),
    ("rule", {"timeout_ms": 60000}, BREAKERS),
    ("rule", {"slo_ttft_ms": 200}, BREAKERS),
    ("rule", {"slo_tpot_ms": 20}, BREAKERS),
    ("target", {"use_provider_order_as_fallback": True,
                "providers_order": ["Cerebras", "DeepInfra"]},
     "remote providers"),
    # Accepted: inert in the JAX package for this configuration, or with
    # no meaning off the TPU, or the defaults spelled out.
    ("engine", {}, None),
    ("engine", {"ttft_target_ms": 0.0, "supervisor": {}}, None),
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


@pytest.mark.parametrize(
    "where,patch,item", CASES,
    ids=[f"{w}-{'-'.join(p) or 'default'}-{'refused' if i else 'accepted'}"
         for w, p, i in CASES])
def test_unported_knobs_are_refused_and_inert_ones_accepted(
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
    if item:
        with pytest.raises(ValueError, match=f"ROADMAP.md.*{item}") as exc:
            ConfigLoader(tmp_path, "local")
        assert isinstance(exc.value, ConfigError)
    else:
        loader = ConfigLoader(tmp_path, "local")
        assert set(loader.providers) == {"local", "upstream"}
        assert list(loader.rules) == ["gw/model"]
