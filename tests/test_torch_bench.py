"""The port's bench tool (llmapigateway_tpu_torch/tools/bench.py) on the CPU
at ``tiny-test`` size: the one-JSON-line contract (``metric``, ``value``,
``unit``, ``extra``) of the root ``bench.py``, every headline arm, TTFT
under load, and the shared-prefix rung, whose proof that prefill was
skipped comes from the engine's counters, and the weight-quantization
rung's three arms; the root bench's rungs the port cannot serve are
refused with their port-queue item named, and the card is the default
device."""
import json

import pytest
import torch

from llmapigateway_tpu_torch.tools import bench

TINY = ["--device", "cpu", "--preset", "tiny-test", "--batch", "2",
        "--steps", "8", "--warmup", "4", "--seq", "256", "--prompt-len",
        "24", "--burst", "4", "--page-size", "16", "--ttft-probes", "3",
        "--eight-b", "0", "--swa", "0", "--long-ctx", "0",
        "--second-preset", "", "--shared-prefix-len", "64",
        "--shared-prefix-tail", "8", "--shared-prefix-warm", "2"]


def test_cpu_run_prints_the_contract_line(capsys):
    result = bench.main(TINY)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result
    assert set(line) == {"metric", "value", "unit", "extra"}
    assert line["unit"] == "tok/s" and line["value"] > 0
    extra = line["extra"]
    assert extra["device"] == "cpu" and extra["card"] is None
    assert "errors" not in extra, extra.get("errors")
    assert line["value"] == extra["contiguous_bf16"]["tok_s"]
    for arm in ("contiguous_bf16", "contiguous_int8", "paged_bf16",
                "paged_int8"):
        assert extra[arm]["tok_s"] > 0 and extra[arm]["hbm_gbps"] >= 0
    head = extra["contiguous_bf16"]
    assert head["ttft_probes"] == 3
    assert 0 < head["ttft_p50_ms"] <= head["ttft_p95_ms"]
    sp = extra["shared_prefix"]
    assert sp["warm_requests"] == 2 and sp["prefix_tokens"] == 64
    # Prefill was skipped, by the engine's own counts: every warm request
    # ran one prefill call against the cold one's three, hit the cache,
    # and was served its whole prefix (64 tokens each) from it.
    assert sp["cold_prefill_calls"] == 3
    assert sp["warm_prefill_calls_max"] == 1
    assert sp["prefix_hits_total"] == 2
    assert sp["prefix_cached_tokens_total"] == 2 * 64


@pytest.mark.parametrize("flag,item", [
    ("--spec-draft", "speculative decoding"),
    ("--spec-ladder", "speculative decoding"),
    ("--spec-mixed", "speculative decoding"),
    ("--disagg-ab", "disaggregation, supervision, observability"),
    ("--flight-ab", "disaggregation, supervision, observability"),
    ("--annot-ab", "disaggregation, supervision, observability"),
    ("--failover-ab", "disaggregation, supervision, observability"),
])
def test_unported_rungs_are_refused(flag, item):
    with pytest.raises(ValueError, match=f"{flag}.*ROADMAP.md.*{item}"):
        bench.main(TINY + [flag, "1"])


def test_quant_rung_reports_its_three_arms():
    """``--quant-rung``: the headline preset's weights at int8, int8 with
    int8 KV and int4 with int8 KV, contiguous, each against the contiguous
    bf16 arm; int4 also against int8. The quantized arms hold fewer weight
    bytes than bf16 would, int4 fewer than int8."""
    result = bench.main(TINY + ["--quant-rung", "1", "--layout",
                                "contiguous", "--kv", "bf16", "--skip-ttft",
                                "--shared-prefix", "0"])
    extra = result["extra"]
    assert "errors" not in extra, extra.get("errors")
    base = extra["contiguous_bf16"]["tok_s"]
    for arm in ("quant_int8", "quant_int8_kv8", "quant_int4_kv8"):
        r = extra[arm]
        assert r["tok_s"] > 0
        assert r["speedup_vs_bf16"] == round(r["tok_s"] / base, 2)
    int4, int8 = extra["quant_int4_kv8"], extra["quant_int8_kv8"]
    assert int4["speedup_vs_int8"] == round(int4["tok_s"] / int8["tok_s"], 2)
    assert int4["weight_bytes"] < int8["weight_bytes"] == \
        extra["quant_int8"]["weight_bytes"]


def test_ttft_target_rung_runs_the_controller_through_the_scheduler(
        capsys):
    """``--ttft-target``: the arm's engine with ``ttft_target_ms``, decode
    tok/s through the real scheduler, TTFT under load, and the
    controller's own stats (where the bursts ran, the walls it measured);
    on the CPU no graph is captured and every burst runs eagerly."""
    result = bench.main(TINY + ["--ttft-target", "100", "--layout",
                                "contiguous", "--kv", "bf16",
                                "--shared-prefix", "0"])
    extra = result["extra"]
    assert "errors" not in extra, extra.get("errors")
    r = extra["ttft_target"]
    assert r["target_ms"] == 100.0 and r["preset"] == "tiny-test"
    assert r["scheduler_tok_s"] > 0 and r["ttft_probes"] == 3
    assert 0 < r["ttft_p50_ms"] <= r["ttft_p95_ms"]
    # Depths come from the controller's ladder (4, 3, 2, 1 at --burst 4).
    assert r["burst_depth_hist"] and set(r["burst_depth_hist"]) <= {1, 2, 3,
                                                                     4}
    assert isinstance(r["burst_walls_ms"], dict)
    assert r["graphs_captured"] == 0 and r["graph_replays"] == 0


def test_the_card_is_the_default_device(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--eight-b", "0"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 0.0 and "no CUDA device" in line["error"]
