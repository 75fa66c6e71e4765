"""The port's bench tool (llmapigateway_tpu_torch/tools/bench.py) on the CPU
at ``tiny-test`` size: the one-JSON-line contract (``metric``, ``value``,
``unit``, ``extra``) of the root ``bench.py``, every headline arm, TTFT
under load, and the shared-prefix rung, whose proof that prefill was
skipped comes from the engine's counters; the root bench's rungs the port
cannot serve are refused with their port-queue item named, and the card is
the default device."""
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
    ("--quant-rung", "weight quantization"),
    ("--spec-draft", "speculative decoding"),
    ("--spec-ladder", "speculative decoding"),
    ("--spec-mixed", "speculative decoding"),
    ("--ttft-target", "compiled, pipelined decode step"),
    ("--disagg-ab", "disaggregation, supervision, observability"),
    ("--flight-ab", "disaggregation, supervision, observability"),
    ("--annot-ab", "disaggregation, supervision, observability"),
    ("--failover-ab", "breakers and deadlines, remote providers"),
])
def test_unported_rungs_are_refused(flag, item):
    with pytest.raises(ValueError, match=f"{flag}.*ROADMAP.md.*{item}"):
        bench.main(TINY + [flag, "1"])


def test_the_card_is_the_default_device(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--eight-b", "0"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 0.0 and "no CUDA device" in line["error"]
