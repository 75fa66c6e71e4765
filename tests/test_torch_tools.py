"""The port's engine-driving tools (llmapigateway_tpu_torch/tools/), the
counterparts of the JAX package's tools/profile_{insert,decode,
engine_burst}.py, run end to end on the CPU at a tiny preset and small
dims: every variant reports a time, the decode profiler's ``full`` step
(through the kernels' attention function, as ``--kernels`` runs it) gives
the engine's greedy tokens from the same state, and ``--quant`` is refused
with the ROADMAP item that will bring it. The decode kernels' split sweep
and chip_smoke.py's tree A/B refuse a machine without a card. Times on the
CPU say nothing of the card; the tools run on the card in chip_smoke.py's
tools phase."""
import json

import numpy as np
import pytest
import torch

from llmapigateway_tpu_torch.config.schemas import LocalEngineConfig
from llmapigateway_tpu_torch.engine.engine import InferenceEngine
from llmapigateway_tpu_torch.models.llama import KVCache
from llmapigateway_tpu_torch.ops.flash_attention import (
    make_cache_attention_fn)
from llmapigateway_tpu_torch.tools import (profile_decode,
                                           profile_engine_burst,
                                           profile_insert, profile_split)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_profile_insert_reports_every_cpu_variant(capsys):
    res = profile_insert.main(["--device", "cpu", "--layers", "3",
                               "--batch", "2", "--kv-heads", "2", "--seq",
                               "40", "--head-dim", "16", "--burst", "4",
                               "--reps", "2"])
    # The cuda variant (kernel #5) needs a card; it is not replaced.
    assert set(res["ms_per_step"]) == {"index_put", "onehot", "stacked"}
    assert all(ms > 0 for ms in res["ms_per_step"].values())
    assert res["steps"] == {"index_put": 12, "onehot": 12, "stacked": 12}
    assert _last_json(capsys) == res


def test_insert_bursts_agree_from_the_same_start():
    dims, dev = (3, 2, 2, 40, 16), torch.device("cpu")
    _, steps, k1, v1 = profile_insert.run_scan("index_put", dims, 4, 1, dev)
    _, _, k2, v2 = profile_insert.run_scan("onehot", dims, 4, 1, dev)
    k0, v0, new, lengths = profile_insert.initial_state(*dims, dev)
    assert steps == 8
    for i in range(3):
        assert torch.equal(k1[i], k2[i]) and torch.equal(v1[i], v2[i])
        assert not torch.equal(k1[i], k0[i])
        # Positions 20 .. 23 (lengths 20, four steps) hold the new rows.
        assert torch.equal(k1[i][:, :, 20:24],
                           new.transpose(1, 2).expand(-1, -1, 4, -1))
        assert torch.equal(k1[i][:, :, :20], k0[i][:, :, :20])


def test_profile_decode_reports_every_variant(capsys):
    res = profile_decode.main(["--device", "cpu", "--preset", "tiny-test",
                               "--batch", "2", "--seq", "64", "--burst", "3",
                               "--reps", "1", "--kernels", "--kv-quant"])
    assert set(res) == {"full", "greedy", "nosample", "noinsert", "noattn",
                        "nomlp", "kernels", "weights_stream", "fused_stream",
                        "sort_alone"}
    assert all(ms > 0 for ms in res.values())
    assert _last_json(capsys)["ms_per_step"] == res


def test_decode_kernel_tools_refuse_the_cpu(tmp_path, capsys):
    """The split sweep and the smoke's tree A/B time CUDA kernels: without
    a card they stop with a reason instead of timing a plain version."""
    with pytest.raises(SystemExit, match="CUDA card"):
        profile_split.main(["--device", "cpu"])
    import chip_smoke
    out = tmp_path / "ab.json"
    assert chip_smoke.main(["--decode-ab", chip_smoke.HERE,
                            "--out", str(out)]) != 0
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    assert not out.exists()


def test_prefill_ab_refuses_the_cpu(tmp_path, capsys):
    """The prefill A/B times the prefill kernels of each tree: without a
    card it stops with a reason and writes no report."""
    import chip_smoke
    out = tmp_path / "ab.json"
    assert chip_smoke.main(["--prefill-ab", chip_smoke.HERE, chip_smoke.HERE,
                            "--out", str(out)]) != 0
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    assert not out.exists()


def test_profile_decode_refuses_weight_quantization():
    with pytest.raises(ValueError, match="ROADMAP.md.*weight quantization"):
        profile_decode.main(["--device", "cpu", "--preset", "tiny-test",
                             "--quant"])


@pytest.mark.parametrize("kv", ["contiguous", "paged"])
def test_profile_engine_burst_reports_its_split(kv, capsys):
    res = profile_engine_burst.main(["--device", "cpu", "--preset",
                                     "tiny-test", "--burst", "3", "--kv",
                                     kv])
    assert len(res["decode_burst_ms"]) == 3 and len(res["raw"]) == 3
    assert all(r["enqueue_ms"] > 0 and r["fetch_ms"] >= 0
               for r in res["raw"])
    assert res["chained_ms_per_step"] > 0
    assert res["decode_steps"] == 4 * 3 and res["raw_steps"] == 7 * 3
    assert _last_json(capsys)["kv"] == kv


def test_full_step_gives_the_engine_greedy_tokens():
    """From the same prefilled state, the decode profiler's ``full`` step
    at temperature 0 through ``make_cache_attention_fn`` and the engine's
    own ``_decode_burst`` emit the same tokens."""
    engine = InferenceEngine(LocalEngineConfig(
        preset="tiny-test", kv_layout="contiguous", max_batch_size=2,
        max_seq_len=64, prefill_chunk=16, decode_burst=6), device="cpu")
    rng = np.random.default_rng(7)
    for slot, n in enumerate((9, 14)):
        prompt = rng.integers(0, 512, n).tolist()
        first = engine._exec_prefill([slot], [0], [prompt],
                                     [(0.0, 1.0, 0, 0.0, 0.0)])
        engine.lengths[slot] = n
        engine.active[slot] = True
        engine.last_token[slot] = int(first[0])
    engine._d_dirty = True
    cache = KVCache(k=engine.cache.k.clone(), v=engine.cache.v.clone())
    tokens = torch.from_numpy(engine.last_token.copy())
    lengths = torch.from_numpy(engine.lengths.copy())
    active = torch.ones(2, dtype=torch.bool)

    # Lag-one: the burst's tokens come back at the next dispatch, or here
    # from the flush.
    assert engine._decode_burst(6) == []
    want = np.stack(engine._flush_pending())
    step = profile_decode.make_step(engine.model_cfg, "full",
                                    make_cache_attention_fn())
    samp = profile_decode.sampling_params(2, "cpu", temperature=0.0)
    with torch.no_grad():
        got, _ = profile_decode.decode_burst(
            step, engine.params, cache, tokens, lengths, active, samp,
            torch.Generator().manual_seed(0), 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_synthetic_checkpoint_tool_writes_what_the_jax_tool_writes(
        tmp_path, capsys):
    """The same HF names, shapes and config.json as the JAX tool's, in
    several shards with an index, and the same JSON line."""
    from llmapigateway_tpu.models.config import get_preset as jget_preset
    from llmapigateway_tpu_torch.models.config import get_preset
    from llmapigateway_tpu_torch.tools import make_synthetic_checkpoint as ms
    from llmapigateway_tpu_torch.utils.safetensors_lite import safe_open
    from tools import make_synthetic_checkpoint as jms
    out = tmp_path / "qwen"
    res = ms.main(["--preset", "tiny-qwen-test", "--out", str(out),
                   "--dtype", "bfloat16", "--shard-gb", "0.00005"])
    assert _last_json(capsys) == res
    assert set(res) == {"preset", "out", "dtype", "total_gb", "shards",
                        "gen_s"} and res["shards"] >= 2
    assert json.loads((out / "config.json").read_text()) == \
        jms._config_json(jget_preset("tiny-qwen-test"), "tiny-qwen-test")
    index = json.loads((out / "model.safetensors.index.json").read_text())
    shapes = {}
    for shard in sorted(set(index["weight_map"].values())):
        with safe_open(out / shard) as f:
            for name in f.keys():
                assert index["weight_map"][name] == shard
                shapes[name] = f.shape(name)
                assert f.dtype(name) == torch.bfloat16
    assert shapes == dict(jms._hf_tensors(jget_preset("tiny-qwen-test")))
    assert list(shapes) == [n for n, _ in ms._hf_tensors(
        get_preset("tiny-qwen-test"))]


def test_profile_checkpoint_load_on_the_cpu(tmp_path, capsys):
    from llmapigateway_tpu_torch.tools import (make_synthetic_checkpoint,
                                               profile_checkpoint_load)
    out = tmp_path / "tiny"
    make_synthetic_checkpoint.main(["--preset", "tiny-test", "--out",
                                    str(out), "--shard-gb", "0.0002"])
    res = profile_checkpoint_load.main([str(out), "--device", "cpu",
                                        "--batch", "2", "--seq", "64",
                                        "--tokens", "5", "--kv-quant",
                                        "int8"])
    assert _last_json(capsys) == res
    # tiny-test in bf16: embed and lm_head 512 x 64, two layers.
    n = 2 * 512 * 64 + 64 + 2 * (2 * 64 + 64 * 64 + 2 * 64 * 32
                                 + 64 * 64 + 3 * 64 * 128)
    assert res["bytes_read_gb"] == res["device_param_gb"] == 2 * n / 1e9
    assert res["generated_tokens"] == 5 and res["kv_quant"] == "int8"
    assert res["load_s"] > 0 and res["h2d_gbps"] > 0 and res["card"] is None
    with pytest.raises(ValueError, match="weight quantization"):
        profile_checkpoint_load.main([str(out), "--device", "cpu",
                                      "--quant", "int8"])
