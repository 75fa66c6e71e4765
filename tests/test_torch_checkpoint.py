"""The port's checkpoint path held to the JAX package's on the same files:
its safetensors reader (utils/safetensors_lite.py) to the ``safetensors``
package, bit for bit; its loader (engine/checkpoint.py) to the JAX
``load_checkpoint``, leaf for leaf with ``torch.equal``, on tiny
checkpoints of the llama, qwen2 (QKV biases), phi3 (fused qkv and gate_up)
and gemma (tied embeddings) shapes; its ``_config_from_checkpoint`` to the
JAX one field by field; both loaders refusing the same bad checkpoints;
and an engine built from ``model_path`` streaming greedily what the same
engine streams with the JAX-loaded params, held by the JAX model. The
checkpoints are written here, by the port's synthetic-checkpoint tool or
its writer."""
import asyncio
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open as st_safe_open
from safetensors.torch import save_file as st_save_file

from llmapigateway_tpu.engine import checkpoint as jck
from llmapigateway_tpu.engine.engine import \
    _config_from_checkpoint as j_config_from_checkpoint
from llmapigateway_tpu.models.config import get_preset as jget_preset
from llmapigateway_tpu_torch.config.schemas import LocalEngineConfig
from llmapigateway_tpu_torch.engine import checkpoint as tck
from llmapigateway_tpu_torch.engine.engine import GenRequest, InferenceEngine
from llmapigateway_tpu_torch.models.config import get_preset
from llmapigateway_tpu_torch.models.convert import params_from_jax
from llmapigateway_tpu_torch.tools import make_synthetic_checkpoint as synth
from llmapigateway_tpu_torch.utils import safetensors_lite as stl
from test_torch_engine import (GEOMETRY, PROMPTS, assert_jax_model_greedy,
                               one_torch_thread)

assert one_torch_thread                  # the module-wide fixture, imported

JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def write_checkpoint(path, preset, dtype="float32", shard_gb=0.0002,
                     fuse=False, drop=()):
    """A checkpoint of ``preset`` by the port's tool (several shards and an
    index at the default size). ``fuse``: rewritten the Phi-3 way (fused
    qkv_proj and gate_up_proj, ``model_type`` phi3) in one shard by the
    port's writer. ``drop``: names whose tensors are left out."""
    synth.main(["--preset", preset, "--out", str(path), "--dtype", dtype,
                "--shard-gb", str(shard_gb), "--seed", "3"])
    if not (fuse or drop):
        return path
    tensors = {}
    for f in sorted(path.glob("model-*.safetensors")):
        with stl.safe_open(f) as sf:
            tensors.update({n: sf.get_tensor(n).clone() for n in sf.keys()})
        f.unlink()
    (path / "model.safetensors.index.json").unlink()
    if fuse:
        for i in range(get_preset(preset).n_layers):
            p = f"model.layers.{i}."
            tensors[p + "self_attn.qkv_proj.weight"] = torch.cat([
                tensors.pop(p + f"self_attn.{x}_proj.weight")
                for x in "qkv"])
            tensors[p + "mlp.gate_up_proj.weight"] = torch.cat([
                tensors.pop(p + f"mlp.{x}_proj.weight")
                for x in ("gate", "up")])
        cfg = json.loads((path / "config.json").read_text())
        (path / "config.json").write_text(json.dumps(
            {**cfg, "model_type": "phi3"}))
    stl.save_file({n: t for n, t in tensors.items()
                   if not any(d in n for d in drop)},
                  path / "model.safetensors")
    return path


def assert_trees_equal(want, got, path=""):
    assert set(want) == set(got), path
    for key in want:
        if isinstance(want[key], dict):
            assert_trees_equal(want[key], got[key], f"{path}{key}.")
        else:
            assert got[key].dtype == want[key].dtype, path + key
            assert torch.equal(got[key], want[key]), path + key


# -- the reader ------------------------------------------------------------

def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        # 5 F16 elements put the F32 tensor after them at an offset of 10
        # bytes past the header: not a multiple of 4.
        "odd.f16": torch.randn(5, generator=g).half(),
        "mis.f32": torch.randn(3, 7, generator=g),
        "w.bf16": torch.randn(9, 4, generator=g).bfloat16(),
        "scalar.f32": torch.tensor(2.5),
        "empty.f32": torch.zeros(0, 3),
    }


def test_reader_is_bit_exact_to_safetensors_on_both_writers(tmp_path):
    tensors = _tensors()
    ours, theirs = tmp_path / "ours.safetensors", tmp_path / "st.safetensors"
    stl.save_file(tensors, ours, metadata={"format": "pt"})
    st_save_file(tensors, str(theirs), metadata={"format": "pt"})
    with stl.safe_open(ours) as f:
        begins = {n: f._entries[n][2] - f._data_start for n in f.keys()}
        assert begins["mis.f32"] % 4 != 0     # misaligned, read all the same
    for path in (ours, theirs):
        with st_safe_open(str(path), framework="pt") as ref, \
                stl.safe_open(path) as f:
            assert sorted(f.keys()) == sorted(ref.keys())
            assert f.metadata() == ref.metadata() == {"format": "pt"}
            for name in ref.keys():
                want = ref.get_tensor(name)
                got = f.get_tensor(name)
                assert got.dtype == want.dtype and torch.equal(got, want)
                assert f.shape(name) == tuple(want.shape)
            rows = f.get_rows("w.bf16", 2, 7, out=torch.empty(
                1024, dtype=torch.uint8))
            assert torch.equal(rows, tensors["w.bf16"][2:7])


def test_reader_refuses_other_dtypes_and_bad_files(tmp_path):
    st_save_file({"q": torch.zeros(4, dtype=torch.int8)},
                 str(tmp_path / "i8.safetensors"))
    with pytest.raises(stl.SafetensorsError, match="'I8'"):
        stl.safe_open(tmp_path / "i8.safetensors")
    stl.save_file(_tensors(), tmp_path / "cut.safetensors")
    raw = (tmp_path / "cut.safetensors").read_bytes()
    (tmp_path / "cut.safetensors").write_bytes(raw[:-8])
    with pytest.raises(stl.SafetensorsError, match="data_offsets"):
        stl.safe_open(tmp_path / "cut.safetensors")
    stl.save_file(_tensors(), tmp_path / "ok.safetensors")
    with stl.safe_open(tmp_path / "ok.safetensors") as f, \
            pytest.raises(stl.SafetensorsError, match="rows"):
        f.get_rows("w.bf16", 3, 10)


# -- the loader ------------------------------------------------------------

LOAD_CASES = [
    # (case, preset, checkpoint dtype, load dtype, fused)
    ("llama", "tiny-test", "float32", torch.bfloat16, False),
    ("qwen2", "tiny-qwen-test", "bfloat16", torch.float32, False),
    ("phi3", "tiny-mistral-test", "float32", torch.float32, True),
    ("gemma", "tiny-gemma-test", "bfloat16", torch.bfloat16, False),
]


@pytest.mark.parametrize("case,preset,ck_dtype,dtype,fuse", LOAD_CASES,
                         ids=[c[0] for c in LOAD_CASES])
def test_loader_matches_jax_loader(tmp_path, monkeypatch, case, preset,
                                   ck_dtype, dtype, fuse):
    path = write_checkpoint(tmp_path / case, preset, ck_dtype, fuse=fuse)
    jcfg = j_config_from_checkpoint(str(path))
    tcfg = tck._config_from_checkpoint(path)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    # Runs of 3000 bytes: every tensor but the norms spans several runs,
    # and a fused tensor's runs cross its projections' bounds.
    monkeypatch.setattr(tck, "CHUNK_BYTES", 3000)
    got = tck.load_checkpoint(path, tcfg, dtype=dtype)
    want = params_from_jax(jax.tree.map(
        np.asarray, jck.load_checkpoint(path, jcfg, dtype=JAX_DTYPES[dtype])))
    assert_trees_equal(want, got)
    if tcfg.tie_embeddings:
        assert got["lm_head"] is got["embed"]          # the tensor itself
    else:
        assert got["lm_head"].data_ptr() != got["embed"].data_ptr()


def _config(model_type, **extra):
    return {"model_type": model_type, "vocab_size": 320, "hidden_size": 96,
            "num_hidden_layers": 3, "num_attention_heads": 6,
            "num_key_value_heads": 2, "intermediate_size": 160,
            "rope_theta": 5e5, "rms_norm_eps": 1e-6,
            "max_position_embeddings": 2048, **extra}


CONFIG_CASES = {
    "llama-rope-scaling": _config("llama", rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}),
    "llama-linear-tied": _config("llama", tie_word_embeddings=True,
                                 rope_scaling={"type": "linear",
                                               "factor": 2.0}),
    "llama-defaults": {k: v for k, v in _config("llama").items()
                       if k not in ("rope_theta", "rms_norm_eps",
                                    "num_key_value_heads", "model_type")},
    "mistral": _config("mistral", head_dim=32, sliding_window=None,
                       rope_scaling={"rope_type": "default"}),
    "mistral-window": _config("mistral", sliding_window=512),
    "qwen2": _config("qwen2", tie_word_embeddings=True),
    "phi3": _config("phi3", sliding_window=2047),
    "gemma": _config("gemma", head_dim=48),
    "mixtral": _config("mixtral", num_local_experts=4,
                       num_experts_per_tok=2),
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_config_from_checkpoint_matches_jax(tmp_path, case):
    (tmp_path / "config.json").write_text(json.dumps(CONFIG_CASES[case]))
    jcfg = j_config_from_checkpoint(str(tmp_path))
    tcfg = tck._config_from_checkpoint(tmp_path)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def test_both_refuse_longrope(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(_config(
        "phi3", rope_scaling={"type": "longrope", "factor": 4.0})))
    with pytest.raises(ValueError, match="longrope"):
        j_config_from_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="longrope"):
        tck._config_from_checkpoint(tmp_path)


BAD_CASES = {
    # A fused checkpoint read with one KV head fewer than it was written
    # with: its qkv rows do not split as the config says.
    "fused-rows": ("tiny-mistral-test", True, (), {"n_kv_heads": 1},
                   "fused tensor"),
    "missing-qwen2-bias": ("tiny-qwen-test", False, ("_proj.bias",), {},
                           "missing layer params"),
    "shape": ("tiny-test", False, (), {"vocab_size": 256},
              "checkpoint/config mismatch: embed"),
}


@pytest.mark.parametrize("case", sorted(BAD_CASES))
def test_both_loaders_refuse_a_bad_checkpoint(tmp_path, case):
    preset, fuse, drop, change, match = BAD_CASES[case]
    path = write_checkpoint(tmp_path / case, preset, fuse=fuse, drop=drop)
    jcfg = dataclasses.replace(jget_preset(preset), **change)
    tcfg = dataclasses.replace(get_preset(preset), **change)
    with pytest.raises(ValueError, match=match):
        jck.load_checkpoint(path, jcfg, dtype=jnp.float32)
    with pytest.raises(ValueError, match=match):
        tck.load_checkpoint(path, tcfg, dtype=torch.float32)


# -- the engine --------------------------------------------------------------

async def _greedy(eng, max_tokens=12):
    reqs = [GenRequest(prompt_ids=list(p), max_tokens=max_tokens)
            for p in PROMPTS]
    for r in reqs:
        await eng.submit(r)
    for r in reqs:
        async for _ in eng.stream(r):
            pass
    return [r.generated for r in reqs]


async def test_engine_from_model_path_streams_the_jax_loaded_model(
        tmp_path):
    path = write_checkpoint(tmp_path / "tiny", "tiny-test")
    # JAX work runs in a thread: its compiles would stall the shared loop.
    jparams = await asyncio.to_thread(lambda: jax.tree.map(
        np.asarray, jck.load_checkpoint(
            path, j_config_from_checkpoint(str(path)), dtype=jnp.float32)))
    from_path = InferenceEngine(LocalEngineConfig(
        **{**GEOMETRY, "preset": None, "model_path": str(path)}),
        device="cpu")
    injected = InferenceEngine(LocalEngineConfig(**GEOMETRY), device="cpu")
    injected.params = params_from_jax(jparams)
    try:
        assert from_path.model_cfg == get_preset("tiny-test")
        assert_trees_equal(injected.params, from_path.params)
        streams = await _greedy(from_path)
        assert streams == await _greedy(injected)
        assert all(len(s) == 12 for s in streams)
        await asyncio.to_thread(assert_jax_model_greedy, jparams, GEOMETRY,
                                PROMPTS, streams)
    finally:
        await from_path.stop()
        await injected.stop()


def test_refusals_come_before_any_tensor_is_read(tmp_path, monkeypatch):
    """An unbuilt head width on the card (tiny-test's heads are 16 wide) or
    a refused knob fails the build before the checkpoint is read."""
    path = write_checkpoint(tmp_path / "tiny", "tiny-test")

    def no_read(*a, **kw):
        raise AssertionError("a tensor was read")
    monkeypatch.setattr(stl.SafeFile, "get_rows", no_read)
    monkeypatch.setattr(stl.SafeFile, "get_tensor", no_read)
    with pytest.raises(ValueError, match="cannot run on the card"):
        InferenceEngine(LocalEngineConfig(model_path=str(path)),
                        device="cuda")
    with pytest.raises(ValueError, match="weight quantization"):
        InferenceEngine(LocalEngineConfig(model_path=str(path), quant="int8"),
                        device="cpu")


@pytest.mark.parametrize("package", ["tokenizers", "jinja2"])
def test_a_tokenizer_json_without_its_package_fails_the_build(
        tmp_path, monkeypatch, package):
    path = write_checkpoint(tmp_path / "tiny", "tiny-test")
    (path / "tokenizer.json").write_text("{}")
    monkeypatch.setitem(sys.modules, package, None)
    with pytest.raises(RuntimeError, match=f"needs the '{package}' package"):
        InferenceEngine(LocalEngineConfig(**{**GEOMETRY, "preset": None,
                                             "model_path": str(path)}),
                        device="cpu")
