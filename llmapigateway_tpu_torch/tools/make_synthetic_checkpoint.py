"""Write a full-size synthetic HF-style safetensors checkpoint: the port's
counterpart of ``tools/make_synthetic_checkpoint.py``.

The files are what the checkpoint loader (engine/checkpoint.py) reads from
a real one: HF tensor names in HF orientation (``[out, in]``, the inverse of
the loader's map), a ``config.json`` the engine derives the architecture
from, and ``model-NNNNN.safetensors`` shards of about ``--shard-gb`` each
with ``model.safetensors.index.json``. Weights are N(0, 0.02²) drawn in fp32
from a CPU ``torch.Generator`` seeded by ``--seed`` and cast to ``--dtype``;
norm weights are ones. Text from them is random; the point is the load
path at full size. The shards are written by the port's own writer
(utils/safetensors_lite.py).

    python -m llmapigateway_tpu_torch.tools.make_synthetic_checkpoint
        --preset llama-3-8b --out DIR [--dtype bfloat16] [--shard-gb 4]
        [--seed 0] [--n-layers N]

``--n-layers`` cuts the preset's depth (its width stays): a mixtral-8x7b
checkpoint of one or two layers, HF Mixtral names and all, holds a full-
width MoE layer in a few GB; ``config.json`` records the cut depth.

Then serve it (``providers.json`` engine ``"model_path": DIR``) or time its
load with ``python -m llmapigateway_tpu_torch.tools.profile_checkpoint_load
DIR``. Prints one JSON line last and returns it from ``main(argv)``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from pathlib import Path

import torch

from ..models.config import ModelConfig, get_preset
from ..utils.safetensors_lite import save_file
from . import note

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def _hf_tensors(cfg: ModelConfig):
    """Yield (hf_name, shape) in HF orientation ([out, in]; the loader
    transposes matmul weights back)."""
    D, dh = cfg.d_model, cfg.head_dim
    H, KV, F, V = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size
    yield "model.embed_tokens.weight", (V, D)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        yield p + "input_layernorm.weight", (D,)
        yield p + "self_attn.q_proj.weight", (H * dh, D)
        yield p + "self_attn.k_proj.weight", (KV * dh, D)
        yield p + "self_attn.v_proj.weight", (KV * dh, D)
        yield p + "self_attn.o_proj.weight", (D, H * dh)
        yield p + "post_attention_layernorm.weight", (D,)
        if cfg.attn_bias:
            yield p + "self_attn.q_proj.bias", (H * dh,)
            yield p + "self_attn.k_proj.bias", (KV * dh,)
            yield p + "self_attn.v_proj.bias", (KV * dh,)
        if cfg.is_moe:
            yield p + "block_sparse_moe.gate.weight", (cfg.n_experts, D)
            for e in range(cfg.n_experts):
                q = p + f"block_sparse_moe.experts.{e}."
                yield q + "w1.weight", (F, D)
                yield q + "w3.weight", (F, D)
                yield q + "w2.weight", (D, F)
        else:
            yield p + "mlp.gate_proj.weight", (F, D)
            yield p + "mlp.up_proj.weight", (F, D)
            yield p + "mlp.down_proj.weight", (D, F)
    yield "model.norm.weight", (D,)
    if not cfg.tie_embeddings:
        yield "lm_head.weight", (V, D)


def _config_json(cfg: ModelConfig, preset: str) -> dict:
    mtype = {"llama": "llama", "qwen2": "qwen2", "gemma": "gemma",
             "mixtral": "mixtral"}[cfg.family]
    if cfg.family == "llama" and cfg.sliding_window:
        mtype = "mistral"
    out = {
        "model_type": mtype, "_synthetic_preset": preset,
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.d_model,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.d_ff, "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_eps,
        "max_position_embeddings": cfg.max_seq_len,
        "tie_word_embeddings": cfg.tie_embeddings,
    }
    if cfg.sliding_window:
        out["sliding_window"] = cfg.sliding_window
    if cfg.head_dim_override:
        out["head_dim"] = cfg.head_dim_override
    if cfg.is_moe:
        out["num_local_experts"] = cfg.n_experts
        out["num_experts_per_tok"] = cfg.experts_per_token
    if cfg.rope_scaling:
        rs = cfg.rope_scaling
        out["rope_scaling"] = {
            "rope_type": rs.rope_type, "factor": rs.factor,
            "low_freq_factor": rs.low_freq_factor,
            "high_freq_factor": rs.high_freq_factor,
            "original_max_position_embeddings": rs.original_max_seq}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m llmapigateway_tpu_torch.tools."
             "make_synthetic_checkpoint")
    ap.add_argument("--preset", default="llama-3-8b")
    ap.add_argument("--out", required=True)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--shard-gb", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=0,
                    help="depth of the checkpoint (0: the preset's)")
    args = ap.parse_args(argv)

    cfg = get_preset(args.preset)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    dtype = DTYPES[args.dtype]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "config.json").write_text(json.dumps(_config_json(
        cfg, args.preset), indent=2))

    gen = torch.Generator().manual_seed(args.seed)
    shard_bytes_cap = int(args.shard_gb * (1 << 30))
    shard: dict[str, torch.Tensor] = {}
    shard_bytes, shard_id, weight_map = 0, 0, {}
    names = list(_hf_tensors(cfg))
    total_bytes = sum(math.prod(s) for _, s in names) * dtype.itemsize
    t0 = time.monotonic()

    def flush():
        nonlocal shard, shard_bytes, shard_id
        if not shard:
            return
        fname = f"model-{shard_id:05d}.safetensors"
        save_file(shard, out / fname)
        for n in shard:
            weight_map[n] = fname
        note(f"  wrote {fname} ({shard_bytes / 1e9:.2f} GB, "
             f"{len(shard)} tensors)")
        shard, shard_bytes, shard_id = {}, 0, shard_id + 1

    for name, shape in names:
        if "layernorm" in name or name == "model.norm.weight":
            t = torch.ones(shape, dtype=dtype)        # norm weights ≈ 1
        else:
            t = (torch.randn(shape, generator=gen) * 0.02).to(dtype)
        shard[name] = t
        shard_bytes += t.numel() * dtype.itemsize
        if shard_bytes >= shard_bytes_cap:
            flush()
    flush()

    (out / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total_bytes}, "weight_map": weight_map}))
    res = {"preset": args.preset, "out": str(out), "dtype": args.dtype,
           "total_gb": round(total_bytes / (1 << 30), 2), "shards": shard_id,
           "gen_s": round(time.monotonic() - t0, 1)}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
