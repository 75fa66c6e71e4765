"""HF safetensors checkpoints → the port's stacked-layer params, on the
device (counterpart of the JAX package's ``engine/checkpoint.py``).

The HF Llama/Mistral/Qwen2/Gemma names map onto the keys of
``models/llama.py`` ``init_params``; Phi-3's fused ``qkv_proj`` and
``gate_up_proj`` are split by rows into ``wq``/``wk``/``wv`` and
``wg``/``wu``; Mixtral's ``block_sparse_moe.experts.{e}.w1/w3/w2`` stack into
``wg``/``wu`` ``[L, E, D, F]`` and ``wd`` ``[L, E, F, D]``, its gate into
``router [L, D, E]``. Torch ``nn.Linear`` stores ``[out, in]``; the port's
matmul layout is ``[in, out]``, so every projection is transposed on load.

With ``quant`` (the JAX engine's ``preprocess`` hook, engine.py:581-589)
each quantizable tensor is quantized at the file's own precision, before
any cast: an HF row is one output channel with its whole contraction, so
each run of rows quantizes on its own, exactly, into the N-major (and under
int4 packed) leaves of models/quant.py — which keep the file's orientation.
A tied checkpoint gets its int8 head copy ``lm_head_q8`` from the placed
embed, on the device (JAX engine.py:594-609).

Every tensor's name, shape and dtype is checked against the config from the
shard headers before any tensor is read. Then each stacked parameter
``[L, ...]`` is allocated once on the device and the shards are read in file
order, a bounded run of rows at a time, into one of two reused host buffers
(pinned on the card) and copied into its slice of the stacked parameter.
Host memory is two row runs, whatever the checkpoint's size; the JAX loader
stacks each parameter on the host first. The shards are read with the
port's own reader (utils/safetensors_lite.py), not the ``safetensors``
package.
"""
from __future__ import annotations

import json
import logging
import re
import time
from pathlib import Path
from typing import Any

import torch

from ..models.config import ModelConfig
from ..models.quant import (contract_axis_for, empty_quantized, is_packed,
                            is_quantized, quantize_array, quantize_levels,
                            weight_bits)
from ..ops.quant_mm import pack_int4
from ..utils.safetensors_lite import safe_open

logger = logging.getLogger(__name__)

# Rows read per copy: the host buffers' size (two of them).
CHUNK_BYTES = 64 << 20


def _discover_shards(model_dir: Path) -> list[Path]:
    index = model_dir / "model.safetensors.index.json"
    if index.exists():
        data = json.loads(index.read_text())
        files = sorted(set(data["weight_map"].values()))
        return [model_dir / f for f in files]
    single = model_dir / "model.safetensors"
    if single.exists():
        return [single]
    shards = sorted(model_dir.glob("*.safetensors"))
    if not shards:
        raise FileNotFoundError(f"no safetensors files in {model_dir}")
    return shards


# HF tensor name → (the port's path, needs_transpose). {i} = layer,
# {e} = expert.
_LLAMA_MAP: list[tuple[re.Pattern, str, bool]] = [
    (re.compile(r"^model\.embed_tokens\.weight$"), "embed", False),
    (re.compile(r"^model\.norm\.weight$"), "final_norm", False),
    (re.compile(r"^lm_head\.weight$"), "lm_head", False),
    (re.compile(r"^model\.layers\.(\d+)\.input_layernorm\.weight$"),
     "layers.attn_norm.{i}", False),
    (re.compile(r"^model\.layers\.(\d+)\.self_attn\.q_proj\.weight$"),
     "layers.wq.{i}", True),
    (re.compile(r"^model\.layers\.(\d+)\.self_attn\.k_proj\.weight$"),
     "layers.wk.{i}", True),
    (re.compile(r"^model\.layers\.(\d+)\.self_attn\.v_proj\.weight$"),
     "layers.wv.{i}", True),
    (re.compile(r"^model\.layers\.(\d+)\.self_attn\.o_proj\.weight$"),
     "layers.wo.{i}", True),
    (re.compile(r"^model\.layers\.(\d+)\.post_attention_layernorm\.weight$"),
     "layers.mlp_norm.{i}", False),
    # Qwen2 QKV bias (1-D: no transpose)
    (re.compile(r"^model\.layers\.(\d+)\.self_attn\.q_proj\.bias$"),
     "layers.bq.{i}", False),
    (re.compile(r"^model\.layers\.(\d+)\.self_attn\.k_proj\.bias$"),
     "layers.bk.{i}", False),
    (re.compile(r"^model\.layers\.(\d+)\.self_attn\.v_proj\.bias$"),
     "layers.bv.{i}", False),
    (re.compile(r"^model\.layers\.(\d+)\.mlp\.gate_proj\.weight$"),
     "layers.wg.{i}", True),
    (re.compile(r"^model\.layers\.(\d+)\.mlp\.up_proj\.weight$"),
     "layers.wu.{i}", True),
    (re.compile(r"^model\.layers\.(\d+)\.mlp\.down_proj\.weight$"),
     "layers.wd.{i}", True),
    # Phi-3: fused attention and MLP up-projections (qkv_proj
    # [(H+2KV)*Dh, D], gate_up_proj [2F, D]), split by rows on load.
    (re.compile(r"^model\.layers\.(\d+)\.self_attn\.qkv_proj\.weight$"),
     "layers.__qkv__.{i}", False),
    (re.compile(r"^model\.layers\.(\d+)\.mlp\.gate_up_proj\.weight$"),
     "layers.__gu__.{i}", False),
    # Mixtral MoE
    (re.compile(r"^model\.layers\.(\d+)\.block_sparse_moe\.gate\.weight$"),
     "layers.router.{i}", True),
    (re.compile(r"^model\.layers\.(\d+)\.block_sparse_moe\.experts\.(\d+)\.w1\.weight$"),
     "layers.wg.{i}.{e}", True),
    (re.compile(r"^model\.layers\.(\d+)\.block_sparse_moe\.experts\.(\d+)\.w3\.weight$"),
     "layers.wu.{i}.{e}", True),
    (re.compile(r"^model\.layers\.(\d+)\.block_sparse_moe\.experts\.(\d+)\.w2\.weight$"),
     "layers.wd.{i}.{e}", True),
]


def _map_name(hf_name: str) -> tuple[str, int | None, int | None, bool] | None:
    """→ (bare param key, layer index, expert index, transpose) or None.
    The key is the leaf name inside the params tree ('wq', 'attn_norm', ...
    or 'embed'/'final_norm'/'lm_head' for layerless tensors)."""
    for pattern, target, transpose in _LLAMA_MAP:
        m = pattern.match(hf_name)
        if m:
            groups = m.groups()
            layer = int(groups[0]) if groups else None
            expert = int(groups[1]) if len(groups) > 1 else None
            key = target.split(".{i}")[0]
            if key.startswith("layers."):
                key = key[len("layers."):]
            return key, layer, expert, transpose
    return None


def _fused_bounds(key: str, c: ModelConfig) -> list[tuple[str, int, int]]:
    """Row ranges of each projection inside a Phi-3 fused tensor (HF
    orientation: rows are the output dim)."""
    if key == "__qkv__":
        qw = c.n_heads * c.head_dim
        kvw = c.n_kv_heads * c.head_dim
        return [("wq", 0, qw), ("wk", qw, qw + kvw),
                ("wv", qw + kvw, qw + 2 * kvw)]
    return [("wg", 0, c.d_ff), ("wu", c.d_ff, 2 * c.d_ff)]


def param_shapes(c: ModelConfig) -> dict[str, Any]:
    """The shape of every leaf ``init_params`` makes for ``c`` (layer
    leaves stacked ``[L, ...]``), ``lm_head`` included."""
    dh, L = c.head_dim, c.n_layers
    q, kv = c.n_heads * dh, c.n_kv_heads * dh
    layers = {"attn_norm": (L, c.d_model), "wq": (L, c.d_model, q),
              "wk": (L, c.d_model, kv), "wv": (L, c.d_model, kv),
              "wo": (L, q, c.d_model), "mlp_norm": (L, c.d_model),
              "wg": (L, c.d_model, c.d_ff), "wu": (L, c.d_model, c.d_ff),
              "wd": (L, c.d_ff, c.d_model),
              "bq": (L, q), "bk": (L, kv), "bv": (L, kv)}
    if c.is_moe:
        E, D, F = c.n_experts, c.d_model, c.d_ff
        layers.update(router=(L, D, E), wg=(L, E, D, F), wu=(L, E, D, F),
                      wd=(L, E, F, D))
    return {"embed": (c.vocab_size, c.d_model), "final_norm": (c.d_model,),
            "lm_head": (c.vocab_size, c.d_model), "layers": layers}


def load_checkpoint(model_dir: str | Path, config: ModelConfig,
                    dtype: torch.dtype = torch.bfloat16,
                    device: str | torch.device = "cpu",
                    stats: dict | None = None,
                    quant: str = "") -> dict[str, Any]:
    """Load an HF checkpoint into the stacked-layer params layout on
    ``device``, cast to ``dtype``, its quantizable tensors quantized under
    ``quant`` ("int8" | "int4"). A tied checkpoint (no ``lm_head``) gets
    ``lm_head`` as the embed tensor itself, not a copy. ``stats``, when
    given, receives the bytes read, the seconds spent reading files and
    the load's wall seconds (the device synchronized)."""
    t0 = time.perf_counter()
    device = torch.device(device)
    model_dir = Path(model_dir)
    shards = _discover_shards(model_dir)

    # Pass 1, headers only: where each tensor's rows go, checked against
    # the config before anything is read. A destination is (key, layer,
    # first row, end row, transpose) over the tensor's HF rows.
    plan: dict[Path, list[tuple[str, list[tuple]]]] = {}
    found: dict[str, dict[int | None, tuple[int, ...]]] = {}
    for shard in shards:
        with safe_open(shard) as f:
            for name in f.keys():
                mapped = _map_name(name)
                if mapped is None:
                    logger.debug("skipping unmapped tensor %s", name)
                    continue
                key, layer, expert, transpose = mapped
                if (expert is not None) != (config.is_moe and key in (
                        "wg", "wu", "wd")):
                    raise ValueError(
                        f"checkpoint tensor {name} does not fit the "
                        f"{'MoE' if config.is_moe else 'dense'} config")
                shape = f.shape(name)
                if key in ("__qkv__", "__gu__"):
                    subs = _fused_bounds(key, config)
                    rows = subs[-1][2]
                    if shape != (rows, config.d_model):
                        raise ValueError(
                            f"fused tensor {name} has {shape[0]} rows of "
                            f"{shape[1:]}; config implies {rows} of "
                            f"({config.d_model},) ({[s[0] for s in subs]})")
                    dests = [(sub, (layer, None), lo, hi, True)
                             for sub, lo, hi in subs]
                else:
                    dests = [(key, (layer, expert), 0,
                              shape[0] if shape else 1, transpose)]
                for sub, where, lo, hi, t in dests:
                    leaf = (shape[1:][::-1] + (hi - lo,) if t
                            else (hi - lo,) + shape[1:])
                    if where in found.setdefault(sub, {}):
                        raise ValueError(f"checkpoint holds {sub} layer "
                                         f"{where[0]} twice")
                    found[sub][where] = leaf
                plan.setdefault(shard, []).append((name, dests))
    shapes = _validate_shapes(found, config)

    # Pass 2: allocate each stacked leaf once, then copy runs of rows into
    # it, in file order.
    params: dict[str, Any] = {"layers": {}}
    for key, shape in shapes.items():
        top = key in ("embed", "final_norm", "lm_head")
        path = key if top else f"layers.{key}"
        axis = contract_axis_for(path, len(shape)) if quant else None
        leaf = (torch.empty(shape, dtype=dtype, device=device)
                if axis is None else empty_quantized(
                    shape, axis, weight_bits(quant, path), device))
        if top:
            params[key] = leaf
        else:
            params["layers"][key] = leaf
    copier = _RowCopier(device)
    read_s, n_bytes = 0.0, 0
    try:
        for shard, group in plan.items():
            with safe_open(shard) as f:
                for name, dests in group:
                    shape = f.shape(name)
                    rows = shape[0] if shape else 1
                    step = max(1, CHUNK_BYTES // max(1, f.nbytes(name)
                                                     // rows))
                    for c0 in range(0, rows, step):
                        c1 = min(rows, c0 + step)
                        t = time.perf_counter()
                        chunk = f.get_rows(name, c0, c1,
                                           out=copier.buffer())
                        read_s += time.perf_counter() - t
                        n_bytes += chunk.numel() * chunk.element_size()
                        copier.place(chunk, c0, [
                            (_leaf(params, key, where), lo, hi, t)
                            for key, where, lo, hi, t in dests])
    finally:
        copier.close()

    if "lm_head" not in params:
        if not config.tie_embeddings:
            logger.info("no lm_head in checkpoint; using tied embeddings")
        params["lm_head"] = params["embed"]
        if quant:
            params["lm_head_q8"] = quantize_array(params["embed"], 1)
    if stats is not None:
        stats.update(bytes=n_bytes, read_s=read_s,
                     seconds=time.perf_counter() - t0)
    return params


def _leaf(params: dict, key: str, where: tuple):
    """The destination of one tensor: a top-level leaf, or layer (and
    expert) of a stacked one — a tensor view, or the ``{"q", "s"}`` views
    of a quantized leaf."""
    layer, expert = where
    if layer is None:
        return params[key]
    leaf = params["layers"][key]
    index = (layer,) if expert is None else (layer, expert)
    if isinstance(leaf, dict):
        return {"q": leaf["q"][index], "s": leaf["s"][index]}
    return leaf[index]


def _validate_shapes(found: dict, config: ModelConfig) -> dict:
    """Every leaf the config needs is there, for every layer and no other,
    at the shape the config implies (JAX ``_validate_shapes``, run here on
    the shard headers before any tensor is read). → {key: stacked shape}."""
    c = config
    want = param_shapes(c)
    shapes = {}
    for key, by_layer in found.items():
        if key in want["layers"]:
            expect = want["layers"][key]
            experts = c.is_moe and key in ("wg", "wu", "wd")
            need = {(i, e) for i in range(c.n_layers)
                    for e in (range(c.n_experts) if experts else [None])}
            if set(by_layer) != need:
                raise ValueError(
                    f"checkpoint/config mismatch: {key} has (layer, expert) "
                    f"{sorted(by_layer, key=str)[:8]}..., config implies "
                    f"{c.n_layers} layers"
                    + (f" of {c.n_experts} experts" if experts else ""))
            got = {expect[:len(expect) - len(s)] + s
                   for s in by_layer.values()}
        else:
            got, expect = set(by_layer.values()), want[key]
        if got != {expect}:
            got = sorted(got)
            raise ValueError(f"checkpoint/config mismatch: {key} is "
                             f"{got[0] if len(got) == 1 else got}, config "
                             f"implies {expect}")
        shapes[key] = expect
    for key in ("embed", "final_norm"):
        if key not in shapes:
            raise ValueError(f"checkpoint is missing {key}")
    required = {"attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "wg", "wu",
                "wd"} | ({"router"} if c.is_moe else set())
    if c.attn_bias:
        # A qwen2-family checkpoint without its bias tensors must refuse to
        # load, not silently run bias-free.
        required |= {"bq", "bk", "bv"}
    missing = required - set(shapes)
    if missing:
        raise ValueError(f"checkpoint is missing layer params "
                         f"{sorted(missing)}; loaded keys: "
                         f"{sorted(k for k in shapes if k in want['layers'])}")
    return shapes


class _RowCopier:
    """Two reused host buffers (pinned on the card): a run of rows is read
    into one while the other's copy to the device may still be in flight;
    an event per buffer says when it is free again."""

    def __init__(self, device: torch.device):
        self.device = device
        cuda = device.type == "cuda"
        self._bufs = [torch.empty(CHUNK_BYTES, dtype=torch.uint8,
                                  pin_memory=cuda) for _ in range(2)]
        self._events = [torch.cuda.Event() if cuda else None
                        for _ in range(2)]
        self._i = 0

    def buffer(self) -> torch.Tensor:
        ev = self._events[self._i]
        if ev is not None:
            ev.synchronize()
        return self._bufs[self._i]

    def place(self, chunk: torch.Tensor, c0: int, dests) -> None:
        """Copy ``chunk`` (HF rows ``c0 ...`` of one tensor) into each
        destination (a layer's leaf, its first and end row in the tensor,
        transpose) it overlaps, cast to the leaf's dtype; then hand the
        buffer on."""
        src = chunk.to(self.device, non_blocking=True)
        c1 = c0 + chunk.shape[0]
        for leaf, lo, hi, transpose in dests:
            r0, r1 = max(c0, lo), min(c1, hi)
            if r0 >= r1:
                continue
            part = src[r0 - c0:r1 - c0]
            if isinstance(leaf, dict):
                # Rows are output channels with their whole contraction:
                # quantized here at the file's precision, into storage that
                # keeps the file's orientation.
                q, scale = quantize_levels(part, 1, 8 if leaf["q"].dtype
                                   == torch.int8 else 4)
                phys = leaf["q"].transpose(-1, -2) if transpose else leaf["q"]
                phys[r0 - lo:r1 - lo].copy_(
                    q if phys.dtype == torch.int8 else pack_int4(q))
                leaf["s"][r0 - lo:r1 - lo].copy_(scale)
            elif transpose:
                leaf[..., r0 - lo:r1 - lo].copy_(part.T)
            else:
                leaf[r0 - lo:r1 - lo].copy_(part)
        ev = self._events[self._i]
        if ev is not None:
            ev.record()
        self._i ^= 1

    def close(self) -> None:
        for ev in self._events:
            if ev is not None:
                ev.synchronize()
        self._bufs = []


def unique_bytes(params: dict[str, Any]) -> int:
    """Device bytes of a params tree, a tensor shared by two leaves (tied
    ``lm_head``) counted once."""
    seen, total = set(), 0

    def walk(node):
        nonlocal total
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif node.data_ptr() not in seen:
            seen.add(node.data_ptr())
            total += node.numel() * node.element_size()
    walk(params)
    return total


def weight_count(params: dict[str, Any]) -> int:
    """The weights a params tree stands for, each tensor once: a packed
    int4 byte is two, an int8 level one; scales, and the int8 copy of a
    tied head (``lm_head_q8``, the embed's own weights), are none."""
    seen, total = set(), 0

    def walk(node, key=None):
        nonlocal total
        if key == "lm_head_q8":
            return
        if is_quantized(node):
            total += node["q"].numel() * (2 if is_packed(node) else 1)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif node.data_ptr() not in seen:
            seen.add(node.data_ptr())
            total += node.numel()
    walk(params)
    return total


def _config_from_checkpoint(model_path: str | Path) -> ModelConfig:
    """Derive the ModelConfig from an HF checkpoint's config.json."""
    cfg = json.loads((Path(model_path) / "config.json").read_text())
    mtype = cfg.get("model_type", "llama")
    common = dict(
        rope_scaling=_parse_rope_scaling(cfg.get("rope_scaling")),
        vocab_size=cfg["vocab_size"],
        d_model=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
        d_ff=cfg["intermediate_size"],
        rope_theta=cfg.get("rope_theta", 10000.0),
        rms_eps=cfg.get("rms_norm_eps", 1e-5),
        max_seq_len=cfg.get("max_position_embeddings", 4096),
        tie_embeddings=cfg.get("tie_word_embeddings", False),
    )
    if mtype == "mixtral":
        return ModelConfig(family="mixtral",
                           n_experts=cfg.get("num_local_experts", 8),
                           experts_per_token=cfg.get("num_experts_per_tok", 2),
                           **common)
    if mtype == "mistral":
        # Llama block + sliding window (null in v0.2+ configs → full
        # attention); an explicit head_dim (Nemo-style checkpoints have
        # head_dim * n_heads != hidden_size).
        return ModelConfig(family="llama",
                           sliding_window=cfg.get("sliding_window") or 0,
                           head_dim_override=cfg.get("head_dim", 0) or 0,
                           **common)
    if mtype == "qwen2":
        return ModelConfig(family="qwen2", attn_bias=True, **common)
    if mtype == "phi3":
        # Llama block with fused qkv/gate_up tensors (split by the loader)
        # and a sliding window; "longrope" variants are refused by
        # _parse_rope_scaling.
        return ModelConfig(family="llama",
                           sliding_window=cfg.get("sliding_window") or 0,
                           **common)
    if mtype == "gemma":
        # Gemma always ties embeddings (HF omits the flag in some configs)
        # and carries an explicit head_dim (7B: 16 x 256 != hidden 3072).
        common["tie_embeddings"] = True
        return ModelConfig(family="gemma", act="gelu_tanh", rms_offset=1.0,
                           scale_embed=True,
                           head_dim_override=cfg.get("head_dim", 0),
                           **common)
    return ModelConfig(family="llama", **common)


def _parse_rope_scaling(block: dict | None):
    """HF config.json ``rope_scaling`` → RopeScaling. Unsupported types
    raise (silently wrong RoPE is worse than refusing the checkpoint); the
    no-op "default" type and null are accepted."""
    if not block:
        return None
    from ..models.config import RopeScaling
    rtype = block.get("rope_type", block.get("type", "llama3"))
    if rtype == "default":
        return None
    return RopeScaling(            # RopeScaling validates rtype
        rope_type=rtype,
        factor=float(block.get("factor", 8.0)),
        low_freq_factor=float(block.get("low_freq_factor", 1.0)),
        high_freq_factor=float(block.get("high_freq_factor", 4.0)),
        original_max_seq=int(block.get("original_max_position_embeddings",
                                       8192)))
