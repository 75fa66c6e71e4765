"""Llama-family decoder in PyTorch (counterpart of the JAX package's
``models/llama.py``).

* Parameters are a plain nested dict in the JAX package's **stacked-layer
  layout and key names** (``embed``, ``final_norm``, ``lm_head``,
  ``layers/{attn_norm, wq, wk, wv, wo, mlp_norm, wg, wu, wd}``, each layer
  leaf ``[L, ...]``), so models/convert.py carries weights across as-is. The
  layer scan becomes a Python loop over layer indices.
* One forward for prefill and decode over either KV layout; the cache
  attention is the ``attention_fn`` argument (ops/paged_attention.py
  ``make_paged_attention_fn`` over the page pool, ops/flash_attention.py
  ``make_cache_attention_fn`` over the contiguous :class:`KVCache`), with
  the deferred-insert protocol: at T == 1 the ``.decode`` attends the
  STALE cache plus a self column and every layer's K/V is written once
  after the loop by ``.insert_all``; T > 1 chunks insert, then attend.
* Sliding-window models (mistral family; ``config.sliding_window``) use HF
  Mistral semantics: key ``j`` is visible to the query at position ``i``
  iff ``i - j < window``, the query itself included. The kernels' providers
  carry the window themselves; ``forward`` swaps the plain dense provider
  for :func:`windowed_dense_attention`.
* The contiguous cache, its inserts and the int8 KV quantizer live here,
  as in the JAX package; a cache side is a tensor or the int8
  ``{"q", "s"}`` dict.
* Projections, MLP and head are ``torch.matmul`` (the JAX package leaves
  them to XLA); RMSNorm, RoPE tables and logits are fp32.
"""
from __future__ import annotations

import math
from functools import lru_cache, partial
from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F

from ..ops.flash_attention import causal_core, decode_core
from .config import ModelConfig

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def init_params(config: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device = "cpu") -> Params:
    """Random-init params in the stacked-layer layout, on ``device``, from
    an explicit generator (which must live on the same device). Dense
    weights are N(0, 1/fan_in) drawn in fp32 one layer at a time (the fp32
    draw of a whole [L, D, F] stack would be 4x the stack's bf16 size),
    norms are ones."""
    c = config
    dh = c.head_dim

    def norm_init(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def dense_init(*shape):
        out = torch.empty(shape, dtype=dtype, device=device)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = 1.0 / math.sqrt(fan_in)
        for part in (out if len(shape) == 3 else [out]):
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=device) * scale)
        return out

    params: Params = {
        "embed": dense_init(c.vocab_size, c.d_model),
        "final_norm": norm_init(c.d_model),
        "layers": {
            "attn_norm": norm_init(c.n_layers, c.d_model),
            "wq": dense_init(c.n_layers, c.d_model, c.n_heads * dh),
            "wk": dense_init(c.n_layers, c.d_model, c.n_kv_heads * dh),
            "wv": dense_init(c.n_layers, c.d_model, c.n_kv_heads * dh),
            "wo": dense_init(c.n_layers, c.n_heads * dh, c.d_model),
            "mlp_norm": norm_init(c.n_layers, c.d_model),
            "wg": dense_init(c.n_layers, c.d_model, c.d_ff),
            "wu": dense_init(c.n_layers, c.d_model, c.d_ff),
            "wd": dense_init(c.n_layers, c.d_ff, c.d_model),
        },
    }
    if c.attn_bias:
        params["layers"]["bq"] = dense_init(c.n_layers, c.n_heads * dh)
        params["layers"]["bk"] = dense_init(c.n_layers, c.n_kv_heads * dh)
        params["layers"]["bv"] = dense_init(c.n_layers, c.n_kv_heads * dh)
    if not c.tie_embeddings:
        params["lm_head"] = dense_init(c.vocab_size, c.d_model)
    return params


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm with fp32 accumulation (bf16 variance underflows).
    ``offset``: Gemma parameterizes the scale as ``(1 + w)``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (offset + weight.float())).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                scaling=None) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., head_dim/2] (fp32) for given absolute positions.
    ``scaling`` is an optional ``config.RopeScaling``."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(
        half, dtype=torch.float32, device=positions.device) / half))
    if scaling is not None:
        freqs = _scale_rope_freqs(freqs, scaling)
    angles = positions.float()[..., None] * freqs                # [..., half]
    return torch.cos(angles), torch.sin(angles)


def _scale_rope_freqs(freqs: torch.Tensor, scaling) -> torch.Tensor:
    """Apply HF-convention rope_scaling to the inverse-frequency vector."""
    if scaling.rope_type == "linear":
        return freqs / scaling.factor
    # llama3: long wavelengths (beyond the original context's low-freq band)
    # are slowed by `factor`; short ones kept; the middle band interpolates.
    old_ctx = float(scaling.original_max_seq)
    low_wavelen = old_ctx / scaling.low_freq_factor
    high_wavelen = old_ctx / scaling.high_freq_factor
    wavelen = 2.0 * math.pi / freqs
    scaled = torch.where(wavelen > low_wavelen, freqs / scaling.factor, freqs)
    smooth = (old_ctx / wavelen - scaling.low_freq_factor) / (
        scaling.high_freq_factor - scaling.low_freq_factor)
    smoothed = (1.0 - smooth) * freqs / scaling.factor + smooth * freqs
    is_medium = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
    return torch.where(is_medium, smoothed, scaled)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x[..., :half], x[..., half:]) — HF llama convention, fp32
    math. x: [B, T, N, Dh]; cos/sin: [B, T, half]."""
    half = x.shape[-1] // 2
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out1 = xf1 * cos - xf2 * sin
    out2 = xf2 * cos + xf1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


class KVCache(NamedTuple):
    """Dense per-slot KV cache, stacked over layers, **head-major** (the JAX
    package's ``KVCache``): k, v ``[L, B, KV, S, Dh]``. The engine updates it
    in place (one allocation for the engine's lifetime). With
    ``kv_quant="int8"`` each of k/v is the dict ``{"q": int8 [L, B, KV, S,
    Dh], "s": fp32 [L, B, KV, 1, S]}`` of symmetric per-token, per-head
    scales."""
    k: Any
    v: Any

    @classmethod
    def create(cls, config: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, kv_quant: str = "",
               device="cpu") -> "KVCache":
        shape = (config.n_layers, batch, config.n_kv_heads, max_seq,
                 config.head_dim)
        return cls(k=zeros_kv(shape, dtype, kv_quant, device),
                   v=zeros_kv(shape, dtype, kv_quant, device))


def zeros_kv(shape, dtype, kv_quant: str, device):
    """One zeroed cache side of value shape ``[..., N, Dh]``: a tensor, or
    the int8 dict whose scales are ``[..., 1, N]``. The unit dimension
    exists for the TPU's (8, 128) tiling; the port keeps it so both
    packages' caches compare like with like."""
    if kv_quant == "int8":
        return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                "s": torch.zeros((*shape[:-2], 1, shape[-2]),
                                 dtype=torch.float32, device=device)}
    return torch.zeros(shape, dtype=dtype, device=device)


def layer_of(side, i: int):
    """Layer ``i`` of a stacked cache side (tensor or int8 dict), as views:
    writes through them land in the stacked cache."""
    if isinstance(side, dict):
        return {"q": side["q"][i], "s": side["s"][i]}
    return side[i]


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token, per-head int8 over the LAST dim (Dh).
    x [..., Dh] → (int8 same shape, fp32 scale [...]). Bit-exact with the
    JAX package's: fp32 amax, ``s = max(amax, 1e-30) / 127``, a division by
    ``s`` (not a product with its reciprocal), round half to even."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    s = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def _write_positions(S: int, T: int, lengths: torch.Tensor,
                     active: torch.Tensor | None):
    """(pos, src), each [B, T]: new token ``src`` of row b is written at
    position ``pos`` of the row.

    * Active rows write token t at ``lengths + t``. Positions past the cache
      extent are DROPPED: their writes are redirected to repeat the write
      of position S-1 (same position, same value), so a ragged group's pad
      positions past S never shift onto real keys. (JAX's
      ``dynamic_update_slice`` would clamp the start to S-T and shift the
      whole chunk; the JAX engine never lets that happen by clamping its
      prefill bucket, engine.py:2446-2449, and the port pads a group to its
      longest chunk instead.)
    * Inactive rows write at the row tail ``[S-T, S)``, exactly where JAX's
      clamp sends them (models/llama.py ``insert_kv``): those positions are
      rewritten before any step can see them.
    """
    start = lengths.long()
    if active is not None:
        start = torch.where(active, start, S - T)
    start = start.clamp(0, S - 1)
    pos = (start[:, None] + torch.arange(T, device=lengths.device)).clamp(
        max=S - 1)
    return pos, pos - start[:, None]


def insert_kv(layer_k, layer_v, k_new: torch.Tensor, v_new: torch.Tensor,
              lengths: torch.Tensor, active: torch.Tensor | None,
              rows: torch.Tensor | None = None):
    """Insert new tokens at ``[lengths, lengths+T)`` of each row of one
    layer's head-major cache, IN PLACE (the JAX version returns new
    arrays). layer_k/v: [Bc, KV, S, Dh] or the int8 ``{"q","s"}`` dicts (new
    tokens quantize at write time); k_new/v_new: [B, T, KV, Dh]; lengths,
    active: [B]; rows: optional [B] cache row of each new row (default: row
    b). See :func:`_write_positions` for inactive rows and positions past S.
    Returns the (same) caches."""
    S = (layer_k["q"] if isinstance(layer_k, dict) else layer_k).shape[2]
    B, T = k_new.shape[:2]
    pos, src = _write_positions(S, T, lengths, active)
    b = torch.arange(B, device=k_new.device)[:, None]
    row = b if rows is None else rows.long()[:, None]

    def put(side, new):
        vals = new[b, src]                                  # [B, T, KV, Dh]
        # Advanced indices separated by a slice: the indexed view is
        # [B, T, KV(, Dh)], matching the new tokens.
        if isinstance(side, dict):
            q, s = quantize_kv(vals)
            side["q"][row, :, pos] = q
            side["s"][row, :, 0, pos] = s
        else:
            side[row, :, pos] = vals.to(side.dtype)

    put(layer_k, k_new)
    put(layer_v, v_new)
    return layer_k, layer_v


def insert_kv_stacked(cache_k, cache_v, k_news: torch.Tensor,
                      v_news: torch.Tensor, lengths: torch.Tensor,
                      active: torch.Tensor | None,
                      rows: torch.Tensor | None = None):
    """Insert every layer's new tokens into the stacked cache with one
    scatter per leaf, IN PLACE — the deferred-decode half of
    :func:`insert_kv`. cache_k/v: [L, Bc, KV, S, Dh] or the int8 dicts;
    k_news/v_news: [L, B, T, KV, Dh] (quantized here, at write time);
    lengths, active, rows as in :func:`insert_kv`. Returns the caches."""
    S = (cache_k["q"] if isinstance(cache_k, dict) else cache_k).shape[3]
    B, T = k_news.shape[1:3]
    pos, src = _write_positions(S, T, lengths, active)
    b = torch.arange(B, device=k_news.device)[:, None]
    row = b if rows is None else rows.long()[:, None]

    def put(side, news):
        vals = news[:, b, src]                           # [L, B, T, KV, Dh]
        # The indexed view of side[:, row, :, pos] is [B, T, L, KV(, Dh)].
        if isinstance(side, dict):
            q, s = quantize_kv(vals)
            side["q"][:, row, :, pos] = q.permute(1, 2, 0, 3, 4)
            side["s"][:, row, :, 0, pos] = s.permute(1, 2, 0, 3)
        else:
            side[:, row, :, pos] = vals.permute(1, 2, 0, 3, 4).to(side.dtype)

    put(cache_k, k_news)
    put(cache_v, v_news)
    return cache_k, cache_v


def _kv_dequant_views(layer_k, layer_v, dtype):
    """(k, ks, v, vs) from a plain or int8 cache layer. The per-token scale
    factors OUT of the Dh contraction — scores multiply by ``ks`` after the
    QK product, probabilities by ``vs`` before the PV product — so no
    dequantized [S, Dh] copy is built. Scales come back in their stored
    [.., KV, 1, S] form (the unit dim broadcasts over the query rows)."""
    if isinstance(layer_k, dict):
        return (layer_k["q"].to(dtype), layer_k["s"],
                layer_v["q"].to(dtype), layer_v["s"])
    return layer_k, None, layer_v, None


def dense_decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, layer_k, layer_v,
                           lengths: torch.Tensor,
                           active: torch.Tensor | None = None,
                           window: int = 0) -> torch.Tensor:
    """Deferred-insert decode attention: one query token against the STALE
    cache prefix ``[0, lengths)`` plus the new token itself (self column,
    full precision under int8 KV), through the shared block math. With a
    sliding ``window`` the query at position ``lengths`` sees stale keys
    ``j > lengths - window`` (the self column is always inside). Writes
    nothing.

    q [B,1,H,Dh]; k_new/v_new [B,1,KV,Dh]; layer_k/v [B,KV,S,Dh] (stale) or
    the int8 ``{"q","s"}`` dicts. Returns out [B, 1, H*Dh] in q.dtype. P·V
    runs in fp32, as in the Pallas and CUDA kernels; the JAX twin casts P
    to the cache dtype first, which is the same function for an fp32 cache.
    """
    B, _, H, Dh = q.shape
    lk, ks, lv, vs = _kv_dequant_views(layer_k, layer_v, q.dtype)
    n_stale = lengths if active is None else torch.where(active, lengths, 0)
    out = decode_core(q[:, 0], k_new[:, 0], v_new[:, 0], lk, lv, n_stale,
                      ks, vs, window)
    return out.reshape(B, 1, H * Dh)


def dense_cache_attention(q: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, layer_k, layer_v,
                          lengths: torch.Tensor,
                          active: torch.Tensor | None = None,
                          window: int = 0):
    """Reference cache attention in plain PyTorch (the flash kernels replace
    it on the card — ops/flash_attention.py): insert the chunk IN PLACE,
    then causal attention over the whole cache row (with a sliding
    ``window``: the query at ``i`` sees keys ``j`` with ``i - j < window``).

    q [B, T, H, Dh] (RoPE applied); k_new/v_new [B, T, KV, Dh];
    layer_k/v [B, KV, S, Dh] or the int8 dicts; lengths [B] (insert offset).
    Returns (attn_out [B, T, H*Dh], layer_k, layer_v).
    """
    layer_k, layer_v = insert_kv(layer_k, layer_v, k_new, v_new, lengths,
                                 active)
    lk, ks, lv, vs = _kv_dequant_views(layer_k, layer_v, q.dtype)
    out = causal_core(q, lk, lv, lengths, ks, vs, active, window)
    return out, layer_k, layer_v


# The deferred-decode protocol (forward_hidden): decode steps attend the
# stale cache plus the self column, and the cache write happens once per
# step through insert_kv_stacked.
dense_cache_attention.decode = dense_decode_attention
dense_cache_attention.insert_all = insert_kv_stacked


@lru_cache(maxsize=8)
def windowed_dense_attention(window: int):
    """The plain dense provider with a sliding-window bound on both paths
    (chunk and deferred decode) — ``forward_hidden`` swaps it in for
    ``config.sliding_window`` models. Memoized so the provider is one
    object per window."""
    def fn(q, k_new, v_new, layer_k, layer_v, lengths, active=None):
        return dense_cache_attention(q, k_new, v_new, layer_k, layer_v,
                                     lengths, active, window=window)
    fn.decode = partial(dense_decode_attention, window=window)
    fn.insert_all = insert_kv_stacked
    return fn


_GATE_ACTS = {
    "silu": F.silu,                                            # llama/qwen2
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),      # gemma GeGLU
}


def swiglu_mlp(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated MLP (SwiGLU for llama/qwen2, GeGLU for gemma via ``act``)."""
    gate = _GATE_ACTS[act](x @ wg)
    return (gate * (x @ wu)) @ wd


def qkv_proj(h: torch.Tensor, lp: dict, config: ModelConfig):
    """Q/K/V projections with the optional qwen2-family bias, RoPE NOT yet
    applied. h [B, T, D] → q [B,T,H,Dh], k/v [B,T,KV,Dh]."""
    c = config
    B, T = h.shape[0], h.shape[1]
    dh = c.head_dim
    qp, kp, vp = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    if "bq" in lp:
        qp, kp, vp = qp + lp["bq"], kp + lp["bk"], vp + lp["bv"]
    return (qp.reshape(B, T, c.n_heads, dh),
            kp.reshape(B, T, c.n_kv_heads, dh),
            vp.reshape(B, T, c.n_kv_heads, dh))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward_hidden(params: Params, config: ModelConfig, tokens: torch.Tensor,
                   lengths: torch.Tensor, cache, *,
                   attention_fn: Callable,
                   active: torch.Tensor | None = None,
                   mlp_fn: Callable | None = None):
    """The decoder stack over new tokens, up to and including the final
    norm: (hidden [B, T, D], cache). The pool in ``cache`` is updated in
    place. tokens [B, T] int; lengths [B] int32 (tokens already cached per
    slot); active [B] bool (inactive slots compute but write to the trash
    page). A sliding-window model's window is threaded through the plain
    dense provider here; the kernels' providers carry it themselves.
    ``mlp_fn(h, layer_params)`` replaces the gated MLP (the JAX forward's
    hook, used by the decode profiler's ablations)."""
    c = config
    B, T = tokens.shape
    dh = c.head_dim
    if c.is_moe:
        raise ValueError("MoE models are not ported to the PyTorch forward "
                         "yet")
    if c.sliding_window and attention_fn is dense_cache_attention:
        attention_fn = windowed_dense_attention(c.sliding_window)

    x = params["embed"][tokens.long()]                          # [B, T, D]
    if c.scale_embed:
        x = x * torch.tensor(c.d_model ** 0.5, dtype=x.dtype)

    positions = lengths.long()[:, None] + torch.arange(
        T, device=tokens.device)[None, :]
    cos, sin = rope_tables(positions, dh, c.rope_theta, c.rope_scaling)

    decode_attend = attention_fn.decode if T == 1 else None
    layers = params["layers"]
    ys_k, ys_v = [], []
    for i in range(c.n_layers):
        lp = {name: w[i] for name, w in layers.items()}
        h = rms_norm(x, lp["attn_norm"], c.rms_eps, c.rms_offset)
        q, k, v = qkv_proj(h, lp, c)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if decode_attend is not None:
            attn = decode_attend(q, k, v, layer_of(cache.k, i),
                                 layer_of(cache.v, i), lengths, active)
            ys_k.append(k)
            ys_v.append(v)
        else:
            attn, _, _ = attention_fn(q, k, v, layer_of(cache.k, i),
                                      layer_of(cache.v, i), lengths, active)
        x = x + attn @ lp["wo"]
        h = rms_norm(x, lp["mlp_norm"], c.rms_eps, c.rms_offset)
        if mlp_fn is not None:
            x = x + mlp_fn(h, lp)
        else:
            x = x + swiglu_mlp(h, lp["wg"], lp["wu"], lp["wd"], c.act)
    if decode_attend is not None:
        attention_fn.insert_all(cache.k, cache.v, torch.stack(ys_k),
                                torch.stack(ys_v), lengths, active)
    return rms_norm(x, params["final_norm"], c.rms_eps, c.rms_offset), cache


def head_logits(params: Params, config: ModelConfig,
                x: torch.Tensor) -> torch.Tensor:
    """Logits ``x [..., D] · head [V, D]ᵀ`` accumulated into an fp32 output,
    as the JAX head does (``preferred_element_type=float32``): bf16 weights
    give logits without a bf16 rounding. On the card one GEMM writes fp32
    (``out_dtype``); the CPU has no such GEMM, so it upcasts the operands."""
    w = _select_head(params, config)
    if x.device.type == "cuda" and x.dtype != torch.float32:
        flat = torch.mm(x.reshape(-1, x.shape[-1]), w.T,
                        out_dtype=torch.float32)
        return flat.reshape(*x.shape[:-1], w.shape[0])
    return x.float() @ w.float().T


def forward(params: Params, config: ModelConfig, tokens: torch.Tensor,
            lengths: torch.Tensor, cache, *, attention_fn: Callable,
            active: torch.Tensor | None = None,
            mlp_fn: Callable | None = None):
    """One forward pass over new tokens (prefill chunk or single decode
    step). Returns (logits [B, T, V] fp32, cache)."""
    x, cache = forward_hidden(params, config, tokens, lengths, cache,
                              attention_fn=attention_fn, active=active,
                              mlp_fn=mlp_fn)
    return head_logits(params, config, x), cache


def _select_head(params: Params, c: ModelConfig) -> torch.Tensor:
    """The LM head weight: ``lm_head``, or the embed table when tied."""
    return params["embed"] if c.tie_embeddings else params["lm_head"]
