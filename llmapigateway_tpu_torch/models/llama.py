"""Llama-family decoder in PyTorch (counterpart of the JAX package's
``models/llama.py``).

* Parameters are a plain nested dict in the JAX package's **stacked-layer
  layout and key names** (``embed``, ``final_norm``, ``lm_head``,
  ``layers/{attn_norm, wq, wk, wv, wo, mlp_norm, wg, wu, wd}``, each layer
  leaf ``[L, ...]``), so models/convert.py carries weights across as-is. The
  layer scan becomes a Python loop over layer indices.
* One forward for prefill and decode over the paged KV pool; the cache
  attention is the ``attention_fn`` argument (ops/paged_attention.py
  ``make_paged_attention_fn``), with the deferred-insert protocol: at
  T == 1 the ``.decode`` attends the STALE pool plus a self column and every
  layer's K/V is written once after the loop by ``.insert_all``; T > 1
  chunks insert, then attend.
* Projections, MLP and head are ``torch.matmul`` (the JAX package leaves
  them to XLA); RMSNorm, RoPE tables and logits are fp32.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..ops.flash_attention import attend_block, self_column_init
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


def dense_decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, layer_k: torch.Tensor,
                           layer_v: torch.Tensor, lengths: torch.Tensor,
                           active: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Deferred-insert decode attention: one query token against the STALE
    cache prefix ``[0, lengths)`` plus the new token itself (self column),
    through the shared block math. Writes nothing.

    q [B,1,H,Dh]; k_new/v_new [B,1,KV,Dh]; layer_k/v [B,KV,S,Dh] (stale).
    Returns out [B, 1, H*Dh] in q.dtype. P·V runs in fp32, as in the Pallas
    and CUDA kernels; the JAX twin casts P to the cache dtype first, which
    is the same function for an fp32 cache.
    """
    B, _, H, Dh = q.shape
    KV = k_new.shape[2]
    S = layer_k.shape[2]
    qg = q[:, 0].reshape(B, KV, H // KV, Dh)
    m, l, acc = self_column_init(qg, k_new[:, 0, :, None, :],
                                 v_new[:, 0, :, None, :])
    if S:
        visible = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
        if active is not None:
            visible = visible & active[:, None]
        m, l, acc = attend_block(qg, layer_k, layer_v, m, l, acc,
                                 visible[:, None, None, :])
    return (acc / l).reshape(B, 1, H * Dh).to(q.dtype)


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
                   active: torch.Tensor | None = None):
    """The decoder stack over new tokens, up to and including the final
    norm: (hidden [B, T, D], cache). The pool in ``cache`` is updated in
    place. tokens [B, T] int; lengths [B] int32 (tokens already cached per
    slot); active [B] bool (inactive slots compute but write to the trash
    page)."""
    c = config
    B, T = tokens.shape
    dh = c.head_dim
    if c.sliding_window or c.is_moe:
        raise ValueError("sliding-window and MoE models are not ported to "
                         "the PyTorch forward yet")

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
            attn = decode_attend(q, k, v, cache.k[i], cache.v[i], lengths,
                                 active)
            ys_k.append(k)
            ys_v.append(v)
        else:
            attn, _, _ = attention_fn(q, k, v, cache.k[i], cache.v[i],
                                      lengths, active)
        x = x + attn @ lp["wo"]
        h = rms_norm(x, lp["mlp_norm"], c.rms_eps, c.rms_offset)
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
            active: torch.Tensor | None = None):
    """One forward pass over new tokens (prefill chunk or single decode
    step). Returns (logits [B, T, V] fp32, cache)."""
    x, cache = forward_hidden(params, config, tokens, lengths, cache,
                              attention_fn=attention_fn, active=active)
    return head_logits(params, config, x), cache


def _select_head(params: Params, c: ModelConfig) -> torch.Tensor:
    """The LM head weight: ``lm_head``, or the embed table when tied."""
    return params["embed"] if c.tie_embeddings else params["lm_head"]
