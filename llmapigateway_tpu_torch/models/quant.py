"""Int8/int4 weight quantization for the serving engine (W8A8 / W4A8):
the counterpart of the JAX package's ``models/quant.py``, with its names,
its scheme and its ``{"q", "s"}`` leaves.

* **Weights**: symmetric per-output-channel levels, ±127 (int8) or ±7
  (int4), with an fp32 scale per channel: for ``w [D, F]`` (contract over
  D) ``s [F] = max(max|w[:, f]|, 1e-30) / levels`` and ``q = clip(round(w /
  s))``, rounding half to even as ``jnp.round`` does. The seven layer
  matmuls (wq/wk/wv/wo/wg/wu/wd, and MoE experts ``[L, E, D, F]``) and the
  lm_head quantize; norms, biases, the router and the embed table stay full
  precision. Under ``int4`` the lm_head stays int8 (:func:`weight_bits`); a
  tied model gets an int8 head copy ``lm_head_q8``.
* **Activations**: symmetric per-row dynamic int8 (:func:`_dynamic_int8`);
  the row and channel scales factor out of the contraction, so
  ``y = float(xq @ wq) · xs · s`` with exact int32 sums.
* **Storage** (the port's, not the JAX package's): a layer weight's levels
  are kept N-major, each output channel's contraction contiguous, and ``q``
  is the ``[..., K, N]`` view of it, so its shape and values are the JAX
  leaf's; int4 levels are packed two a byte (uint8, ``[..., K/2, N]`` view
  of ``[..., N, K/2]``; ops/quant_mm.py ``pack_int4``), so an int4 layer
  holds half of int8's bytes, as XLA's int4 arrays do. The lm_head ``[V,
  D]`` is contracted over its last dim and is stored as it is.

``mm`` (and ``mm_many``, several weights over the same rows)/
``moe_mm_dense``/``moe_mm_batched``/``head_matmul`` are the dispatch
points: a plain tensor takes the float product, a quantized dict the
integer one (ops/quant_mm.py: ``torch._int_mm`` for int8, the W4A8 kernel
for packed int4).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops.quant_mm import int8_mm, pack_int4, w4a8_mm
from .config import ModelConfig

# Layer-stacked weights that quantize (contract dim 1 of [L, D_in, D_out]).
QUANT_LAYER_KEYS = frozenset({"wq", "wk", "wv", "wo", "wg", "wu", "wd"})
# Top-level weights that quantize ([V, D], contract over D → scale per V).
QUANT_TOP_KEYS = frozenset({"lm_head"})

QUANT_MODES = ("", "int8", "int4")


def weight_bits(mode: str, path: str) -> int:
    """Bit width for a quantizable path under a quant mode: 4 for the layer
    matmuls under ``int4``, else 8 (the lm_head stays int8 under ``int4``:
    it decides every sampled token)."""
    if mode == "int4" and path not in QUANT_TOP_KEYS:
        return 4
    return 8


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def is_packed(w: Any) -> bool:
    """A quantized leaf whose levels are packed int4."""
    return is_quantized(w) and w["q"].dtype == torch.uint8


def quantizes(path: str) -> bool:
    """Whether a param path quantizes: the stacked layer matmuls (dense or
    MoE expert) and the lm_head."""
    if path in QUANT_TOP_KEYS:
        return True
    return (path.startswith("layers.")
            and path.split(".", 1)[1] in QUANT_LAYER_KEYS)


def contract_axis_for(path: str, ndim: int) -> int | None:
    """The axis a quantized stacked weight contracts over, or None if the
    param does not quantize."""
    if not quantizes(path):
        return None
    if ndim == 4:   # MoE expert [L, E, D_in, D_out] → per-(e, out) scale
        return 2
    return 1        # lm_head [V, D] → per-V; layers [L, D_in, D_out] → dim 1


def _div_levels(amax: torch.Tensor, levels: int) -> torch.Tensor:
    """``max(amax, 1e-30) / levels`` as one correctly rounded division on
    every device, as ``jnp`` and numpy divide. (PyTorch on CUDA divides by
    a Python number as a product with its reciprocal, which can differ in
    the last bit; a 0-d tensor on the same device is divided.)"""
    return torch.clamp(amax, min=1e-30) / amax.new_full((), float(levels))


def quantize_levels(w: torch.Tensor, contract_axis: int, bits: int):
    """(int8 levels, fp32 scale with the contract axis squeezed)."""
    levels = (1 << (bits - 1)) - 1          # 127 (int8) / 7 (int4)
    f = w.float()
    amax = f.abs().amax(dim=contract_axis, keepdim=True)
    scale = _div_levels(amax, levels)
    q = torch.clamp(torch.round(f / scale), -levels, levels).to(torch.int8)
    return q, scale.squeeze(contract_axis)


# Output channels quantized at once (about this many weights a chunk), so
# the fp32 temporaries of a large weight stay small.
CHUNK_WEIGHTS = 1 << 24


def quantize_array(w: torch.Tensor, contract_axis: int,
                   bits: int = 8) -> dict[str, torch.Tensor]:
    """``{"q", "s"}`` of ``w`` in the port's storage: a contraction over
    the second-to-last axis (a layer weight) is stored N-major, and packed
    under int4; over the last axis (the head) as it is. Channels are
    independent, so they are quantized a chunk at a time."""
    axis = contract_axis % w.dim()
    if axis < w.dim() - 2 or (bits == 4 and axis == w.dim() - 1):
        raise ValueError(f"quantize_array: contraction over axis {axis} of "
                         f"{tuple(w.shape)} with {bits} bits is not a "
                         f"layout of the port")
    out = empty_quantized(tuple(w.shape), axis, bits, w.device)
    last = axis == w.dim() - 1
    chans = w if last else w.transpose(-1, -2)            # [..., N, K]
    phys = out["q"] if last else out["q"].transpose(-1, -2)
    step = max(1, CHUNK_WEIGHTS * chans.shape[-2] // max(1, chans.numel()))
    for n0 in range(0, chans.shape[-2], step):
        q, s = quantize_levels(chans[..., n0:n0 + step, :], -1, bits)
        phys[..., n0:n0 + step, :] = pack_int4(q) if bits == 4 else q
        out["s"][..., n0:n0 + step] = s
    return out


def empty_quantized(shape: tuple, contract_axis: int, bits: int,
                    device) -> dict[str, torch.Tensor]:
    """Uninitialised leaves of :func:`quantize_array`'s layout for a weight
    of logical ``shape``: what an engine fills part by part (random init,
    checkpoint load) without ever holding the full-precision tensor."""
    s_shape = shape[:contract_axis] + shape[contract_axis + 1:]
    s = torch.empty(s_shape, dtype=torch.float32, device=device)
    if contract_axis == len(shape) - 2:
        *lead, K, N = shape
        phys = (*lead, N, K // 2 if bits == 4 else K)
        q = torch.empty(phys, dtype=torch.uint8 if bits == 4 else torch.int8,
                        device=device).transpose(-1, -2)
    else:
        q = torch.empty(shape, dtype=torch.int8, device=device)
    return {"q": q, "s": s}


def quantize_tree(params: dict, config: ModelConfig,
                  mode: str = "int8") -> dict:
    """Replace every quantizable leaf of a params tree with its ``{"q",
    "s"}`` dict. Tied-embedding models keep the embed table full precision
    (the gather reads B rows a step) and get an int8 copy of it as the head,
    ``lm_head_q8``, which is what every decode step reads whole."""
    out: dict = {}
    for key, val in params.items():
        if key == "layers":
            out[key] = {}
            for k, v in val.items():
                axis = contract_axis_for(f"layers.{k}", v.dim())
                out[key][k] = v if axis is None else quantize_array(
                    v, axis, bits=weight_bits(mode, f"layers.{k}"))
        elif (not is_quantized(val)
              and contract_axis_for(key, val.dim()) is not None):
            out[key] = quantize_array(val, contract_axis_for(key, val.dim()),
                                      bits=weight_bits(mode, key))
        else:
            out[key] = val
    if config.tie_embeddings and "lm_head" not in params:
        out["lm_head_q8"] = quantize_array(params["embed"], 1)
    return out


def from_jax_leaf(path: str, q: np.ndarray, s: np.ndarray
                  ) -> dict[str, torch.Tensor]:
    """A JAX package's quantized leaf (numpy ``q`` of int8 or ml_dtypes
    int4, fp32 ``s``) in the port's storage: N-major, int4 packed."""
    levels = torch.from_numpy(np.asarray(q).astype(np.int8))
    scale = torch.from_numpy(np.array(s, np.float32))
    if contract_axis_for(path, levels.dim()) == levels.dim() - 2:
        lt = levels.transpose(-1, -2)
        packed = np.asarray(q).dtype.name == "int4"
        levels = (pack_int4(lt) if packed else lt.contiguous()
                  ).transpose(-1, -2)
    return {"q": levels, "s": scale}


# ---------------------------------------------------------------------------
# The products
# ---------------------------------------------------------------------------

def _dynamic_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 over the last dim: (xq int8, xs fp32 with a
    trailing unit axis)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    xs = _div_levels(amax, 127)
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xq, xs


def _product(xq: torch.Tensor, xs: torch.Tensor, w: dict,
             dtype: torch.dtype) -> torch.Tensor:
    """Quantized rows ``xq [M, K]`` (scales ``xs [M, 1]``) times a quantized
    weight, rescaled: ``float(acc) · xs · s`` in ``dtype`` (an int32 times
    an fp32 tensor converts the int32 as ``.float()`` does)."""
    if is_packed(w):
        return w4a8_mm(xq[None], xs[None], w["q"][None], w["s"][None],
                       dtype)[0]
    return (int8_mm(xq, w["q"]) * xs * w["s"]).to(dtype)


def mm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x [..., D] @ w [D, F]``, ``w`` a tensor or a quantized dict; the
    result in ``x.dtype`` either way."""
    return mm_many(x, (w,))[0]


def mm_many(x: torch.Tensor, ws) -> list[torch.Tensor]:
    """``[mm(x, w) for w in ws]`` (Q/K/V, gate/up), the rows quantized once
    when every weight is quantized: the JAX package quantizes the same rows
    for each product, which gives the same levels and scales each time."""
    if not all(is_quantized(w) for w in ws):
        return [mm(x, w) if is_quantized(w) else x @ w for w in ws]
    lead, K = x.shape[:-1], x.shape[-1]
    xq, xs = _dynamic_int8(x.reshape(-1, K))
    return [_product(xq, xs, w, x.dtype).reshape(*lead, -1) for w in ws]


def moe_mm_dense(x: torch.Tensor, w: Any) -> torch.Tensor:
    """All-experts projection ``x [N, D] × w [E, D, F] → [E, N, F]``;
    activations quantize once, shared by every expert. Int8 experts run as
    ONE product against the ``[D, E·F]`` view of their N-major levels."""
    if not is_quantized(w):
        return torch.einsum("nd,edf->enf", x, w)
    xq, xs = _dynamic_int8(x)                       # [N, D], [N, 1]
    E, F = w["s"].shape
    if is_packed(w):
        return w4a8_mm(xq.expand(E, *xq.shape), xs.expand(E, *xs.shape),
                       w["q"], w["s"], x.dtype)
    flat = w["q"].transpose(-1, -2).reshape(E * F, -1).t()     # [D, E·F]
    acc = int8_mm(xq, flat).reshape(-1, E, F)                  # [N, E, F]
    y = acc * xs[:, :, None] * w["s"][None]
    return y.transpose(0, 1).to(x.dtype)


def moe_mm_batched(x: torch.Tensor, w: Any) -> torch.Tensor:
    """Expert-batched projection ``x [E, C, Din] × w [E, Din, Dout] →
    [E, C, Dout]`` (the capacity-dispatch form and both down
    projections)."""
    if not is_quantized(w):
        return torch.bmm(x, w)
    xq, xs = _dynamic_int8(x)                       # [E, C, Din], [E, C, 1]
    if is_packed(w):
        return w4a8_mm(xq, xs, w["q"], w["s"], x.dtype)
    acc = torch.stack([int8_mm(xq[e], w["q"][e]) for e in range(x.shape[0])])
    y = acc * xs * w["s"][:, None, :]
    return y.to(x.dtype)


def head_matmul(x: torch.Tensor, head: Any) -> torch.Tensor:
    """Logits ``x [..., D] · head [V, D]ᵀ`` in fp32. A plain head
    accumulates its bf16 operands into an fp32 output (one GEMM writing
    fp32 on the card; the CPU has no such GEMM and upcasts); an int8 head
    contracts against its last dim directly."""
    if not is_quantized(head):
        if x.device.type == "cuda" and x.dtype != torch.float32:
            flat = torch.mm(x.reshape(-1, x.shape[-1]), head.T,
                            out_dtype=torch.float32)
            return flat.reshape(*x.shape[:-1], head.shape[0])
        return x.float() @ head.float().T
    lead, D = x.shape[:-1], x.shape[-1]
    xq, xs = _dynamic_int8(x.reshape(-1, D))
    acc = int8_mm(xq, head["q"].t())
    return (acc * xs * head["s"]).reshape(*lead, -1)
