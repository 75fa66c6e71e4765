"""Mixtral-family sparse-MoE decoder in PyTorch (counterpart of the JAX
package's ``models/mixtral.py``).

The attention and norm stack is models/llama.py's; only the MLP differs: a
top-k router over ``n_experts`` SwiGLU experts, stacked on a leading expert
dim (``wg``/``wu`` ``[L, E, D, F]``, ``wd`` ``[L, E, F, D]``, router
``[L, D, E]``), each a tensor or a quantized ``{"q", "s"}`` dict
(models/quant.py).

* :func:`moe_mlp_dense` — every expert computes every token, combined with
  the top-k-masked router weights. Exact; decode steps and small chunks run
  it, as in JAX (every expert's weights stream each step either way).
* :func:`moe_mlp_dispatch` — capacity-based dispatch for long prefill
  chunks: capacity ``C = min(N, ceil(k·N/E · capacity_factor))``, tokens
  queue per expert in token order and those past C are dropped. The JAX
  package builds one-hot ``[N, E, C]`` dispatch and combine tensors; here a
  scatter places each kept (token, expert) pair at its queue slot and a
  gather brings the expert outputs back, which drops the same tokens and
  adds the same terms (each token has at most k of them).
* The router computes in fp32 and breaks ties as ``jax.lax.top_k`` does,
  toward the lower expert index (a stable descending sort).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from . import llama
from .config import ModelConfig
from .quant import moe_mm_batched, moe_mm_dense

Params = dict[str, Any]

# A chunk of more tokens (rows × width) than this runs capacity dispatch.
DISPATCH_THRESHOLD = 64


def init_params(config: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device = "cpu",
                quant: str = "") -> Params:
    """Random-init params: the llama layout with the router and expert
    MLPs (models/llama.py ``init_params`` draws them one expert at a time
    and, with ``quant``, quantizes each part into its leaves)."""
    if not config.is_moe:
        raise ValueError("mixtral.init_params needs n_experts > 0")
    return llama.init_params(config, generator, dtype=dtype, device=device,
                             quant=quant)


def route(x_flat: torch.Tensor, router: torch.Tensor, k: int
          ) -> torch.Tensor:
    """Top-k routing weights. x_flat [N, D], router [D, E] → probs [N, E]
    fp32: zero outside each token's top k, the softmax of the top-k logits
    inside (Mixtral's renormalized top-k). Ties go to the lower expert."""
    logits = x_flat.float() @ router.float()                     # [N, E]
    top_vals, top_idx = torch.sort(logits, dim=-1, descending=True,
                                   stable=True)
    top_w = torch.softmax(top_vals[:, :k], dim=-1)               # [N, k]
    return torch.zeros_like(logits).scatter(-1, top_idx[:, :k], top_w)


def _expert_ffn(x: torch.Tensor, lp: Params, dense: bool) -> torch.Tensor:
    """SwiGLU of every expert: dense x [N, D] → [E, N, D]; batched
    x [E, C, D] → [E, C, D]."""
    mm_in = moe_mm_dense if dense else moe_mm_batched
    h = mm_in(x, lp["wg"])
    u = mm_in(x, lp["wu"])
    return moe_mm_batched(F.silu(h) * u, lp["wd"])


def moe_mlp_dense(x: torch.Tensor, lp: Params,
                  config: ModelConfig) -> torch.Tensor:
    """All-experts MoE MLP (exact; no capacity drops). x [B, T, D] →
    [B, T, D]."""
    B, T, D = x.shape
    xf = x.reshape(B * T, D)
    probs = route(xf, lp["router"], config.experts_per_token)   # [N, E]
    y = _expert_ffn(xf, lp, dense=True)                          # [E, N, D]
    out = torch.einsum("end,ne->nd", y.float(), probs)
    return out.reshape(B, T, D).to(x.dtype)


def moe_mlp_dispatch(x: torch.Tensor, lp: Params, config: ModelConfig,
                     capacity_factor: float = 2.0) -> torch.Tensor:
    """Capacity-based dispatch MoE MLP: work ∝ top-k; a token past its
    expert's capacity contributes zero. Static shapes: the scatter sends
    dropped pairs to a spare slot C that is cut off, so nothing reads the
    host."""
    B, T, D = x.shape
    N = B * T
    E, k = config.n_experts, config.experts_per_token
    C = min(max(1, math.ceil(k * N / E * capacity_factor)), N)

    xf = x.reshape(N, D)
    probs = route(xf, lp["router"], k)                           # [N, E]
    mask = probs > 0.0
    # Each token's place in its expert's queue (1-based), N-major so that
    # earlier tokens win capacity.
    position = torch.cumsum(mask.int(), dim=0) * mask            # [N, E]
    keep = mask & (position <= C)
    slot = torch.where(keep, position - 1, C)                    # [N, E]
    experts = torch.arange(E, device=x.device).expand(N, E)
    xs = torch.zeros((E, C + 1, D), dtype=xf.dtype, device=x.device)
    xs[experts, slot] = xf[:, None, :].expand(N, E, D)
    ys = _expert_ffn(xs[:, :C].contiguous(), lp, dense=False)   # [E, C, D]
    ys = torch.cat([ys, ys.new_zeros((E, 1, D))], dim=1)
    gathered = ys[experts, slot].float()                         # [N, E, D]
    out = torch.einsum("ned,ne->nd", gathered, probs * keep)
    return out.reshape(B, T, D).to(x.dtype)


def make_mlp_fn(config: ModelConfig,
                dispatch_threshold: int = DISPATCH_THRESHOLD,
                capacity_factor: float = 2.0):
    """The ``mlp_fn`` hook of models/llama.py's forward: decode steps
    (T == 1) and chunks of at most ``dispatch_threshold`` tokens run the
    exact dense form; longer prefill chunks run capacity dispatch."""
    def mlp_fn(h: torch.Tensor, lp: Params) -> torch.Tensor:
        B, T, _ = h.shape
        if T == 1 or B * T <= dispatch_threshold:
            return moe_mlp_dense(h, lp, config)
        return moe_mlp_dispatch(h, lp, config,
                                capacity_factor=capacity_factor)
    return mlp_fn


def forward(params: Params, config: ModelConfig, tokens: torch.Tensor,
            lengths: torch.Tensor, cache, *, attention_fn,
            active: torch.Tensor | None = None):
    """Mixtral forward = the llama forward with the MoE MLP plugged in."""
    return llama.forward(params, config, tokens, lengths, cache,
                         attention_fn=attention_fn, active=active,
                         mlp_fn=make_mlp_fn(config))
