"""Batched token sampling with per-slot parameters (counterpart of the JAX
package's ``engine/sampling.py``).

Each row of a continuous batch carries its own temperature/top-p/top-k and
penalties; greedy is temperature == 0, selected per row. Random draws come
from an explicit ``torch.Generator`` (``jax.random`` keys have no PyTorch
equivalent, so draws differ between the packages — the kept candidate sets
and every greedy row do not).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SamplingParams(NamedTuple):
    """Per-slot sampling state, all [B]-shaped (on the engine's device)."""
    temperature: torch.Tensor    # [B] fp32; 0 → greedy
    top_p: torch.Tensor          # [B] fp32 in (0, 1]; 1 → disabled
    top_k: torch.Tensor          # [B] int32; 0 → disabled
    presence_penalty: torch.Tensor   # [B] fp32; 0 → disabled
    frequency_penalty: torch.Tensor  # [B] fp32; 0 → disabled


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor | None,
                    params: SamplingParams) -> torch.Tensor:
    """OpenAI-style presence/frequency penalties over the text so far:
    ``logits - frequency_penalty·count(token) - presence_penalty·
    [count(token) > 0]``, per slot. ``counts [B, V] int32`` is the
    engine-maintained token-occurrence state; None → no penalty source."""
    if counts is None:
        return logits
    pen = (params.frequency_penalty[:, None] * counts.float()
           + params.presence_penalty[:, None] * (counts > 0).float())
    return logits - pen


def candidate_logits(logits: torch.Tensor,
                     params: SamplingParams) -> torch.Tensor:
    """Temperature-scaled logits with everything outside the top-k and the
    top-p nucleus set to -inf — the distribution a sampled row draws from.
    logits [B, V] fp32 (penalties already applied)."""
    V = logits.shape[-1]
    # Guard temperature 0 to keep the math finite (greedy rows never draw).
    temp = torch.clamp(params.temperature, min=1e-6)[:, None]
    scaled = logits / temp

    # Top-k: mask logits below the k-th largest. k == 0 → disabled.
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.clamp(params.top_k.long(), 0, V)
    kth_idx = torch.clamp(k - 1, 0, V - 1)
    kth_val = torch.gather(sorted_desc, 1, kth_idx[:, None])
    topk_mask = (scaled >= kth_val) | (params.top_k[:, None] == 0)

    # Top-p (nucleus): keep the smallest prefix of the sorted distribution
    # with cumulative prob >= top_p (a sorted position is kept if the
    # cumulative prob BEFORE it is < p). p >= 1 keeps everything — stated
    # outright, because an fp32 cumsum can reach 1.0 before the tail and
    # would drop tail tokens (the JAX sampler does, in an order-dependent
    # way).
    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cumprobs = torch.cumsum(probs_sorted, dim=-1)
    keep_sorted = (((cumprobs - probs_sorted) < params.top_p[:, None])
                   | (params.top_p[:, None] >= 1.0))
    num_keep = keep_sorted.sum(dim=-1)                         # [B] >= 1
    thresh_idx = torch.clamp(num_keep - 1, 0, V - 1)
    thresh_val = torch.gather(sorted_desc, 1, thresh_idx[:, None])
    topp_mask = scaled >= thresh_val

    return torch.where(topk_mask & topp_mask, scaled, float("-inf"))


def sample(logits: torch.Tensor, params: SamplingParams,
           generator: torch.Generator,
           counts: torch.Tensor | None = None) -> torch.Tensor:
    """Sample next tokens. logits [B, V] fp32 → tokens [B] int64.
    Penalties (if ``counts`` given) shift logits BEFORE the greedy argmax,
    so temperature-0 requests get the penalized argmax."""
    logits = apply_penalties(logits, counts, params)
    greedy = torch.argmax(logits, dim=-1)
    if not bool(torch.any(params.temperature > 0)):
        return greedy                      # no row draws: skip the vocab sort
    probs = torch.softmax(candidate_logits(logits, params), dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(params.temperature > 0, sampled, greedy)
