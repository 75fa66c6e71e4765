"""The shared online-softmax block math of the attention kernels.

The JAX package's ``ops/flash_attention.py`` keeps ONE copy of the block
update that all its Pallas kernels run (``self_column_init`` :60,
``attend_block`` :79). The port keeps the same single-copy discipline twice
over: these plain PyTorch helpers, which the kernels' plain versions
(ops/paged_attention.py) are built from, and one set of ``__device__``
functions in ``csrc/attention_common.cuh`` that both CUDA kernels share.
All math is fp32, as in the Pallas kernels.

Layout: ``q`` is ``[..., R, Dh]`` (R query rows — a GQA group for decode, a
run of query positions for prefill), ``k``/``v`` are ``[..., S, Dh]`` and the
online-softmax state is ``m``/``l`` ``[..., R, 1]`` and ``acc``
``[..., R, Dh]``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def self_column_init(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor):
    """Seed a decode's online-softmax state from the SELF column (the new
    token attending itself): m = q·k_new·Dh^-½, l = 1, acc = v_new. The
    cache is STALE — the current token's K/V is not in the pool yet (the
    deferred-insert decode protocol, models/llama.py ``forward``).

    q [..., R, Dh]; k_new/v_new [..., 1, Dh] → (m, l, acc), fp32."""
    q = q.float()
    m = (q @ k_new.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    l = torch.ones_like(m)
    acc = v_new.float().expand(*q.shape).clone()
    return m, l, acc


def attend_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                 visible: torch.Tensor):
    """One online-softmax block update over keys ``k``/values ``v``;
    ``visible`` (broadcastable to ``[..., R, S]``) is the caller's mask.
    Masked scores are NEG_INF (finite), so a row with nothing visible yet
    accumulates exp(0) terms exactly as the kernels do. Returns the new
    (m, l, acc)."""
    q = q.float()
    scores = (q @ k.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    scores = torch.where(visible, scores, NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    e = torch.exp(scores - m_new)
    l = alpha * l + e.sum(dim=-1, keepdim=True)
    acc = acc * alpha + e @ v.float()
    return m_new, l, acc
