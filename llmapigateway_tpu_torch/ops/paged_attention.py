"""Paged KV-cache attention: the page pool, its scatter inserts, and the two
paged attention kernels behind wrappers that pick the CUDA kernel for a
CUDA tensor and the plain PyTorch version for a CPU tensor.

Counterpart of the JAX package's ``ops/paged_attention.py``, same argument
layouts:

* ``k_pages``/``v_pages``: ``[P, KV, page, Dh]`` per layer — the global
  page pool, head-major within a page. **Physical page 0 is the trash
  page**: scatter targets for inactive slots and out-of-range positions are
  redirected there, so masked writes need no branching. The allocator
  (engine/paged.py) never hands page 0 out.
* ``page_table``: ``[B, NP]`` int32 — slot's logical page j → physical
  page. Unallocated entries are 0 (trash) and are never read: reads are
  bounded by ``n_stale`` (decode) or the causal bound (prefill).
* With ``kv_quant="int8"`` each pool is the dict ``{"q": int8 [P, KV, page,
  Dh], "s": fp32 [P, KV, 1, page]}``; new tokens quantize at write time and
  the kernels' int8 bodies apply the scales to scores and probabilities.

Kernels (``csrc/paged_attention.cu``, built and bound by ops/_kernels.py):

* :func:`paged_decode_attention` replaces the Pallas kernel
  ``paged_decode_attention`` / ``_paged_decode_kernel``
  (llmapigateway_tpu/ops/paged_attention.py:272, :204); its body is
  ``csrc/decode_split.cuh``.
* :func:`paged_prefill_attention` replaces ``paged_prefill_attention`` /
  ``_paged_prefill_kernel`` (:438, :384).

Both take the two variants of the Pallas kernels: ``window`` (a sliding
window, 0 = full causal; pages below it are never read, so the engine's SWA
page ring may recycle them) and ``pages_per_block`` (a PACKED table: every
aligned run of ppb logical pages maps onto ppb contiguous physical pages at
a ppb-aligned start — what the allocator's superpage packing produces — so
the kernel reads one table entry per run; the output is bit-for-bit that of
``pages_per_block=1``).

Each wrapper counts its kernel launches in a plain integer attribute
(``paged_decode_attention.launches``) and per body and head geometry in
``.body_launches`` (``"full/bf16/Dh128/G4"``, ``"window_ppb2/int8/Dh96/G1"``,
...; ``flash_attention.body_name``), incremented only where the kernel is
launched, so a run can show that its main path went through the kernel body
it meant to, at the head geometry it meant to.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models.config import ModelConfig
from ..models.llama import quantize_kv, zeros_kv
from . import _kernels
from .flash_attention import (body_name, causal_core, check_geometry,
                              check_kernel_args, check_window, count_launch,
                              decode_core, decode_workspace, reset_launches,
                              split_kv, split_record)


class PagedKVCache(NamedTuple):
    """k, v: [L, P, KV, page, Dh] — the global page pool per layer, or with
    ``kv_quant="int8"`` the dicts ``{"q": int8 [L, P, KV, page, Dh], "s":
    fp32 [L, P, KV, 1, page]}`` (per-token, per-head scales; the unit dim
    exists for the TPU's tiling — models/llama.py ``zeros_kv``). The engine
    updates it in place (the JAX package's pool is an immutable array
    threaded through the step programs; here one allocation lives for the
    engine's lifetime)."""
    k: Any
    v: Any

    @classmethod
    def create(cls, config: ModelConfig, num_pages: int, page_size: int,
               dtype=torch.bfloat16, kv_quant: str = "",
               device="cpu") -> "PagedKVCache":
        shape = (config.n_layers, num_pages, config.n_kv_heads, page_size,
                 config.head_dim)
        return cls(k=zeros_kv(shape, dtype, kv_quant, device),
                   v=zeros_kv(shape, dtype, kv_quant, device))


def _write_targets(page_table: torch.Tensor, lengths: torch.Tensor, T: int,
                   page: int, active: torch.Tensor | None):
    """(physical page, offset) per new token, flattened to [B*T]: token t of
    slot b lands at logical position lengths[b] + t; inactive slots and
    positions past the table's reach go to trash page 0."""
    NP = page_table.shape[1]
    pos = lengths.long()[:, None] + torch.arange(
        T, device=lengths.device)[None, :]                        # [B, T]
    logical = torch.clamp(pos // page, 0, NP - 1)
    phys = torch.gather(page_table.long(), 1, logical)            # [B, T]
    ok = (pos // page) < NP
    if active is not None:
        ok = ok & active[:, None]
    phys = torch.where(ok, phys, 0)
    return phys.reshape(-1), (pos % page).reshape(-1)


def paged_insert_kv(layer_k, layer_v, k_new: torch.Tensor,
                    v_new: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, active: torch.Tensor | None):
    """Scatter new tokens into one layer's page pool at logical positions
    ``[lengths, lengths+T)`` per slot, IN PLACE (the JAX version returns new
    pools). layer_k/v: [P, KV, page, Dh] or the int8 ``{"q","s"}`` dicts (new
    tokens quantize at write time); k_new/v_new: [B, T, KV, Dh];
    page_table: [B, NP]; lengths: [B]. Inactive slots and positions past
    the table's reach land on trash page 0. Returns the (same) pools."""
    page = split_kv(layer_k)[0].shape[2]
    B, T, KV, Dh = k_new.shape
    phys, off = _write_targets(page_table, lengths, T, page, active)

    def put(side, new):
        # Advanced indices separated by a slice: the indexed view is
        # [B*T, KV(, Dh)], matching the flattened new tokens.
        new = new.reshape(B * T, KV, Dh)
        if isinstance(side, dict):
            q, s = quantize_kv(new)
            side["q"][phys, :, off] = q
            side["s"][phys, :, 0, off] = s
        else:
            side[phys, :, off] = new.to(side.dtype)

    put(layer_k, k_new)
    put(layer_v, v_new)
    return layer_k, layer_v


def paged_insert_all(pool_k, pool_v, k_news: torch.Tensor,
                     v_news: torch.Tensor, page_table: torch.Tensor,
                     lengths: torch.Tensor, active: torch.Tensor | None):
    """Insert every layer's new tokens into the stacked pool with one
    scatter per leaf, IN PLACE (the paged half of the deferred-insert
    protocol). pool_k/v: [L, P, KV, page, Dh] or the int8 dicts;
    k_news/v_news: [L, B, T, KV, Dh] (quantized here, at write time);
    lengths: [B] — the first token's logical position. Masked/overflow
    writes land on trash page 0. Returns the pools."""
    page = split_kv(pool_k)[0].shape[3]
    L, B, T = k_news.shape[:3]
    phys, off = _write_targets(page_table, lengths, T, page, active)

    def put(side, news):
        # Indexed view of pool[:, phys, :, off] is [B*T, L, KV(, Dh)].
        new = news.permute(1, 2, 0, 3, 4).reshape(B * T, L,
                                                  *news.shape[3:])
        if isinstance(side, dict):
            q, s = quantize_kv(new)
            side["q"][:, phys, :, off] = q
            side["s"][:, phys, :, 0, off] = s
        else:
            side[:, phys, :, off] = new.to(side.dtype)

    put(pool_k, k_news)
    put(pool_v, v_news)
    return pool_k, pool_v


def gather_pages(layer_pages, page_table: torch.Tensor, max_seq: int):
    """Materialize the dense [B, KV, S, Dh] view of one layer's pool — the
    plain versions' input; the kernels read the pool in place. An int8 dict
    gathers per leaf: the [P, KV, 1, page] scales through their squeezed
    view, back in the dense stored form [B, KV, 1, S]."""
    if isinstance(layer_pages, dict):
        s = gather_pages(layer_pages["s"][:, :, 0, :], page_table, max_seq)
        return {"q": gather_pages(layer_pages["q"], page_table, max_seq),
                "s": s[:, :, None, :]}
    KV, page = layer_pages.shape[1], layer_pages.shape[2]
    NP = page_table.shape[1]
    n_pages = min(NP, (max_seq + page - 1) // page)
    picked = layer_pages[page_table[:, :n_pages].long()]  # [B, n, KV, page(, Dh)]
    picked = picked.movedim(1, 2)                         # [B, KV, n, page(, Dh)]
    seq = picked.reshape(page_table.shape[0], KV, n_pages * page,
                         *picked.shape[4:])
    return seq[:, :, :max_seq]


def dequant_gathered(d, dtype):
    """A gathered pool side → its dense float view ``q · s`` (a float
    tensor passes through): the JAX reference path's one copy of the int8
    dequant. The plain versions and the kernels never build it — they apply
    the scales to scores and probabilities."""
    if isinstance(d, dict):
        return d["q"].to(dtype) * d["s"].transpose(-1, -2).to(dtype)
    return d


# ---------------------------------------------------------------------------
# Plain versions of the two kernels
# ---------------------------------------------------------------------------

def _check_pages_per_block(ppb: int, NP: int, P: int) -> None:
    """Static geometry gate for the multi-page kernels (the JAX package's,
    same messages): the table width and the pool's page count must both
    split into whole runs. That every aligned run of the table is packed —
    ``pt[b, g·ppb + i] == pt[b, g·ppb] + i`` with ``pt[b, g·ppb] % ppb ==
    0`` — is the caller's promise; the engine's superpage-packing allocator
    (engine/paged.py ``pages_per_block``) keeps it, and the engine falls
    back to per-page blocks whenever it cannot (SWA ring, non-divisible
    geometry)."""
    if ppb < 1:
        raise ValueError(f"pages_per_block must be >= 1, got {ppb}")
    if ppb > 1 and (NP % ppb or P % ppb):
        raise ValueError(
            f"pages_per_block={ppb} needs the page-table width ({NP}) and "
            f"the pool's page count ({P}) divisible by it")


def _paged_decode_plain(q, k_new, v_new, k_pages, v_pages, page_table,
                        n_stale, window=0):
    """The decode kernel's function in plain PyTorch: the stale pool up to
    ``n_stale`` (from the window's floor) plus the self column, all in fp32
    (the Pallas kernel accumulates P·V in fp32). Gathers pages up to the
    longest slot's last live one; a shorter slot's dead positions, and
    positions below a slot's window, are masked out. On the packed table
    that pages_per_block > 1 requires, the per-page gather reads the same
    pages as the multi-page kernel."""
    page, NP = split_kv(k_pages)[0].shape[2], page_table.shape[1]
    n_max = int(n_stale.max()) if q.shape[0] else 0
    S = min(NP, -(-n_max // page)) * page
    k, ks = split_kv(gather_pages(k_pages, page_table, S))
    v, vs = split_kv(gather_pages(v_pages, page_table, S))
    return decode_core(q, k_new, v_new, k, v, n_stale, ks, vs, window)


def _paged_prefill_plain(q, k_pages, v_pages, page_table, start, window=0):
    """The prefill kernel's function in plain PyTorch: causal (and, with a
    window, banded) attention of the chunk over the pool (its own keys
    already inserted), keys limited to the table's reach and to the chunk's
    last query position."""
    B, T = q.shape[:2]
    page, NP = split_kv(k_pages)[0].shape[2], page_table.shape[1]
    last = int(start.max()) + T if B else 0
    S = min(NP * page, last)
    k, ks = split_kv(gather_pages(k_pages, page_table, S))
    v, vs = split_kv(gather_pages(v_pages, page_table, S))
    return causal_core(q, k, v, start, ks, vs, window=window)


# ---------------------------------------------------------------------------
# Wrappers: kernel on a CUDA tensor, plain version on a CPU tensor
# ---------------------------------------------------------------------------

def _check_table(name: str, page_table: torch.Tensor, B: int) -> None:
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"{name}: page_table {tuple(page_table.shape)} "
                         f"does not match batch {B}")


def paged_decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, k_pages, v_pages,
                           page_table: torch.Tensor,
                           n_stale: torch.Tensor, *, window: int = 0,
                           pages_per_block: int = 1) -> torch.Tensor:
    """Ragged single-token attention over the STALE page pool plus the new
    token (self column folded into the online-softmax init). The kernel
    splits each slot's key range across blocks and combines the splits
    (``_kernels.decode_splits``, planned from shapes only).

    q: [B, H, Dh] (RoPE applied); k_new/v_new: [B, KV, Dh];
    k_pages/v_pages: [P, KV, page, Dh] or the int8 ``{"q","s"}`` dicts;
    page_table: [B, NP] int32; n_stale: [B] int32 (the query's position; 0
    for a fresh or inactive slot); window: sliding window (0 = full) — only
    pages inside it are read; pages_per_block: run length of a packed table
    (see :func:`_check_pages_per_block`). Returns [B, H*Dh] in q.dtype.
    """
    name = "paged_decode_attention"
    check_window(name, window)
    _check_pages_per_block(pages_per_block, page_table.shape[1],
                           split_kv(k_pages)[0].shape[0])
    if q.device.type == "cpu":
        return _paged_decode_plain(q, k_new, v_new, k_pages, v_pages,
                                   page_table, n_stale, window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    B, H, Dh = q.shape
    KV = k_new.shape[1]
    kq = split_kv(k_pages)[0]
    check_geometry(name, H, KV, Dh, kq.shape, decode=True)
    _check_table(name, page_table, B)
    if k_new.shape != (B, KV, Dh) or v_new.shape != (B, KV, Dh) \
            or split_kv(v_pages)[0].shape != kq.shape \
            or n_stale.shape != (B,):
        raise ValueError(f"{name}: operand shapes disagree")
    quant = check_kernel_args(name, {"q": q, "k_new": k_new, "v_new": v_new},
                              {"k_pages": k_pages, "v_pages": v_pages},
                              {"page_table": page_table, "n_stale": n_stale})
    out = torch.empty((B, H * Dh), dtype=q.dtype, device=q.device)
    page = kq.shape[2]
    plan = _kernels.decode_plan(B, KV, page_table.shape[1] * page, window,
                                page, _kernels.device_sm_count(q.device))
    ws = decode_workspace(plan, B, KV, H // KV, Dh, q.device)
    _kernels.launch_paged_decode(
        q, k_new, v_new, split_kv(k_pages), split_kv(v_pages), quant,
        page_table, n_stale, out, window, pages_per_block, plan, ws)
    count_launch(paged_decode_attention,
                 body_name(window, pages_per_block, quant, Dh, H // KV),
                 split_record(plan, ws))
    return out


reset_launches(paged_decode_attention)


def paged_prefill_attention(q: torch.Tensor, k_pages, v_pages,
                            page_table: torch.Tensor,
                            start: torch.Tensor, *, window: int = 0,
                            pages_per_block: int = 1) -> torch.Tensor:
    """Causal chunk attention over the page pool (keys already inserted).

    q: [B, T, H, Dh] at absolute positions ``start + t`` (any T: the kernel
    masks the ragged tail of its last query tile); k_pages/v_pages:
    [P, KV, page, Dh] or the int8 dicts; page_table: [B, NP] int32; start:
    [B] int32; window, pages_per_block: as :func:`paged_decode_attention`.
    Returns [B, T, H*Dh] in q.dtype.
    """
    name = "paged_prefill_attention"
    check_window(name, window)
    _check_pages_per_block(pages_per_block, page_table.shape[1],
                           split_kv(k_pages)[0].shape[0])
    if q.device.type == "cpu":
        return _paged_prefill_plain(q, k_pages, v_pages, page_table, start,
                                    window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: no kernel for {q.device}")
    B, T, H, Dh = q.shape
    kq = split_kv(k_pages)[0]
    KV = kq.shape[1]
    check_geometry(name, H, KV, Dh, kq.shape, decode=False)
    _check_table(name, page_table, B)
    if split_kv(v_pages)[0].shape != kq.shape or start.shape != (B,):
        raise ValueError(f"{name}: operand shapes disagree")
    quant = check_kernel_args(name, {"q": q},
                              {"k_pages": k_pages, "v_pages": v_pages},
                              {"page_table": page_table, "start": start})
    out = torch.empty((B, T, H * Dh), dtype=q.dtype, device=q.device)
    _kernels.launch_paged_prefill(q, split_kv(k_pages), split_kv(v_pages),
                                  quant, page_table, start, out, window,
                                  pages_per_block)
    count_launch(paged_prefill_attention,
                 body_name(window, pages_per_block, quant, Dh, H // KV))
    return out


reset_launches(paged_prefill_attention)


def make_paged_attention_fn(page_table: torch.Tensor, window: int = 0,
                            pages_per_block: int = 1):
    """Build an ``attention_fn`` (models/llama.py ``forward`` contract) over
    the paged pool, closing over the page table, the model's sliding
    ``window`` (0 = full causal) and the table's ``pages_per_block``.

    The call itself is the prefill chunk path (insert-then-attend); the
    ``.decode`` attribute is the deferred decode (stale pool + self column,
    no insert) and ``.insert_all`` the one stacked insert after the layer
    loop. Unlike the JAX version there is no ``max_seq`` or ``impl``: the
    kernels bound their reads by the table and the lengths, and each
    wrapper picks kernel or plain version by the tensors' device.
    """

    def attention_fn(q, k_new, v_new, layer_k, layer_v, lengths,
                     active=None):
        paged_insert_kv(layer_k, layer_v, k_new, v_new, page_table,
                        lengths, active)
        out = paged_prefill_attention(q, layer_k, layer_v, page_table,
                                      lengths, window=window,
                                      pages_per_block=pages_per_block)
        return out, layer_k, layer_v

    def decode(q, k_new, v_new, layer_k, layer_v, lengths, active=None):
        n_stale = lengths if active is None else torch.where(
            active, lengths, 0)
        out = paged_decode_attention(q[:, 0], k_new[:, 0], v_new[:, 0],
                                     layer_k, layer_v, page_table, n_stale,
                                     window=window,
                                     pages_per_block=pages_per_block)
        return out[:, None, :]

    def insert_all(pool_k, pool_v, k_news, v_news, lengths, active):
        return paged_insert_all(pool_k, pool_v, k_news, v_news, page_table,
                                lengths, active)

    attention_fn.decode = decode
    attention_fn.insert_all = insert_all
    return attention_fn
