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

Kernels (``csrc/paged_attention.cu``, built and bound by ops/_kernels.py):

* :func:`paged_decode_attention` replaces the Pallas kernel
  ``paged_decode_attention`` / ``_paged_decode_kernel``
  (llmapigateway_tpu/ops/paged_attention.py:272, :204).
* :func:`paged_prefill_attention` replaces ``paged_prefill_attention`` /
  ``_paged_prefill_kernel`` (:438, :384).

Each wrapper counts its kernel launches in a plain integer attribute
(``paged_decode_attention.launches``), incremented only where the kernel is
launched, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.config import ModelConfig
from ..models.llama import dense_decode_attention
from . import _kernels
from .flash_attention import NEG_INF, attend_block


class PagedKVCache(NamedTuple):
    """k, v: [L, P, KV, page, Dh] — the global page pool per layer. The
    engine updates it in place (the JAX package's pool is an immutable
    array threaded through the step programs; here one allocation lives
    for the engine's lifetime)."""
    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, config: ModelConfig, num_pages: int, page_size: int,
               dtype=torch.bfloat16, device="cpu") -> "PagedKVCache":
        shape = (config.n_layers, num_pages, config.n_kv_heads, page_size,
                 config.head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


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


def paged_insert_kv(layer_k: torch.Tensor, layer_v: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    page_table: torch.Tensor, lengths: torch.Tensor,
                    active: torch.Tensor | None):
    """Scatter new tokens into one layer's page pool at logical positions
    ``[lengths, lengths+T)`` per slot, IN PLACE (the JAX version returns new
    pools). layer_k/v: [P, KV, page, Dh]; k_new/v_new: [B, T, KV, Dh];
    page_table: [B, NP]; lengths: [B]. Inactive slots and positions past
    the table's reach land on trash page 0. Returns the (same) pools."""
    KV, page, Dh = layer_k.shape[1:]
    B, T = k_new.shape[:2]
    phys, off = _write_targets(page_table, lengths, T, page, active)
    # Advanced indices separated by a slice: the indexed view is
    # [B*T, KV, Dh], matching the flattened new tokens.
    layer_k[phys, :, off] = k_new.reshape(B * T, KV, Dh).to(layer_k.dtype)
    layer_v[phys, :, off] = v_new.reshape(B * T, KV, Dh).to(layer_v.dtype)
    return layer_k, layer_v


def paged_insert_all(pool_k: torch.Tensor, pool_v: torch.Tensor,
                     k_news: torch.Tensor, v_news: torch.Tensor,
                     page_table: torch.Tensor, lengths: torch.Tensor,
                     active: torch.Tensor | None):
    """Insert every layer's new tokens into the stacked pool with one
    scatter per side, IN PLACE (the paged half of the deferred-insert
    protocol). pool_k/v: [L, P, KV, page, Dh]; k_news/v_news:
    [L, B, T, KV, Dh]; lengths: [B] — the first token's logical position.
    Masked/overflow writes land on trash page 0. Returns the pools."""
    page = pool_k.shape[3]
    L, B, T = k_news.shape[:3]
    phys, off = _write_targets(page_table, lengths, T, page, active)

    def scatter(pool, news):
        # Indexed view of pool[:, phys, :, off] is [B*T, L, KV, Dh].
        pool[:, phys, :, off] = news.permute(1, 2, 0, 3, 4).reshape(
            B * T, L, *news.shape[3:]).to(pool.dtype)

    scatter(pool_k, k_news)
    scatter(pool_v, v_news)
    return pool_k, pool_v


def gather_pages(layer_pages: torch.Tensor, page_table: torch.Tensor,
                 max_seq: int) -> torch.Tensor:
    """Materialize the dense [B, KV, S, Dh] view of one layer's pool — the
    plain versions' input; the kernels read the pool in place."""
    KV, page = layer_pages.shape[1], layer_pages.shape[2]
    NP = page_table.shape[1]
    n_pages = min(NP, (max_seq + page - 1) // page)
    picked = layer_pages[page_table[:, :n_pages].long()]  # [B, n, KV, page, Dh]
    picked = picked.movedim(1, 2)                         # [B, KV, n, page, Dh]
    seq = picked.reshape(page_table.shape[0], KV, n_pages * page,
                         *picked.shape[4:])
    return seq[:, :, :max_seq]


def _paged_reference_core(q: torch.Tensor, dense_k: torch.Tensor,
                          dense_v: torch.Tensor, lengths: torch.Tensor,
                          active: torch.Tensor | None, T: int):
    """Causal attention of a chunk over a gathered dense view WITHOUT
    re-inserting, in fp32 through the shared block update. q [B, T, H, Dh]
    at positions lengths + t; dense_k/v [B, KV, S, Dh] → [B, T, H*Dh] in
    q.dtype. GQA is grouped (queries [B, KV, G·T, Dh]), never repeated."""
    B, _, H, Dh = q.shape
    KV, S = dense_k.shape[1], dense_k.shape[2]
    G = H // KV
    qg = q.reshape(B, T, KV, G, Dh).permute(0, 2, 3, 1, 4).reshape(
        B, KV, G * T, Dh)
    q_pos = lengths.long()[:, None] + torch.arange(T, device=q.device)
    visible = (torch.arange(S, device=q.device)[None, None, :]
               <= q_pos[:, :, None])                               # [B, T, S]
    if active is not None:
        visible = visible & active[:, None, None]
    visible = visible[:, None].expand(B, G, T, S).reshape(B, 1, G * T, S)
    m = torch.full((B, KV, G * T, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, G * T, Dh), device=q.device)
    m, l, acc = attend_block(qg, dense_k, dense_v, m, l, acc, visible)
    out = acc / torch.where(l == 0.0, 1.0, l)
    out = out.reshape(B, KV, G, T, Dh).permute(0, 3, 1, 2, 4)
    return out.reshape(B, T, H * Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Plain versions of the two kernels
# ---------------------------------------------------------------------------

def _paged_decode_plain(q, k_new, v_new, k_pages, v_pages, page_table,
                        n_stale):
    """The decode kernel's function in plain PyTorch: the stale pool up to
    ``n_stale`` plus the self column, all in fp32 (the Pallas kernel
    accumulates P·V in fp32). Gathers pages up to the longest slot's last
    live one; a shorter slot's dead positions are masked out."""
    B, H, Dh = q.shape
    page, NP = k_pages.shape[2], page_table.shape[1]
    n_max = int(n_stale.max()) if B else 0
    S = min(NP, -(-n_max // page)) * page
    dense_k = gather_pages(k_pages, page_table, S).float()
    dense_v = gather_pages(v_pages, page_table, S).float()
    out = dense_decode_attention(q[:, None].float(), k_new[:, None].float(),
                                 v_new[:, None].float(), dense_k, dense_v,
                                 n_stale)
    return out.reshape(B, H * Dh).to(q.dtype)


def _paged_prefill_plain(q, k_pages, v_pages, page_table, start):
    """The prefill kernel's function in plain PyTorch: causal attention of
    the chunk over the pool (its own keys already inserted), keys limited to
    the table's reach and to the chunk's last query position."""
    B, T = q.shape[:2]
    page, NP = k_pages.shape[2], page_table.shape[1]
    last = int(start.max()) + T if B else 0
    S = min(NP * page, last)
    dense_k = gather_pages(k_pages, page_table, S)
    dense_v = gather_pages(v_pages, page_table, S)
    return _paged_reference_core(q, dense_k, dense_v, start, None, T)


# ---------------------------------------------------------------------------
# Wrappers: kernel on a CUDA tensor, plain version on a CPU tensor
# ---------------------------------------------------------------------------

def _check_kernel_args(name: str, floats: dict, ints: dict) -> None:
    """Device, dtype and contiguity checks before pointers go to a kernel:
    one CUDA device for every operand, bf16 activations and pools, int32
    tables, contiguous and 16-byte aligned (the kernels load 16 bytes a
    thread)."""
    dev = next(iter(floats.values())).device
    for arg, t in {**floats, **ints}.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    for arg, t in floats.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {arg} is {t.dtype}; the kernel takes "
                            f"bfloat16")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte aligned")
    for arg, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} is {t.dtype}; expected int32")


def _check_geometry(name: str, H: int, KV: int, Dh: int, pages_shape,
                    page_table: torch.Tensor, B: int) -> None:
    if Dh != _kernels.HEAD_DIM:
        raise ValueError(f"{name}: head_dim {Dh} unsupported; the kernel is "
                         f"built for {_kernels.HEAD_DIM}")
    if KV <= 0 or H % KV or (H // KV) not in _kernels.GROUP_SIZES:
        raise ValueError(f"{name}: {H} query heads over {KV} KV heads; the "
                         f"kernel takes groups of {_kernels.GROUP_SIZES}")
    if len(pages_shape) != 4 or pages_shape[1] != KV or pages_shape[3] != Dh:
        raise ValueError(f"{name}: pool shape {tuple(pages_shape)} does not "
                         f"match KV={KV}, Dh={Dh}")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"{name}: page_table {tuple(page_table.shape)} "
                         f"does not match batch {B}")


def paged_decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           n_stale: torch.Tensor) -> torch.Tensor:
    """Ragged single-token attention over the STALE page pool plus the new
    token (self column folded into the online-softmax init).

    q: [B, H, Dh] (RoPE applied); k_new/v_new: [B, KV, Dh];
    k_pages/v_pages: [P, KV, page, Dh]; page_table: [B, NP] int32;
    n_stale: [B] int32 (the query's position; 0 for a fresh or inactive
    slot). Returns [B, H*Dh] in q.dtype.
    """
    if q.device.type == "cpu":
        return _paged_decode_plain(q, k_new, v_new, k_pages, v_pages,
                                   page_table, n_stale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    B, H, Dh = q.shape
    KV = k_new.shape[1]
    _check_geometry("paged_decode_attention", H, KV, Dh, k_pages.shape,
                    page_table, B)
    if k_new.shape != (B, KV, Dh) or v_new.shape != (B, KV, Dh) \
            or v_pages.shape != k_pages.shape or n_stale.shape != (B,):
        raise ValueError("paged_decode_attention: operand shapes disagree")
    _check_kernel_args(
        "paged_decode_attention",
        {"q": q, "k_new": k_new, "v_new": v_new, "k_pages": k_pages,
         "v_pages": v_pages},
        {"page_table": page_table, "n_stale": n_stale})
    out = torch.empty((B, H * Dh), dtype=q.dtype, device=q.device)
    _kernels.launch_decode(q, k_new, v_new, k_pages, v_pages, page_table,
                           n_stale, out)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, page_table: torch.Tensor,
                            start: torch.Tensor) -> torch.Tensor:
    """Causal chunk attention over the page pool (keys already inserted).

    q: [B, T, H, Dh] at absolute positions ``start + t`` (any T: the kernel
    masks the ragged tail of its last query tile); k_pages/v_pages:
    [P, KV, page, Dh]; page_table: [B, NP] int32; start: [B] int32.
    Returns [B, T, H*Dh] in q.dtype.
    """
    if q.device.type == "cpu":
        return _paged_prefill_plain(q, k_pages, v_pages, page_table, start)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: no kernel for {q.device}")
    B, T, H, Dh = q.shape
    KV = k_pages.shape[1]
    _check_geometry("paged_prefill_attention", H, KV, Dh, k_pages.shape,
                    page_table, B)
    if v_pages.shape != k_pages.shape or start.shape != (B,):
        raise ValueError("paged_prefill_attention: operand shapes disagree")
    _check_kernel_args(
        "paged_prefill_attention",
        {"q": q, "k_pages": k_pages, "v_pages": v_pages},
        {"page_table": page_table, "start": start})
    out = torch.empty((B, T, H * Dh), dtype=q.dtype, device=q.device)
    _kernels.launch_prefill(q, k_pages, v_pages, page_table, start, out)
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0


def make_paged_attention_fn(page_table: torch.Tensor):
    """Build an ``attention_fn`` (models/llama.py ``forward`` contract) over
    the paged pool, closing over the page table.

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
                                      lengths)
        return out, layer_k, layer_v

    def decode(q, k_new, v_new, layer_k, layer_v, lengths, active=None):
        n_stale = lengths if active is None else torch.where(
            active, lengths, 0)
        out = paged_decode_attention(q[:, 0], k_new[:, 0], v_new[:, 0],
                                     layer_k, layer_v, page_table, n_stale)
        return out[:, None, :]

    def insert_all(pool_k, pool_v, k_news, v_news, lengths, active):
        return paged_insert_all(pool_k, pool_v, k_news, v_news, page_table,
                                lengths, active)

    attention_fn.decode = decode
    attention_fn.insert_all = insert_all
    return attention_fn
