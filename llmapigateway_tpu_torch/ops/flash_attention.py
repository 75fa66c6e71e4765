"""Flash attention over the contiguous KV cache, and the shared
online-softmax block math of every attention kernel in the port.

Counterpart of the JAX package's ``ops/flash_attention.py``:

* ONE copy of the block update that all the Pallas kernels run
  (``self_column_init`` :60, ``attend_block`` :79), here as plain PyTorch
  helpers that every plain version (this module, ops/paged_attention.py,
  models/llama.py) is built from; its CUDA twin is
  ``csrc/attention_common.cuh``, shared by all four CUDA kernels. All math is
  fp32, as in the Pallas kernels. With an int8 cache the per-key scales
  factor out of the Dh contraction: scores are multiplied by ``ks`` after
  the ``Dh^-½`` factor and before the mask, ``l`` accumulates the unscaled
  probabilities, and ``p = e·vs`` goes into the P·V product.
* :func:`flash_decode_attention` replaces the Pallas kernel
  ``flash_decode_attention`` / ``_decode_kernel`` (llmapigateway_tpu/ops/
  flash_attention.py:186, :147), and :func:`flash_prefill_attention`
  replaces ``flash_prefill_attention`` / ``_prefill_kernel`` (:329, :282).
  Their kernels are ``csrc/flash_attention.cu``.
* :func:`make_cache_attention_fn` adapts them to the model's
  ``attention_fn`` contract (models/llama.py ``forward_hidden``).

Layouts are the JAX package's: ``q`` ``[B, H, Dh]`` (decode) or
``[B, T, H, Dh]`` (prefill); one layer of the cache ``[Bc, KV, S, Dh]``, or
the int8 dict ``{"q": int8 [Bc, KV, S, Dh], "s": fp32 [Bc, KV, 1, S]}``.
Both kernels also take an optional row map ``rows`` ``[B]``: query row
``b`` reads (and the inserts write) cache row ``rows[b]``, so a prefill call
for K slots works on the cache in place (the JAX engine slices each slot's
rows out and scatters them back, engine.py:1006-1025).

Every attention function takes ``window``: a sliding window (mistral
family, HF semantics — key ``j`` is visible to the query at position ``i``
iff ``i - j < window``, the query itself included), 0 for full causal
attention. The kernels then walk only the keys inside the window.

Each wrapper counts its kernel launches in a plain integer attribute
(``flash_decode_attention.launches``), and per body and head geometry in the
dict ``.body_launches`` (``"full/bf16/Dh128/G4"``; see :func:`body_name`),
both incremented only where the kernel is launched; a decode wrapper also
keeps the key split and workspace its body's latest launch ran with in
``.body_splits`` (see :func:`split_record`). It launches the kernel
for a CUDA tensor, takes the plain version for a CPU tensor, and raises for
anything else — it never falls back.
"""
from __future__ import annotations

import torch

from . import _kernels

NEG_INF = -1e30


def self_column_init(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor):
    """Seed a decode's online-softmax state from the SELF column (the new
    token attending itself): m = q·k_new·Dh^-½, l = 1, acc = v_new. The
    cache is STALE — the current token's K/V is not in the cache yet (the
    deferred-insert decode protocol, models/llama.py ``forward_hidden``), and
    it stays full precision under int8 KV.

    q [..., R, Dh]; k_new/v_new [..., 1, Dh] → (m, l, acc), fp32."""
    q = q.float()
    m = (q @ k_new.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    l = torch.ones_like(m)
    acc = v_new.float().expand(*q.shape).clone()
    return m, l, acc


def attend_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                 visible: torch.Tensor, ks: torch.Tensor | None = None,
                 vs: torch.Tensor | None = None):
    """One online-softmax block update over keys ``k``/values ``v`` (float,
    or int8 values whose fp32 conversion is exact); ``visible``
    (broadcastable to ``[..., R, S]``) is the caller's mask; ``ks``/``vs``
    (broadcastable to ``[..., 1, S]``) are the int8 per-key scales. Masked
    scores are NEG_INF (finite), so a row with nothing visible yet
    accumulates exp(0) terms exactly as the kernels do. Returns the new
    (m, l, acc)."""
    q = q.float()
    scores = (q @ k.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if ks is not None:
        scores = scores * ks
    scores = torch.where(visible, scores, NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    e = torch.exp(scores - m_new)
    l = alpha * l + e.sum(dim=-1, keepdim=True)
    p = e if vs is None else e * vs
    acc = acc * alpha + p @ v.float()
    return m_new, l, acc


def split_kv(layer):
    """(values, scales) of one cache side: a float tensor has no scales;
    the int8 dict gives its ``q`` and ``s`` leaves."""
    if isinstance(layer, dict):
        return layer["q"], layer["s"]
    return layer, None


# ---------------------------------------------------------------------------
# Plain cores: fp32 math through the shared block update
# ---------------------------------------------------------------------------

def decode_core(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor, n_stale: torch.Tensor,
                ks: torch.Tensor | None = None,
                vs: torch.Tensor | None = None,
                window: int = 0) -> torch.Tensor:
    """One query per row against its stale keys ``[0, n_stale)`` plus the
    self column; with a ``window``, only keys ``j > n_stale - window`` (the
    query sits at position ``n_stale``; the self column is always inside).
    q [B, H, Dh]; k_new/v_new [B, KV, Dh]; k/v [B, KV, S, Dh]; ks/vs
    [B, KV, 1, S] or None. GQA is grouped (queries [B, KV, G, Dh]), never
    repeated. Returns [B, H*Dh] in q.dtype."""
    B, H, Dh = q.shape
    KV, S = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, Dh)
    m, l, acc = self_column_init(qg, k_new[:, :, None], v_new[:, :, None])
    if S:
        pos = torch.arange(S, device=q.device)[None, :]
        visible = pos < n_stale[:, None]
        if window:
            visible = visible & (pos > n_stale[:, None] - window)
        m, l, acc = attend_block(qg, k, v, m, l, acc,
                                 visible[:, None, None, :], ks, vs)
    return (acc / l).reshape(B, H * Dh).to(q.dtype)


def causal_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                start: torch.Tensor, ks: torch.Tensor | None = None,
                vs: torch.Tensor | None = None,
                active: torch.Tensor | None = None,
                window: int = 0) -> torch.Tensor:
    """Causal attention of a chunk over keys already in the cache (with a
    ``window``, key ``s`` is visible to the query at ``p`` iff
    ``p - window < s <= p``). q [B, T, H, Dh] at positions ``start + t``;
    k/v [B, KV, S, Dh]; ks/vs [B, KV, 1, S] or None → [B, T, H*Dh] in
    q.dtype. A row with nothing visible gives 0, not NaN (the Pallas prefill
    kernel's ``l == 0`` guard)."""
    B, T, H, Dh = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, T, KV, G, Dh).permute(0, 2, 3, 1, 4).reshape(
        B, KV, G * T, Dh)
    q_pos = start.long()[:, None] + torch.arange(T, device=q.device)
    s_pos = torch.arange(S, device=q.device)[None, None, :]
    visible = s_pos <= q_pos[:, :, None]                           # [B, T, S]
    if window:
        visible = visible & (s_pos > q_pos[:, :, None] - window)
    if active is not None:
        visible = visible & active[:, None, None]
    visible = visible[:, None].expand(B, G, T, S).reshape(B, 1, G * T, S)
    m = torch.full((B, KV, G * T, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, G * T, Dh), device=q.device)
    if S:
        m, l, acc = attend_block(qg, k, v, m, l, acc, visible, ks, vs)
    out = acc / torch.where(l == 0.0, 1.0, l)
    out = out.reshape(B, KV, G, T, Dh).permute(0, 3, 1, 2, 4)
    return out.reshape(B, T, H * Dh).to(q.dtype)


def _rows_view(layer, rows: torch.Tensor | None, n: int):
    """The plain versions' input: cache rows ``rows`` (all rows if None),
    keys limited to the first ``n`` positions. (values, scales)."""
    k, ks = split_kv(layer)
    if rows is not None:
        k = k[rows.long()]
        ks = ks[rows.long()] if ks is not None else None
    return k[:, :, :n], (ks[..., :n] if ks is not None else None)


def _flash_decode_plain(q, k_new, v_new, layer_k, layer_v, n_stale,
                        rows=None, window=0):
    """The decode kernel's function in plain PyTorch (fp32 math), keys
    limited to the longest row's live prefix."""
    S = split_kv(layer_k)[0].shape[2]
    n = min(S, int(n_stale.max())) if q.shape[0] else 0
    k, ks = _rows_view(layer_k, rows, n)
    v, vs = _rows_view(layer_v, rows, n)
    return decode_core(q, k_new, v_new, k, v, n_stale, ks, vs, window)


def _flash_prefill_plain(q, layer_k, layer_v, start, rows=None, window=0):
    """The prefill kernel's function in plain PyTorch: causal attention of
    the chunk over the cache (its own keys already inserted), keys limited
    to the cache extent and the chunk's last query position."""
    B, T = q.shape[:2]
    S = split_kv(layer_k)[0].shape[2]
    n = min(S, int(start.max()) + T) if B else 0
    k, ks = _rows_view(layer_k, rows, n)
    v, vs = _rows_view(layer_v, rows, n)
    return causal_core(q, k, v, start, ks, vs, window=window)


# ---------------------------------------------------------------------------
# Argument checks shared by the four kernel wrappers
# ---------------------------------------------------------------------------

def check_kernel_args(name: str, acts: dict, kv: dict, ints: dict) -> bool:
    """Device, dtype, shape and alignment checks before pointers go to a
    kernel: one CUDA device for every operand; bf16 activations; a KV cache
    that is bf16, or int8 values with fp32 scales of the stored
    ``[.., KV, 1, S]`` shape; int32 index tensors; all contiguous, values 16-byte
    aligned (the kernels load 16 bytes a thread). ``kv`` maps a name to a
    cache side (tensor or dict). Returns whether the cache is int8."""
    dev = next(iter(acts.values())).device
    quant = {isinstance(side, dict) for side in kv.values()}
    if len(quant) != 1:
        raise TypeError(f"{name}: K and V caches must both be int8 dicts or "
                        f"both tensors")
    quant = quant.pop()
    tensors = dict(acts)
    for arg, side in kv.items():
        values, scales = split_kv(side)
        tensors[arg] = values
        if quant:
            tensors[f"{arg}['s']"] = scales
            if values.dtype != torch.int8 or scales.dtype != torch.float32:
                raise TypeError(f"{name}: {arg} is ({values.dtype}, "
                                f"{scales.dtype}); the int8 kernel takes "
                                f"(int8, float32)")
            if scales.shape != (*values.shape[:-2], 1, values.shape[-2]):
                raise ValueError(f"{name}: {arg} scales {tuple(scales.shape)}"
                                 f" do not match values "
                                 f"{tuple(values.shape)}")
        elif values.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {arg} is {values.dtype}; the kernel "
                            f"takes bfloat16 (or the int8 dict)")
    for arg, t in acts.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {arg} is {t.dtype}; the kernel takes "
                            f"bfloat16")
    for arg, t in ints.items():
        if t is not None and t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} is {t.dtype}; expected int32")
        tensors[arg] = t
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.dtype in (torch.bfloat16, torch.int8) and t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte aligned")
    return quant


def check_geometry(name: str, H: int, KV: int, Dh: int, values_shape,
                   decode: bool) -> None:
    """The head geometry the kernels are built for (``_kernels.HEAD_DIMS``;
    decode also ``GROUP_SIZES``; prefill takes any H over KV), and a cache
    of that geometry."""
    why = _kernels.unsupported_geometry(Dh, H, KV, decode)
    if why is not None:
        raise ValueError(f"{name}: {why}")
    if len(values_shape) != 4 or values_shape[1] != KV \
            or values_shape[3] != Dh:
        raise ValueError(f"{name}: cache shape {tuple(values_shape)} does "
                         f"not match KV={KV}, Dh={Dh}")


def _check_rows(name: str, rows, B: int) -> None:
    if rows is not None and rows.shape != (B,):
        raise ValueError(f"{name}: rows {tuple(rows.shape)} does not match "
                         f"batch {B}")


def check_window(name: str, window: int) -> None:
    if window < 0:
        raise ValueError(f"{name}: window must be >= 0 (0 = full causal), "
                         f"got {window}")


def decode_workspace(plan, B: int, KV: int, G: int, Dh: int, device):
    """The fp32 workspace of a split decode launch (``plan``:
    ``_kernels.decode_splits``), allocated per call with ``torch.empty`` —
    the kernels allocate nothing; None for one split."""
    n = _kernels.workspace_floats(plan, B, KV, G, Dh)
    return torch.empty(n, dtype=torch.float32, device=device) if n else None


def split_record(plan, ws) -> dict:
    """What a decode launch ran with: its key split (``plan``) and the
    bytes of the workspace it was given (0 for one split)."""
    return {"n_split": plan.n_split, "split_keys": plan.split_keys,
            "workspace_bytes": 0 if ws is None
            else ws.numel() * ws.element_size()}


def variant_name(window: int, pages_per_block: int = 1) -> str:
    """The kernel body a launch ran: ``"full"`` or ``"window"``, and for a
    multi-page paged launch ``"_ppb<n>"`` after it."""
    name = "window" if window else "full"
    return name if pages_per_block == 1 else f"{name}_ppb{pages_per_block}"


def body_name(window: int, pages_per_block: int, quant: bool,
              head_dim: int, group: int) -> str:
    """The body a launch ran and the head geometry it ran at: its variant
    (:func:`variant_name`), KV type, head width and group of query heads per
    KV head, e.g. ``"full_ppb2/int8/Dh128/G4"``."""
    return (f"{variant_name(window, pages_per_block)}/"
            f"{'int8' if quant else 'bf16'}/Dh{head_dim}/G{group}")


def count_launch(fn, body: str, split: dict | None = None) -> None:
    """One kernel launch of wrapper ``fn``'s ``body``: the total
    ``fn.launches`` and ``fn.body_launches[body]``; a decode launch's
    ``split`` (:func:`split_record`) replaces ``fn.body_splits[body]``."""
    fn.launches += 1
    fn.body_launches[body] = fn.body_launches.get(body, 0) + 1
    if split is not None:
        fn.body_splits[body] = split


def reset_launches(fn) -> None:
    fn.launches = 0
    fn.body_launches = {}
    fn.body_splits = {}


# ---------------------------------------------------------------------------
# Wrappers: kernel on a CUDA tensor, plain version on a CPU tensor
# ---------------------------------------------------------------------------

def flash_decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, layer_k, layer_v,
                           n_stale: torch.Tensor,
                           rows: torch.Tensor | None = None, *,
                           window: int = 0) -> torch.Tensor:
    """Ragged single-token attention over a STALE contiguous cache plus the
    new token (self column folded into the online-softmax init). The
    kernel splits each row's key range across blocks and combines the
    splits (``_kernels.decode_splits``, planned from shapes only).

    q: [B, H, Dh] (RoPE applied); k_new/v_new: [B, KV, Dh] (not yet in the
    cache; full precision under int8 KV); layer_k/v: [Bc, KV, S, Dh] or the
    int8 ``{"q","s"}`` dicts; n_stale: [B] int32 (the query's position; 0
    for a fresh or inactive slot); rows: optional [B] int32 cache row of
    each query row (default: row b); window: sliding window (0 = full) —
    the kernel reads only the stale keys inside it. Returns [B, H*Dh] in
    q.dtype.
    """
    name = "flash_decode_attention"
    check_window(name, window)
    if q.device.type == "cpu":
        return _flash_decode_plain(q, k_new, v_new, layer_k, layer_v,
                                   n_stale, rows, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention: no kernel for {q.device}")
    B, H, Dh = q.shape
    KV = k_new.shape[1]
    kq = split_kv(layer_k)[0]
    check_geometry(name, H, KV, Dh, kq.shape, decode=True)
    if k_new.shape != (B, KV, Dh) or v_new.shape != (B, KV, Dh) \
            or split_kv(layer_v)[0].shape != kq.shape \
            or n_stale.shape != (B,) or (rows is None and kq.shape[0] != B):
        raise ValueError(f"{name}: operand shapes disagree")
    _check_rows(name, rows, B)
    quant = check_kernel_args(name, {"q": q, "k_new": k_new, "v_new": v_new},
                              {"layer_k": layer_k, "layer_v": layer_v},
                              {"n_stale": n_stale, "rows": rows})
    out = torch.empty((B, H * Dh), dtype=q.dtype, device=q.device)
    plan = _kernels.decode_plan(B, KV, kq.shape[2], window, 0,
                                _kernels.device_sm_count(q.device))
    ws = decode_workspace(plan, B, KV, H // KV, Dh, q.device)
    _kernels.launch_flash_decode(
        q, k_new, v_new, split_kv(layer_k), split_kv(layer_v), quant, rows,
        n_stale, out, window, plan, ws)
    count_launch(flash_decode_attention,
                 body_name(window, 1, quant, Dh, H // KV),
                 split_record(plan, ws))
    return out


reset_launches(flash_decode_attention)


def flash_prefill_attention(q: torch.Tensor, layer_k, layer_v,
                            start: torch.Tensor,
                            rows: torch.Tensor | None = None, *,
                            window: int = 0) -> torch.Tensor:
    """Causal chunk attention over a contiguous cache (the chunk's keys
    already inserted at ``[start, start+T)``).

    q: [B, T, H, Dh] at absolute positions ``start + t`` (any T: the kernel
    masks the ragged tail of its last query tile; positions past the cache
    extent see the whole cache and are the caller's pads); layer_k/v:
    [Bc, KV, S, Dh] or the int8 dicts; start: [B] int32; rows: optional
    [B] int32 cache rows; window: sliding window (0 = full causal). Returns
    [B, T, H*Dh] in q.dtype.
    """
    name = "flash_prefill_attention"
    check_window(name, window)
    if q.device.type == "cpu":
        return _flash_prefill_plain(q, layer_k, layer_v, start, rows, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_attention: no kernel for {q.device}")
    B, T, H, Dh = q.shape
    kq = split_kv(layer_k)[0]
    KV = kq.shape[1]
    check_geometry(name, H, KV, Dh, kq.shape, decode=False)
    if split_kv(layer_v)[0].shape != kq.shape or start.shape != (B,) \
            or (rows is None and kq.shape[0] != B):
        raise ValueError(f"{name}: operand shapes disagree")
    _check_rows(name, rows, B)
    quant = check_kernel_args(name, {"q": q},
                              {"layer_k": layer_k, "layer_v": layer_v},
                              {"start": start, "rows": rows})
    out = torch.empty((B, T, H * Dh), dtype=q.dtype, device=q.device)
    _kernels.launch_flash_prefill(q, split_kv(layer_k), split_kv(layer_v),
                                  quant, rows, start, out, window)
    count_launch(flash_prefill_attention,
                 body_name(window, 1, quant, Dh, H // KV))
    return out


reset_launches(flash_prefill_attention)


# ---------------------------------------------------------------------------
# attention_fn adapter (models/llama.py forward contract)
# ---------------------------------------------------------------------------

def make_cache_attention_fn(rows: torch.Tensor | None = None,
                            window: int = 0):
    """Build an ``attention_fn`` over the contiguous cache, backed by the
    flash kernels, with the model's sliding ``window`` (0 = full causal). The call is the prefill chunk path (insert, then attend
    with the causal kernel); ``.decode`` is the deferred decode (stale cache
    plus self column in the ragged GQA kernel, no insert) and ``.insert_all``
    the one stacked insert after the layer loop (models/llama.py
    ``insert_kv_stacked``).

    ``rows`` ([B] int32, optional) maps each query row to its cache row, as
    ``make_paged_attention_fn(table)`` takes the slots' page-table rows:
    a prefill call for K slots then reads and writes the cache in place.
    Unlike the JAX version there are no block sizes or ``interpret``: the
    kernels tile internally, and each wrapper picks kernel or plain version
    by the tensors' device.
    """
    from ..models.llama import insert_kv, insert_kv_stacked

    def attention_fn(q, k_new, v_new, layer_k, layer_v, lengths,
                     active=None):
        insert_kv(layer_k, layer_v, k_new, v_new, lengths, active, rows)
        out = flash_prefill_attention(q, layer_k, layer_v, lengths, rows,
                                      window=window)
        return out, layer_k, layer_v

    def decode(q, k_new, v_new, layer_k, layer_v, lengths, active=None):
        n_stale = lengths if active is None else torch.where(
            active, lengths, 0)
        out = flash_decode_attention(q[:, 0], k_new[:, 0], v_new[:, 0],
                                     layer_k, layer_v, n_stale, rows,
                                     window=window)
        return out[:, None, :]

    def insert_all(cache_k, cache_v, k_news, v_news, lengths, active):
        return insert_kv_stacked(cache_k, cache_v, k_news, v_news, lengths,
                                 active, rows)

    attention_fn.decode = decode
    attention_fn.insert_all = insert_all
    return attention_fn
