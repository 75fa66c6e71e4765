"""The integer products of the quantized projections (models/quant.py):
W8A8 through ``torch._int_mm`` and W4A8 through a hand-written kernel.

The JAX package computes both with XLA's ``dot_general`` and an int32
accumulator, outside any Pallas kernel (llmapigateway_tpu/models/quant.py:
171, 185, 199, 214); there is no TPU kernel to port.

* :func:`int8_mm` — ``xq [M, K] int8 @ wq [K, N] int8 → int32 [M, N]``,
  exact. On the card it is one library call, ``torch._int_mm`` (cuBLASLt),
  as the bf16 projections are ``torch.matmul``. That call refuses a matrix
  of few rows (:data:`INT_MM_MIN_ROWS`), so a short product's rows are
  zero-padded first, into a tensor of the call's own, and the pad rows'
  sums are dropped. Inside a decode graph's capture that tensor comes from
  the graph's private pool and keeps its address on every replay; nothing
  is shared between calls, so engines that run at once never see each
  other's rows.
  K and N must be multiples of 8 there; a shape the call refuses raises.
* :func:`w4a8_mm` — int8 activations times packed int4 weights, over a
  leading expert batch, rescaled in the kernel's epilogue:
  ``out[e, m, n] = float(Σ_k xq·wq) · xs[e, m] · ws[e, n]`` in the output
  type; its kernel is ``csrc/w4a8_mm.cu``: a dp4a body for one or two
  rows and two tensor-core bodies (decode rows, prefill tiles), which
  ``_kernels.w4a8_plan`` picks from the shape; a shape it refuses (K or N
  not a multiple of 128) raises. ``acc=True``
  returns the int32 sums instead (the debug entry the smoke compares bit
  for bit).

Weights are stored N-major, one output channel's contraction contiguous
(the HF checkpoint's own ``[out, in]`` orientation), and handed over as the
``[K, N]`` view the JAX layout names: for int8 that view is what cuBLASLt's
int8 product reads fastest (A transposed); for int4 the physical tensor is
``[..., N, K/2]`` uint8, two levels a byte (:func:`pack_int4`).

Each wrapper counts its launches in ``.launches`` and per shape in
``.body_launches`` (``"K4096/N14336"``), only where the card runs it. On a
CPU tensor it runs its plain version; on a CUDA tensor it launches or
raises — there is no fallback to a dequantized bf16 product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _kernels
from .flash_attention import count_launch, reset_launches

# torch._int_mm on CUDA needs more than 16 rows (probed on the card, see
# PERF.md); fewer are padded to this many.
INT_MM_MIN_ROWS = 17

_OUT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ACC = 3


# ---------------------------------------------------------------------------
# The packed int4 layout
# ---------------------------------------------------------------------------

def pack_int4(levels: torch.Tensor) -> torch.Tensor:
    """int8 levels in [-7, 7], ``[..., K]`` with K even → uint8
    ``[..., K/2]``: byte j holds level 2j in its low nibble and 2j + 1 in
    its high nibble, each as a two's-complement nibble."""
    if levels.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even last dim, got "
                         f"{tuple(levels.shape)}")
    v = levels.to(torch.int32) & 0xF
    return (v[..., 0::2] | (v[..., 1::2] << 4)).to(torch.uint8).contiguous()


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`pack_int4`: uint8 ``[..., K/2]`` → int8
    ``[..., K]``."""
    p = packed.to(torch.int32)
    nib = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1)
    nib = nib - ((nib & 8) << 1)                 # sign-extend the nibble
    return nib.flatten(-2).to(torch.int8)


def unpack_weight(q: torch.Tensor) -> torch.Tensor:
    """A packed int4 weight's ``[..., K/2, N]`` view → its int8 levels as
    the ``[..., K, N]`` view of an N-major tensor."""
    return unpack_int4(q.transpose(-1, -2)).transpose(-1, -2)


# ---------------------------------------------------------------------------
# W8A8: torch._int_mm
# ---------------------------------------------------------------------------

def int_mm_library(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm(xq, wq)`` with the row padding the card's call
    needs (none on the CPU): the library product, uncounted."""
    M = xq.shape[0]
    if xq.device.type == "cuda" and M < INT_MM_MIN_ROWS:
        return torch._int_mm(F.pad(xq, (0, 0, 0, INT_MM_MIN_ROWS - M)),
                             wq)[:M]
    return torch._int_mm(xq, wq)


def int8_mm_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The plain W8A8 product: exact in fp64 (every partial sum of K
    products of two int8 levels is an integer far below 2^53)."""
    return (xq.double() @ wq.double()).to(torch.int32)


def _check_int8(xq, wq):
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"int8_mm needs [M, K] @ [K, N], got "
                         f"{tuple(xq.shape)} @ {tuple(wq.shape)}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"int8_mm needs int8 operands, got {xq.dtype}, "
                         f"{wq.dtype}")
    if xq.device != wq.device:
        raise ValueError(f"int8_mm operands on {xq.device} and {wq.device}")


def int8_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``xq [M, K] @ wq [K, N]`` → int32 ``[M, N]``, exact: the library
    product on the card, the plain version on the CPU."""
    _check_int8(xq, wq)
    if xq.device.type == "cuda":
        out = int_mm_library(xq, wq)
        count_launch(int8_mm, f"K{wq.shape[0]}/N{wq.shape[1]}")
        return out
    if xq.device.type == "cpu":
        return int8_mm_plain(xq, wq)
    raise ValueError(f"int8_mm: unsupported device {xq.device}")


reset_launches(int8_mm)


# ---------------------------------------------------------------------------
# W4A8: csrc/w4a8_mm.cu
# ---------------------------------------------------------------------------

def _check_w4a8(xq, xs, wq, ws, out_dtype):
    if xq.dim() != 3 or wq.dim() != 3 or xs.shape != (*xq.shape[:2], 1):
        raise ValueError(f"w4a8_mm needs xq [E, M, K], xs [E, M, 1], "
                         f"wq [E, K/2, N]; got {tuple(xq.shape)}, "
                         f"{tuple(xs.shape)}, {tuple(wq.shape)}")
    E, M, K = xq.shape
    if wq.shape[:2] != (E, K // 2) or K % 2 or ws.shape != (E, wq.shape[2]):
        raise ValueError(f"w4a8_mm: weight {tuple(wq.shape)} / scale "
                         f"{tuple(ws.shape)} do not match xq "
                         f"{tuple(xq.shape)}")
    if (xq.dtype != torch.int8 or wq.dtype != torch.uint8
            or xs.dtype != torch.float32 or ws.dtype != torch.float32):
        raise ValueError(f"w4a8_mm needs int8 x, uint8 packed w and fp32 "
                         f"scales; got {xq.dtype}, {wq.dtype}, {xs.dtype}, "
                         f"{ws.dtype}")
    if out_dtype not in _OUT_TYPES:
        raise ValueError(f"w4a8_mm: unsupported output type {out_dtype}")
    if len({t.device for t in (xq, xs, wq, ws)}) != 1:
        raise ValueError("w4a8_mm operands on different devices")


def w4a8_mm_plain(xq, xs, wq, ws, out_dtype=torch.float32,
                  acc: bool = False) -> torch.Tensor:
    """The plain W4A8 product: unpack the nibbles, then the library int8
    product per expert, then the same fp32 rescale as the kernel."""
    w8 = unpack_weight(wq)
    sums = torch.stack([int_mm_library(xq[e], w8[e])
                        for e in range(xq.shape[0])])
    if acc:
        return sums
    return (sums.float() * xs * ws[:, None, :]).to(out_dtype)


def w4a8_mm(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
            ws: torch.Tensor, out_dtype: torch.dtype = torch.float32,
            acc: bool = False) -> torch.Tensor:
    """``xq [E, M, K]`` int8 (an expert stride of 0 shares the rows),
    ``xs [E, M, 1]`` fp32, ``wq [E, K/2, N]`` the packed view, ``ws
    [E, N]`` fp32 → ``[E, M, N]`` in ``out_dtype`` (or the int32 sums with
    ``acc``)."""
    _check_w4a8(xq, xs, wq, ws, out_dtype)
    if xq.device.type == "cpu":
        return w4a8_mm_plain(xq, xs, wq, ws, out_dtype, acc)
    if xq.device.type != "cuda":
        raise ValueError(f"w4a8_mm: unsupported device {xq.device}")
    E, M, K = xq.shape
    N = wq.shape[2]
    packed = wq.transpose(-1, -2)                   # [E, N, K/2]
    if not packed.is_contiguous():
        raise ValueError("w4a8_mm: the packed weight must be N-major "
                         "(the view of a contiguous [E, N, K/2] tensor)")
    if xq.stride(2) != 1 or xq.stride(1) != K or xq.data_ptr() % 16:
        raise ValueError("w4a8_mm: activation rows must be contiguous and "
                         "16-byte aligned")
    if xs.stride(1) != 1 or not ws.is_contiguous():
        raise ValueError("w4a8_mm: scales must be contiguous per expert")
    out = torch.empty((E, M, N), device=xq.device,
                      dtype=torch.int32 if acc else out_dtype)
    if M == 0:
        return out                                  # nothing to launch
    plan = _kernels.w4a8_plan(E, M, N, K,
                              _kernels.device_sm_count(xq.device))
    # Split K: the partial sums and arrival counters, allocated per call (in
    # a decode graph's capture, from the graph's pool), the counters zeroed
    # on every call and so on every replay.
    work = None
    if plan.workspace_ints:
        work = torch.empty(plan.workspace_ints, device=xq.device,
                           dtype=torch.int32)
        work[-plan.counter_ints:].zero_()
    _kernels.launch_w4a8_mm(xq, xq.stride(0) if E > 1 else 0, xs,
                            xs.stride(0) if E > 1 else 0, packed, ws, out,
                            _ACC if acc else _OUT_TYPES[out_dtype], plan, work)
    count_launch(w4a8_mm, f"K{K}/N{N}", w4a8_record(plan))
    return out


def w4a8_record(plan) -> dict:
    """What a W4A8 launch ran with (``w4a8_mm.body_splits[shape]`` keeps
    its shape's last): the body, n8 row tiles, K splits and workspace
    bytes."""
    return {"body": plan.body, "row_tiles": plan.row_tiles,
            "n_split": plan.n_split, "workspace_bytes": 4 * plan.workspace_ints}


reset_launches(w4a8_mm)
