"""Build and bind the port's CUDA kernels (``csrc/``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, on first use, from the files in the checkout
only, into ``llmapigateway_tpu_torch/_build/`` (listed in ``.gitignore``).
The sources build in parallel, one ``nvcc`` each, all started together.
Each library is loaded with ``ctypes``: pointers, the stream and scalars go
across as ``c_void_p``/``c_int``/``c_float``, and every C entry returns
``cudaGetLastError()`` after its launch, which the wrapper turns into an
exception. Nothing here runs at import time: the CPU tests import this
module on a machine with no ``nvcc``.

A library's file name carries a digest of its source, every header and the
flags, so an edited kernel is never served from a stale build; one build
per process (and per source version across processes) is reused.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import torch

HEAD_DIMS = (64, 96, 128, 256)      # head widths the attention kernels are compiled for
GROUP_SIZES = (1, 2, 3, 4, 7, 8, 16)    # query heads per KV head the decode kernels take

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("paged_attention", "flash_attention", "kv_insert",
           "w4a8_mm")  # csrc/<name>.cu
HEADERS = ("attention_common.cuh", "decode_split.cuh", "prefill_mma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The decode kernels split each slot's key range across blocks
# (csrc/decode_split.cuh); these mirror its constants.
TILE_K = 32                 # keys per tile; a split is whole tiles
SM_COUNT = 132              # streaming multiprocessors of an H100 SXM: the
                            # planner's default; launches read the card's own
TARGET_WAVES = 16           # blocks aimed at: this many per SM
MIN_SPLIT_TILES = 4         # below this the ring has nothing to overlap
MAX_SPLITS = 64             # csrc/decode_split.cuh MAX_SPLITS

# The prefill body (csrc/prefill_mma.cuh): query rows a block owns and keys
# a tile; these mirror its PrefillGeo.

def prefill_rows(head_dim: int) -> int:
    """Query rows one prefill block owns: 64, or 32 at head widths past
    128 (csrc/prefill_mma.cuh PrefillGeo::BQ)."""
    return 32 if head_dim > 128 else 64


def prefill_tile_keys(head_dim: int) -> int:
    """Keys a prefill tile holds: 64, or 32 at head widths past 128
    (PrefillGeo::KT)."""
    return 32 if head_dim > 128 else 64


def prefill_block_order(n_tiles: int, H: int, B: int) -> list[tuple]:
    """The (query tile, head, slot) each block of a prefill launch's 1-D
    grid takes, in launch order (csrc/prefill_mma.cuh prefill_block): the
    last query tile of every (head, slot) first — it walks the most keys
    under causal masking — then the tile before it, and so on."""
    per = H * B
    return [(n_tiles - 1 - L // per, L % H, (L % per) // H)
            for L in range(n_tiles * per)]


_build_lock = threading.Lock()


@dataclass(frozen=True)
class Build:
    path: Path
    seconds: float          # 0.0 when an existing build was reused
    log: str                # nvcc/ptxas output (registers, shared memory, spills)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for part in (f"{name}.cu", *HEADERS):
        h.update((CSRC_DIR / part).read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def build() -> dict[str, Build]:
    """Compile every source (once per process; an existing build of the
    same sources is reused), all ``nvcc`` processes running at once."""
    with _build_lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        builds: dict[str, Build] = {}
        running = []
        for name in SOURCES:
            target = BUILD_DIR / f"lib{name}-{_digest(name)}.so"
            if target.exists():
                builds[name] = Build(target, 0.0, "")
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            log = tempfile.TemporaryFile(mode="w+", dir=BUILD_DIR)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   str(CSRC_DIR / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                    text=True)
            running.append((name, proc, log, tmp, target, time.monotonic()))
        failed = []
        for name, proc, log, tmp, target, t0 in running:
            rc = proc.wait()
            seconds = time.monotonic() - t0
            log.seek(0)
            text = log.read()
            log.close()
            if rc != 0:
                os.unlink(tmp)
                failed.append(f"{name}.cu: nvcc failed ({rc}):\n"
                              f"{text[-8000:]}")
                continue
            os.replace(tmp, target)        # atomic against concurrent builds
            builds[name] = Build(target, seconds, text)
        if failed:
            raise RuntimeError("\n".join(failed))
        return builds


def unsupported_geometry(head_dim: int, n_heads: int, n_kv_heads: int,
                         decode: bool = True) -> str | None:
    """Why the attention kernels cannot take this head geometry, or None:
    a head width outside ``HEAD_DIMS``, query heads that do not split over
    the KV heads, or (decode only) a group size outside ``GROUP_SIZES``."""
    if head_dim not in HEAD_DIMS:
        return (f"head_dim {head_dim} unsupported; the kernels are built "
                f"for {HEAD_DIMS}")
    if n_kv_heads <= 0 or n_heads % n_kv_heads:
        return (f"{n_heads} query heads do not split over {n_kv_heads} KV "
                f"heads")
    if decode and n_heads // n_kv_heads not in GROUP_SIZES:
        return (f"group of {n_heads // n_kv_heads} query heads per KV head "
                f"unsupported; the decode kernels take groups of "
                f"{GROUP_SIZES}")
    return None


class DecodeSplits(NamedTuple):
    """A decode launch's key split: ``n_split`` blocks per (slot, KV
    head), split s covering positions ``[base + s·split_keys, base +
    (s+1)·split_keys)`` of the slot's live range (``base``: the window
    floor rounded down to a tile)."""
    n_split: int
    split_keys: int


def decode_extent(limit: int, window: int) -> int:
    """The key extent a decode launch's splits must cover: the cache's
    reach ``limit`` (``NP·page`` or ``S``), capped under a window at the
    keys from the tile holding the window's floor (``window + TILE_K``)."""
    return min(limit, window + TILE_K) if window else limit


def decode_splits(B: int, KV: int, extent: int, page: int = 0,
                  sm_count: int = SM_COUNT) -> DecodeSplits:
    """Plan the decode kernels' key split from shapes alone (``n_stale``
    is never read on the host: a sync per layer would stall the step).
    Aim at ``TARGET_WAVES`` (16) blocks per SM over ``B·KV``
    (slot, KV head) pairs, splits of at least ``MIN_SPLIT_TILES`` tiles and
    at most ``MAX_SPLITS``; a split is whole tiles and, on a paged layout
    whose page is whole tiles, whole pages (or a divisor of one), so a
    page's keys are never split between blocks. One split means no
    workspace and no combine."""
    tiles = max(1, -(-extent // TILE_K))
    want = -(-TARGET_WAVES * sm_count // max(1, B * KV))
    n = max(1, min(want, tiles // MIN_SPLIT_TILES, MAX_SPLITS))
    split_tiles = -(-tiles // n)
    if page and page % TILE_K == 0:
        per_page = page // TILE_K
        if split_tiles >= per_page:
            split_tiles = -(-split_tiles // per_page) * per_page
        else:
            while per_page % split_tiles:
                split_tiles += 1
    return DecodeSplits(-(-tiles // split_tiles), split_tiles * TILE_K)


@functools.cache
def decode_plan(B: int, KV: int, limit: int, window: int, page: int = 0,
                sm_count: int = SM_COUNT) -> DecodeSplits:
    """The key split a decode launch runs with: ``decode_splits`` over
    ``decode_extent(limit, window)``, cached per geometry (the wrappers
    plan once per layer call). Splits hold whole pages only without a
    window: a window's floor starts a slot's splits mid-page."""
    return decode_splits(B, KV, decode_extent(limit, window),
                         0 if window else page, sm_count)


@functools.cache
def device_sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors, which the decode planner
    spreads its blocks over."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def workspace_floats(plan: DecodeSplits, B: int, KV: int, G: int,
                     Dh: int) -> int:
    """fp32 workspace of a split decode launch: each split's unnormalised
    acc ``[B, KV, n_split, G, Dh]`` and its m and l ``[B, KV, n_split,
    G]``; none for one split."""
    if plan.n_split == 1:
        return 0
    return B * KV * plan.n_split * G * (Dh + 2)


@functools.cache
def library(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[name].path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "paged_attention":
        lib.paged_decode_attention.argtypes = (
            [ptr] * 11 + [i32] * 6 + [f32] + [i32] * 5 + [ptr])
        lib.paged_prefill_attention.argtypes = (
            [ptr] * 8 + [i32] * 7 + [f32] + [i32] * 3 + [ptr])
        entries = ("paged_decode_attention", "paged_prefill_attention")
    elif name == "kv_insert":
        lib.kv_insert.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
        lib.empty_launch.argtypes = [ptr]
        entries = ("kv_insert", "empty_launch")
    elif name == "w4a8_mm":
        i64 = ctypes.c_longlong
        lib.w4a8_mm.argtypes = ([ptr, i64, ptr, i64] + [ptr] * 3
                                + [i32] * 5 + [ptr])
        entries = ("w4a8_mm",)
    else:
        lib.flash_decode_attention.argtypes = (
            [ptr] * 11 + [i32] * 5 + [f32] + [i32] * 4 + [ptr])
        lib.flash_prefill_attention.argtypes = (
            [ptr] * 8 + [i32] * 6 + [f32] + [i32] * 2 + [ptr])
        entries = ("flash_decode_attention", "flash_prefill_attention")
    for entry in entries:
        getattr(lib, entry).restype = i32
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [i32]
    err.restype = ctypes.c_char_p
    return lib


def _call(lib_name: str, entry: str, device: torch.device, *args) -> None:
    """Launch ``entry`` on the current stream of ``device``; raise on a
    refused launch."""
    lib = library(lib_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        msg = getattr(lib, f"{lib_name}_error_string")(rc).decode()
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc} ({msg})")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


# Each launcher takes (values, scales) pairs for K and V — scales None for a
# bf16 cache — and tensors whose shapes, types and devices the wrapper
# (ops/paged_attention.py, ops/flash_attention.py) has checked; ``window``
# (0: full causal) and, for the paged kernels, ``ppb`` (pages_per_block)
# select the variant. The decode launchers take the wrapper's key split
# (``decode_splits``) and its fp32 workspace (None for one split).

def launch_paged_decode(q, k_new, v_new, k, v, quant, page_table, n_stale,
                        out, window: int, ppb: int, plan: DecodeSplits,
                        ws) -> None:
    B, H, Dh = q.shape
    KV, page = k[0].shape[1], k[0].shape[2]
    _call("paged_attention", "paged_decode_attention", q.device,
          q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k[0].data_ptr(),
          v[0].data_ptr(), _ptr(k[1]), _ptr(v[1]), page_table.data_ptr(),
          n_stale.data_ptr(), out.data_ptr(), _ptr(ws),
          B, H, KV, Dh, page, page_table.shape[1], Dh ** -0.5, int(quant),
          window, ppb, plan.n_split, plan.split_keys)


def launch_paged_prefill(q, k, v, quant, page_table, start, out,
                         window: int, ppb: int) -> None:
    B, T, H, Dh = q.shape
    KV, page = k[0].shape[1], k[0].shape[2]
    _call("paged_attention", "paged_prefill_attention", q.device,
          q.data_ptr(), k[0].data_ptr(), v[0].data_ptr(), _ptr(k[1]),
          _ptr(v[1]), page_table.data_ptr(), start.data_ptr(), out.data_ptr(),
          B, T, H, KV, Dh, page, page_table.shape[1], Dh ** -0.5, int(quant),
          window, ppb)


def launch_flash_decode(q, k_new, v_new, k, v, quant, rows, n_stale,
                        out, window: int, plan: DecodeSplits, ws) -> None:
    B, H, Dh = q.shape
    KV, S = k[0].shape[1], k[0].shape[2]
    _call("flash_attention", "flash_decode_attention", q.device,
          q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k[0].data_ptr(),
          v[0].data_ptr(), _ptr(k[1]), _ptr(v[1]), _ptr(rows),
          n_stale.data_ptr(), out.data_ptr(), _ptr(ws),
          B, H, KV, Dh, S, Dh ** -0.5, int(quant), window, plan.n_split,
          plan.split_keys)


def launch_flash_prefill(q, k, v, quant, rows, start, out,
                         window: int) -> None:
    B, T, H, Dh = q.shape
    KV, S = k[0].shape[1], k[0].shape[2]
    _call("flash_attention", "flash_prefill_attention", q.device,
          q.data_ptr(), k[0].data_ptr(), v[0].data_ptr(), _ptr(k[1]),
          _ptr(v[1]), _ptr(rows), start.data_ptr(), out.data_ptr(),
          B, T, H, KV, Dh, S, Dh ** -0.5, int(quant), window)


def launch_kv_insert(cache, new, lengths) -> None:
    """Kernel #5: row ``new[b, 0, kv]`` into ``cache[b, kv, lengths[b]]``,
    in place (the wrapper, tools/profile_insert.py, checked the operands)."""
    B, KV, S, Dh = cache.shape
    _call("kv_insert", "kv_insert", cache.device, new.data_ptr(),
          cache.data_ptr(), lengths.data_ptr(), B, KV, S,
          Dh * cache.element_size())


def launch_w4a8_mm(xq, x_se: int, xs, xs_se: int, wq, ws, out,
                   out_type: int) -> None:
    """The W4A8 product (csrc/w4a8_mm.cu) over E experts: ``xq`` int8 rows
    of K at ``x_se`` elements per expert (0: shared), ``xs`` fp32 row
    scales at ``xs_se``, ``wq`` packed uint8 ``[E, N, K/2]``, ``ws`` fp32
    ``[E, N]``, into ``out [E, M, N]`` of ``out_type`` (0 fp32, 1 bf16,
    2 fp16, 3 the int32 sums). The wrapper (ops/quant_mm.py) checked the
    operands."""
    E, N, half_k = wq.shape
    M = out.shape[1]
    _call("w4a8_mm", "w4a8_mm", xq.device, xq.data_ptr(), x_se,
          xs.data_ptr(), xs_se, wq.data_ptr(), ws.data_ptr(), out.data_ptr(),
          E, M, N, 2 * half_k, out_type)


def launch_empty(device) -> None:
    """An empty kernel on ``device``'s current stream: the launch-latency
    floor the smoke times beside kernel #5."""
    _call("kv_insert", "empty_launch", device)
