"""Build and bind the port's CUDA kernels (``csrc/``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, on first use, from the files in the checkout
only, into ``llmapigateway_tpu_torch/_build/`` (listed in ``.gitignore``).
The library is loaded with ``ctypes``: pointers, the stream and scalars go
across as ``c_void_p``/``c_int``/``c_float``, and every C entry returns
``cudaGetLastError()`` after its launch, which the wrapper turns into an
exception. Nothing here runs at import time: the CPU tests import this
module on a machine with no ``nvcc``.

The library's file name carries a digest of the sources and flags, so an
edited kernel is never served from a stale build; one build per process
(and per source version across processes) is reused.
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

import torch

HEAD_DIM = 128                      # the kernels' compiled head width
GROUP_SIZES = (1, 2, 4, 8, 16)      # query heads per KV head the decode kernel takes

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCE = "paged_attention.cu"
HEADERS = ("attention_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (SOURCE, *HEADERS):
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def build() -> Build:
    """Compile the kernels (once per process; an existing build of the same
    sources is reused)."""
    with _build_lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        target = BUILD_DIR / f"libpaged_attention-{_digest()}.so"
        if target.exists():
            return Build(target, 0.0, "")
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / SOURCE)]
        t0 = time.monotonic()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.monotonic() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
        os.replace(tmp, target)        # atomic against concurrent builds
        return Build(target, seconds, proc.stdout + proc.stderr)


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_decode_attention_bf16.argtypes = (
        [ptr] * 8 + [i32] * 6 + [f32, ptr])
    lib.paged_decode_attention_bf16.restype = i32
    lib.paged_prefill_attention_bf16.argtypes = (
        [ptr] * 6 + [i32] * 7 + [f32, ptr])
    lib.paged_prefill_attention_bf16.restype = i32
    lib.pa_error_string.argtypes = [i32]
    lib.pa_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.pa_error_string(rc).decode()})")


def launch_decode(q, k_new, v_new, k_pages, v_pages, page_table, n_stale,
                  out) -> None:
    """Launch the decode kernel on the current stream (shapes and types were
    checked by the wrapper in ops/paged_attention.py)."""
    lib = library()
    B, H, Dh = q.shape
    KV, page = k_pages.shape[1], k_pages.shape[2]
    NP = page_table.shape[1]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_decode_attention_bf16(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            n_stale.data_ptr(), out.data_ptr(),
            B, H, KV, Dh, page, NP, Dh ** -0.5, stream)
    _check(lib, "paged_decode_attention", rc)


def launch_prefill(q, k_pages, v_pages, page_table, start, out) -> None:
    """Launch the prefill kernel on the current stream."""
    lib = library()
    B, T, H, Dh = q.shape
    KV, page = k_pages.shape[1], k_pages.shape[2]
    NP = page_table.shape[1]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_prefill_attention_bf16(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), start.data_ptr(), out.data_ptr(),
            B, T, H, KV, Dh, page, NP, Dh ** -0.5, stream)
    _check(lib, "paged_prefill_attention", rc)
