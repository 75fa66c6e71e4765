"""The safetensors file format on the standard library and torch alone.

A ``.safetensors`` file is an 8-byte little-endian header length N, N bytes
of JSON header, then the raw tensor bytes. The header maps each tensor name
to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets from the
end of the header) and may hold a ``"__metadata__"`` map of strings. The
JAX package reads and writes the format through the ``safetensors``
package, which the GPU hosts do not carry; this module stands in for it.

Only ``BF16``, ``F16`` and ``F32`` tensors are read or written; any other
dtype is refused by name. A tensor's byte offset need not be a multiple of
its element size, so every tensor is copied out of the file into a buffer
of its own (``out``: say a pinned host buffer that is then copied to the
card) and never viewed in place.
"""
from __future__ import annotations

import json
import math
import os
import struct
from pathlib import Path
from typing import Any

import torch

DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32}
_NAMES = {dtype: name for name, dtype in DTYPES.items()}
# A header larger than this is not a header (the format's own limit).
MAX_HEADER_BYTES = 100 * 1024 * 1024


class SafetensorsError(ValueError):
    """A file that is not a well-formed safetensors file, or a tensor of a
    dtype this reader does not take."""


class SafeFile:
    """One safetensors file opened for reading; use as a context manager or
    call :meth:`close`. Tensors are read on demand (the header alone is
    read at open)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._f = open(self.path, "rb")
        try:
            self._read_header()
        except BaseException:
            self._f.close()
            raise

    def _read_header(self) -> None:
        size = os.fstat(self._f.fileno()).st_size
        raw = self._f.read(8)
        if len(raw) != 8:
            raise SafetensorsError(f"{self.path}: shorter than its header "
                                   f"length")
        (n,) = struct.unpack("<Q", raw)
        if n > min(MAX_HEADER_BYTES, size - 8):
            raise SafetensorsError(f"{self.path}: header length {n} exceeds "
                                   f"the file ({size} bytes)")
        try:
            header = json.loads(self._f.read(n))
        except ValueError as e:
            raise SafetensorsError(f"{self.path}: header is not JSON: {e}") \
                from e
        if not isinstance(header, dict):
            raise SafetensorsError(f"{self.path}: header is not an object")
        self._metadata = header.pop("__metadata__", None) or {}
        self._data_start = 8 + n
        self._entries: dict[str, tuple[torch.dtype, tuple[int, ...], int]] = {}
        for name, entry in header.items():
            dtype = DTYPES.get(entry.get("dtype"))
            if dtype is None:
                raise SafetensorsError(
                    f"{self.path}: tensor {name!r} has dtype "
                    f"{entry.get('dtype')!r}; this reader takes "
                    f"{', '.join(DTYPES)}")
            shape = tuple(int(d) for d in entry["shape"])
            begin, end = (int(o) for o in entry["data_offsets"])
            nbytes = math.prod(shape) * dtype.itemsize
            if end - begin != nbytes or begin < 0 \
                    or self._data_start + end > size:
                raise SafetensorsError(
                    f"{self.path}: tensor {name!r} has data_offsets "
                    f"[{begin}, {end}] for {nbytes} bytes of {shape} in a "
                    f"file of {size} bytes")
            self._entries[name] = (dtype, shape, self._data_start + begin)

    # -- metadata ----------------------------------------------------------
    def keys(self) -> list[str]:
        return list(self._entries)

    def metadata(self) -> dict[str, str]:
        return dict(self._metadata)

    def shape(self, name: str) -> tuple[int, ...]:
        return self._entry(name)[1]

    def dtype(self, name: str) -> torch.dtype:
        return self._entry(name)[0]

    def nbytes(self, name: str) -> int:
        dtype, shape, _ = self._entry(name)
        return math.prod(shape) * dtype.itemsize

    def _entry(self, name: str):
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(f"{self.path}: no tensor {name!r}") from None

    # -- data --------------------------------------------------------------
    def get_tensor(self, name: str, out: torch.Tensor | None = None
                   ) -> torch.Tensor:
        """The whole tensor, as a CPU tensor of its own dtype and shape."""
        dtype, shape, start = self._entry(name)
        return self._read(start, dtype, shape, out)

    def get_rows(self, name: str, lo: int, hi: int,
                 out: torch.Tensor | None = None) -> torch.Tensor:
        """Rows ``lo:hi`` of the tensor's first dimension (one read of
        their bytes alone)."""
        dtype, shape, start = self._entry(name)
        if not shape or not 0 <= lo <= hi <= shape[0]:
            raise SafetensorsError(f"{self.path}: rows [{lo}, {hi}) of "
                                   f"{name!r} {shape}")
        row_bytes = math.prod(shape[1:]) * dtype.itemsize
        return self._read(start + lo * row_bytes, dtype,
                          (hi - lo,) + shape[1:], out)

    def _read(self, offset: int, dtype: torch.dtype, shape: tuple[int, ...],
              out: torch.Tensor | None) -> torch.Tensor:
        """Copy ``shape`` elements at ``offset`` into ``out`` (a uint8 CPU
        tensor of at least their bytes, reused by the caller) or a fresh
        buffer; the result views that buffer."""
        nbytes = math.prod(shape) * dtype.itemsize
        if out is None:
            buf = torch.empty(nbytes, dtype=torch.uint8)
        else:
            if out.dtype != torch.uint8 or out.device.type != "cpu" \
                    or not out.is_contiguous() or out.numel() < nbytes:
                raise ValueError(f"out must be a contiguous CPU uint8 tensor "
                                 f"of at least {nbytes} bytes")
            buf = out[:nbytes]
        if nbytes:
            self._f.seek(offset)
            view = memoryview(buf.numpy())
            got = 0
            while got < nbytes:
                n = self._f.readinto(view[got:])
                if not n:
                    raise SafetensorsError(f"{self.path}: truncated at byte "
                                           f"{offset + got}")
                got += n
        return buf.view(dtype).view(shape)

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "SafeFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def safe_open(path: str | Path) -> SafeFile:
    return SafeFile(path)


def save_file(tensors: dict[str, torch.Tensor], path: str | Path,
              metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` (CPU or device; BF16, F16 or F32) as one
    safetensors file: the header padded with spaces to a multiple of 8
    bytes, then each tensor's bytes in the order given."""
    header: dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise SafetensorsError(f"tensor {name!r} has dtype {t.dtype}; "
                                   f"this writer takes {', '.join(DTYPES)}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                flat = t.detach().to("cpu").contiguous().view(-1)
                f.write(memoryview(flat.view(torch.uint8).numpy()))

