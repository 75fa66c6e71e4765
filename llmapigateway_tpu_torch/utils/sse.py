"""Server-Sent Events frame parsing and formatting (a copy of the JAX
package's ``utils/sse.py``; the remote providers' in-band error sniffing
comes with them)."""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Iterator

SSE_DONE = "[DONE]"


def format_sse(data: Any) -> bytes:
    """Format one SSE data frame. `data` may be a dict (JSON-encoded) or str.
    Embedded newlines become multiple ``data:`` lines per the SSE spec (a bare
    continuation line would be silently dropped by conforming clients)."""
    if isinstance(data, (dict, list)):
        payload = json.dumps(data, ensure_ascii=False, separators=(",", ":"))
    else:
        payload = str(data)
    body = "".join(f"data: {line}\n" for line in payload.split("\n"))
    return (body + "\n").encode()


@dataclass
class SSEFrame:
    """One parsed SSE event: raw data string plus lazily-parsed JSON."""
    data: str
    _json: Any = field(default=None, repr=False)
    _json_tried: bool = field(default=False, repr=False)

    @property
    def is_done(self) -> bool:
        return self.data.strip() == SSE_DONE

    @property
    def json(self) -> Any | None:
        """The frame's JSON payload, or None if not JSON / is [DONE]."""
        if not self._json_tried:
            self._json_tried = True
            s = self.data.strip()
            if s and s != SSE_DONE and s[0] in "{[":
                try:
                    self._json = json.loads(s)
                except ValueError:
                    self._json = None
        return self._json


class SSEParser:
    """Incremental byte-stream → SSEFrame parser with partial-frame buffering.

    Frames are delimited by a blank line; multiple ``data:`` lines in one
    event are joined per the SSE spec. Tolerates ``\\r\\n`` line endings and
    incomplete trailing frames (kept in the buffer until the next feed).
    """

    def __init__(self) -> None:
        self._buf = b""

    def feed(self, chunk: bytes) -> Iterator[SSEFrame]:
        self._buf += chunk
        while True:
            # Find the earliest blank-line delimiter (\n\n or \r\n\r\n).
            idx_nn = self._buf.find(b"\n\n")
            idx_rr = self._buf.find(b"\r\n\r\n")
            if idx_nn == -1 and idx_rr == -1:
                return
            if idx_rr != -1 and (idx_nn == -1 or idx_rr < idx_nn):
                raw, self._buf = self._buf[:idx_rr], self._buf[idx_rr + 4:]
            else:
                raw, self._buf = self._buf[:idx_nn], self._buf[idx_nn + 2:]
            frame = self._parse_event(raw)
            if frame is not None:
                yield frame

    def flush(self) -> Iterator[SSEFrame]:
        """Parse whatever remains in the buffer as a final (unterminated) event."""
        if self._buf.strip():
            frame = self._parse_event(self._buf)
            self._buf = b""
            if frame is not None:
                yield frame
        else:
            self._buf = b""

    @staticmethod
    def _parse_event(raw: bytes) -> SSEFrame | None:
        data_lines: list[str] = []
        for line in raw.decode("utf-8", errors="replace").splitlines():
            if line.startswith("data:"):
                data_lines.append(line[5:].lstrip(" "))
            # comment lines (":") and other fields (event:, id:) are ignored
        if not data_lines:
            return None
        return SSEFrame(data="\n".join(data_lines))
