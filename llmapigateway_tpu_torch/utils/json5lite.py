"""The JSON5 subset the gateway's files use, on the standard library alone.

``providers.json``, ``models_fallback_rules.json`` and lenient request
bodies are JSON plus ``//`` and ``/* */`` comments and trailing commas. The
JAX package reads them with the ``json5`` package, which the GPU hosts do not
carry; this reader accepts exactly that subset and refuses the rest of
JSON5 (single-quoted strings, unquoted keys, hex numbers, ...) with a
``ValueError`` rather than guessing.
"""
from __future__ import annotations

import json
from typing import Any


def loads(text: str) -> Any:
    """Parse JSON with comments and trailing commas; raises ValueError."""
    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == '"':                                  # copy a string verbatim
            j = i + 1
            while j < n and text[j] != '"':
                j += 2 if text[j] == "\\" else 1
            out.append(text[i:j + 1])
            i = j + 1
        elif text.startswith("//", i):
            nl = text.find("\n", i)
            i = n if nl < 0 else nl
        elif text.startswith("/*", i):
            end = text.find("*/", i + 2)
            if end < 0:
                raise ValueError("unterminated /* comment")
            i = end + 2
        elif c == "'":
            raise ValueError("single-quoted strings are not supported")
        elif c in "}]":
            # Drop a trailing comma before the closing bracket.
            k = len(out) - 1
            while k >= 0 and out[k].isspace():
                k -= 1
            if k >= 0 and out[k] == ",":
                del out[k]
            out.append(c)
            i += 1
        else:
            out.append(c)
            i += 1
    return json.loads("".join(out))
