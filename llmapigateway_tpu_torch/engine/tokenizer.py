"""Tokenization for the local engine (a copy of the JAX package's
``engine/tokenizer.py``).

Two implementations behind one interface:

* :class:`HFTokenizer` — wraps a HuggingFace ``tokenizer.json`` (via the
  ``tokenizers`` library) with the checkpoint's chat template (jinja2, from
  ``tokenizer_config.json``).
* :class:`ByteTokenizer` — dependency-free byte-level fallback used by tests
  and random-init presets: ids 0..255 are raw bytes, specials above.

A model directory with a ``tokenizer.json`` needs both ``tokenizers`` and
``jinja2``: without either, building the tokenizer raises naming the
package. A directory without one falls back to bytes with a warning.

Detokenization for SSE streaming is **incremental and UTF-8-safe**: a token
may end mid-multibyte-character, so :class:`IncrementalDetokenizer` buffers
undecodable tails until the next token completes them.
"""
from __future__ import annotations

import importlib
import json
import logging
from pathlib import Path
from typing import Protocol, Sequence

logger = logging.getLogger(__name__)


class TokenizerLike(Protocol):
    bos_id: int | None
    eos_ids: set[int]
    vocab_size: int

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...
    def decode_bytes(self, ids: Sequence[int]) -> bytes: ...
    def apply_chat_template(self, messages: list[dict], add_generation_prompt: bool = True) -> str: ...


DEFAULT_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "<|{{ message['role'] }}|>\n{{ message['content'] }}\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>\n{% endif %}"
)


class ByteTokenizer:
    """Byte-level tokenizer: id = byte value; specials from 256 up.
    Works with any vocab_size >= 256 + len(specials)."""

    BOS, EOS, PAD = 256, 257, 258

    def __init__(self, vocab_size: int = 512):
        if vocab_size < 260:
            raise ValueError("ByteTokenizer needs vocab_size >= 260")
        self.vocab_size = vocab_size
        self.bos_id = self.BOS
        self.eos_ids = {self.EOS}
        self.pad_id = self.PAD

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        return bytes(i for i in ids if 0 <= i < 256)

    def decode(self, ids: Sequence[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: list[dict],
                            add_generation_prompt: bool = True) -> str:
        parts = [f"<|{m.get('role', 'user')}|>\n{_content_text(m)}\n"
                 for m in messages]
        if add_generation_prompt:
            parts.append("<|assistant|>\n")
        return "".join(parts)


class HFTokenizer:
    """HF tokenizer.json + chat template from tokenizer_config.json."""

    def __init__(self, model_dir: str | Path):
        model_dir = Path(model_dir)
        Tokenizer = _require("tokenizers", model_dir).Tokenizer
        # The chat template renders at every request: a missing jinja2
        # fails the build, not the first request.
        _require("jinja2", model_dir)
        self._tok = Tokenizer.from_file(str(model_dir / "tokenizer.json"))
        self.vocab_size = self._tok.get_vocab_size()

        cfg: dict = {}
        cfg_path = model_dir / "tokenizer_config.json"
        if cfg_path.exists():
            cfg = json.loads(cfg_path.read_text())
        self._chat_template = cfg.get("chat_template") or DEFAULT_CHAT_TEMPLATE

        def _tok_id(value) -> int | None:
            if value is None:
                return None
            if isinstance(value, dict):     # {"content": "<s>", ...}
                value = value.get("content")
            return self._tok.token_to_id(value) if value else None

        self.bos_id = _tok_id(cfg.get("bos_token"))
        self.eos_ids = set()
        eos = _tok_id(cfg.get("eos_token"))
        if eos is not None:
            self.eos_ids.add(eos)
        # Llama-3 chat ends turns with <|eot_id|>; Zephyr-style with <|im_end|>.
        for extra in ("<|eot_id|>", "<|im_end|>", "</s>", "<|end_of_text|>"):
            tid = self._tok.token_to_id(extra)
            if tid is not None:
                self.eos_ids.add(tid)

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        return self.decode(ids).encode("utf-8")

    def apply_chat_template(self, messages: list[dict],
                            add_generation_prompt: bool = True) -> str:
        import jinja2
        env = jinja2.Environment()
        env.globals["raise_exception"] = _jinja_raise
        tmpl = env.from_string(self._chat_template)
        msgs = [{"role": m.get("role", "user"), "content": _content_text(m)}
                for m in messages]
        return tmpl.render(messages=msgs,
                           add_generation_prompt=add_generation_prompt,
                           bos_token="", eos_token="")


def _require(package: str, model_dir: Path):
    """Import ``package`` for the tokenizer of ``model_dir``; without it the
    build fails naming the package (never a silent byte fallback, which
    would serve the checkpoint with the wrong token ids)."""
    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise RuntimeError(
            f"{model_dir / 'tokenizer.json'} needs the {package!r} package, "
            f"which this host does not have") from e


def _jinja_raise(message):
    raise ValueError(message)


def _content_text(message: dict) -> str:
    """OpenAI message content may be a string or a list of typed parts."""
    content = message.get("content", "")
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        return "".join(p.get("text", "") for p in content
                       if isinstance(p, dict) and p.get("type") == "text")
    return str(content)


class IncrementalDetokenizer:
    """Streaming token→text with UTF-8 boundary buffering, O(1) per token.

    Byte-level path: maintain a pending byte tail (≤3 bytes) and emit the
    longest valid UTF-8 prefix as bytes arrive.

    HF path: the sliding-window algorithm — keep ``prefix`` / ``read``
    offsets into the id list; each push decodes only ids[prefix:], emits the
    delta beyond the previously-read prefix once it no longer ends in a
    partial character, then advances the window.
    """

    def __init__(self, tokenizer: TokenizerLike):
        self._tok = tokenizer
        self._byte_mode = isinstance(tokenizer, ByteTokenizer)
        if self._byte_mode:
            self._pending = bytearray()
        else:
            self._ids: list[int] = []
            self._prefix = 0       # window start
            self._read = 0         # ids already fully emitted

    # -- byte-level ----------------------------------------------------------
    def _push_bytes(self, token_id: int) -> str:
        if 0 <= token_id < 256:
            self._pending.append(token_id)
        raw = bytes(self._pending)
        # Longest valid UTF-8 prefix; a partial char is at most 3 bytes.
        for cut in range(len(raw), max(len(raw) - 4, -1), -1):
            try:
                text = raw[:cut].decode("utf-8")
            except UnicodeDecodeError:
                continue
            del self._pending[:cut]
            return text
        return ""

    # -- HF sliding window ---------------------------------------------------
    def _push_hf(self, token_id: int) -> str:
        self._ids.append(token_id)
        window = self._ids[self._prefix:]
        read_text = self._tok.decode(self._ids[self._prefix:self._read])
        full_text = self._tok.decode(window)
        if len(full_text) <= len(read_text) or full_text.endswith("�"):
            return ""          # partial char / merge pending — hold back
        delta = full_text[len(read_text):]
        self._prefix = self._read
        self._read = len(self._ids)
        return delta

    def push(self, token_id: int) -> str:
        if self._byte_mode:
            return self._push_bytes(token_id)
        return self._push_hf(token_id)

    def flush(self) -> str:
        if self._byte_mode:
            raw = bytes(self._pending)
            self._pending.clear()
            return raw.decode("utf-8", errors="replace") if raw else ""
        window = self._ids[self._prefix:]
        read_text = self._tok.decode(self._ids[self._prefix:self._read])
        full_text = self._tok.decode(window)
        self._prefix = self._read = len(self._ids)
        return full_text[len(read_text):]


def load_tokenizer(model_dir: str | Path | None,
                   vocab_size: int = 512) -> TokenizerLike:
    if model_dir:
        path = Path(model_dir)
        if (path / "tokenizer.json").exists():
            return HFTokenizer(path)
        logger.warning("no tokenizer.json under %s; using byte fallback", path)
    return ByteTokenizer(vocab_size=max(512, vocab_size if vocab_size >= 260 else 512))
