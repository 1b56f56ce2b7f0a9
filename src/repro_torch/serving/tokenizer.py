"""Tokenizer adapters for the HTTP front end's chat endpoint.

This reproduction has no trained tokenizer, but the chat endpoint needs a
*deterministic, invertible* text <-> token-id codec: multi-turn prefix
sharing works by re-submitting the rendered conversation, so the tokens
of an unchanged history must come out bit-identical every time, and
assistant replies must survive a decode -> re-encode round trip.

Two adapters cover every model the stack serves:

* :class:`ByteTokenizer` — one id per UTF-8 byte, offset past the
  reserved control ids (``0`` pad/BOS, ``1`` EOS — the engines' eos_id).
  Needs ``vocab_size >= 258``; fully invertible, so chat history
  re-encoding reproduces the exact prompt tokens the previous turn
  anchored (the prefix-page join finds them).
* :class:`HashTokenizer` — one id per whitespace word via a stable CRC32
  hash (the completions pseudo-tokenizer, behind the common interface).
  Not invertible — ``decode`` renders space-joined ids — but
  deterministic, so history prefixes still match token-for-token.

``for_vocab`` picks the right one (``None`` for the length-only sim
backend), ``render_chat`` is the fixed chat template both the HTTP layer
and the equivalence tests share.

The port's copy of ``repro.serving.tokenizer``, the same code with its
imports moved to ``repro_torch``.
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, List, Optional, Sequence, Union

#: ids below this are reserved: 0 = pad/BOS, 1 = EOS (StaticEngine eos_id)
BYTE_OFFSET = 2
#: smallest vocabulary the byte codec fits in (256 byte ids + reserved)
MIN_BYTE_VOCAB = BYTE_OFFSET + 256


class ByteTokenizer:
    """Invertible byte-level codec: UTF-8 byte ``b`` <-> id ``b + 2``."""

    invertible = True

    def __init__(self, vocab_size: int):
        if vocab_size < MIN_BYTE_VOCAB:
            raise ValueError(f"ByteTokenizer needs vocab_size >= "
                             f"{MIN_BYTE_VOCAB}, got {vocab_size}")
        self.vocab_size = int(vocab_size)

    def encode(self, text: str) -> List[int]:
        return [b + BYTE_OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        # ids outside the byte range (reserved controls, model-generated
        # ids past 257) carry no text — drop them rather than corrupt the
        # stream; what remains decodes deterministically
        data = bytes(i - BYTE_OFFSET for i in ids
                     if BYTE_OFFSET <= i < MIN_BYTE_VOCAB)
        return data.decode("utf-8", errors="replace")


class HashTokenizer:
    """One id per whitespace word, CRC32-hashed into the vocabulary.
    Deterministic but lossy: ``decode`` renders space-joined ids."""

    invertible = False

    def __init__(self, vocab_size: int):
        if vocab_size < 1:
            raise ValueError(f"vocab_size must be >= 1, got {vocab_size}")
        self.vocab_size = int(vocab_size)

    def encode(self, text: str) -> List[int]:
        words = text.split() or [text or "?"]
        return [zlib.crc32(w.encode()) % self.vocab_size for w in words]

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(f" {i}" for i in ids)


def for_vocab(vocab_size: int) -> Optional[Union[ByteTokenizer, HashTokenizer]]:
    """The codec for a model vocabulary: byte-level when it fits (real
    backends, invertible), hash fallback for tiny vocabularies, ``None``
    for the length-only sim backend (``vocab_size == 0``)."""
    if vocab_size >= MIN_BYTE_VOCAB:
        return ByteTokenizer(vocab_size)
    if vocab_size > 0:
        return HashTokenizer(vocab_size)
    return None


def render_chat(messages: Sequence[Dict[str, Any]],
                add_generation_prompt: bool = True) -> str:
    """Render OpenAI-style chat ``messages`` into one prompt string.

    The template is deliberately minimal and *prefix-stable*: appending a
    message never rewrites earlier text, so turn N+1's rendered prompt
    extends turn N's character-for-character — the property token-level
    prefix sharing (and the session equivalence tests) depend on.
    """
    parts: List[str] = []
    for i, m in enumerate(messages):
        if not isinstance(m, dict):
            raise ValueError(f"messages[{i}] must be an object, "
                             f"got {type(m).__name__}")
        role, content = m.get("role"), m.get("content")
        if not isinstance(role, str) or not role:
            raise ValueError(f"messages[{i}].role must be a non-empty string")
        if not isinstance(content, str):
            raise ValueError(f"messages[{i}].content must be a string")
        parts.append(f"<|{role}|>\n{content}\n")
    if add_generation_prompt:
        parts.append("<|assistant|>\n")
    return "".join(parts)
