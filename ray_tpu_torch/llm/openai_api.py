"""Tokenization for the OpenAI-compatible surface, from
ray_tpu/llm/openai_api.py.

The reference's ``OpenAIServer`` and ``build_openai_app`` put the serving
replica behind ``ray_tpu.serve``'s HTTP ingress and its streaming response
descriptors, which are runtime services the port does not import; they are
not ported. What the surface needs from the model side is here: the
dependency-free reversible byte-level tokenizer and the incremental
detokenizer that turns streamed tokens into text deltas.
"""

from __future__ import annotations

import codecs
from typing import List, Sequence

__all__ = ["ByteTokenizer"]


class ByteTokenizer:
    """Reversible byte-level tokenizer: token = byte + offset (ids 0..2
    reserved for pad/bos/eos)."""

    OFFSET = 3

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        return [b + self.OFFSET for b in text.encode("utf-8")]

    def decode(self, tokens: Sequence[int]) -> str:
        return bytes(max(0, min(255, t - self.OFFSET))
                     for t in tokens if t >= self.OFFSET
                     ).decode("utf-8", errors="replace")


class _Detokenizer:
    """Incremental token -> text for streaming deltas.  Byte-level
    tokenizers hold incomplete UTF-8 sequences back (a multi-byte char
    split across chunks must not emit replacement glyphs); generic
    tokenizers fall back to full-decode prefix deltas."""

    def __init__(self, tokenizer):
        self._tok = tokenizer
        self._byte = isinstance(tokenizer, ByteTokenizer)
        if self._byte:
            self._dec = codecs.getincrementaldecoder("utf-8")("replace")
        else:
            self._all: List[int] = []
            self._emitted = ""

    def feed(self, token: int) -> str:
        if self._byte:
            if token < ByteTokenizer.OFFSET:
                return ""
            return self._dec.decode(
                bytes([max(0, min(255, token - ByteTokenizer.OFFSET))]))
        self._all.append(token)
        text = self._tok.decode(self._all)
        delta = text[len(self._emitted):]
        self._emitted = text
        return delta
