"""Incremental UTF-8-safe streaming detokenizer (copy of
``cake_tpu/utils/token_stream.py``, which the port may not import).

Emit text only when the decoded string grows and ends in an alphanumeric
character, so multi-token UTF-8 sequences and merge-dependent spaces are
never split; ``decode_rest`` flushes the tail.
"""

from __future__ import annotations

from typing import Protocol


class _Decoder(Protocol):
    def decode(self, ids: list[int]) -> str: ...


class TokenOutputStream:
    """Wraps any object with ``decode(list[int]) -> str`` (HF ``tokenizers``
    and ``transformers`` tokenizers both qualify)."""

    def __init__(self, tokenizer: _Decoder):
        self.tokenizer = tokenizer
        self.tokens: list[int] = []
        self.prev_index = 0
        self.current_index = 0

    def _decode(self, ids: list[int]) -> str:
        return self.tokenizer.decode(ids)

    def next_token(self, token: int) -> str | None:
        """Feed one token id; return newly-safe text or None."""
        prev_text = (
            self._decode(self.tokens[self.prev_index : self.current_index])
            if self.tokens
            else ""
        )
        self.tokens.append(token)
        text = self._decode(self.tokens[self.prev_index :])
        if len(text) > len(prev_text) and text and text[-1].isalnum():
            out = text[len(prev_text) :]
            self.prev_index = self.current_index
            self.current_index = len(self.tokens)
            return out
        return None

    def decode_rest(self) -> str | None:
        """Flush any withheld tail text."""
        prev_text = (
            self._decode(self.tokens[self.prev_index : self.current_index])
            if self.tokens
            else ""
        )
        text = self._decode(self.tokens[self.prev_index :])
        if len(text) > len(prev_text):
            return text[len(prev_text) :]
        return None

    def clear(self) -> None:
        self.tokens.clear()
        self.prev_index = 0
        self.current_index = 0
