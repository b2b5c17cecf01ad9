"""Tokenizers (port of llm_inference_lab_tpu/utils/tokenizer.py: its
ByteTokenizer copied, get_tokenizer and check_tokenizer_compat).

The card's machine has no ``transformers``, so the port has no HF
tokenizer: ``get_tokenizer`` gives the ByteTokenizer for every name, which
is what the JAX package falls back to offline (no hub cache) and what the
256-vocab fake model takes.
"""

from __future__ import annotations

from typing import List, Optional, Protocol


class Tokenizer(Protocol):
    vocab_size: int
    eos_token_id: Optional[int]

    def encode(self, text: str) -> List[int]: ...

    def decode(self, ids: List[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes as tokens; id 0 reserved as EOS/pad."""

    def __init__(self, vocab_size: int = 256):
        self.vocab_size = vocab_size
        self.eos_token_id = 0

    def encode(self, text: str) -> List[int]:
        ids = [1 + (b % (self.vocab_size - 1)) for b in text.encode("utf-8")]
        return ids or [1]

    def decode(self, ids: List[int]) -> str:
        return bytes((max(i - 1, 0)) % 256 for i in ids if i != 0).decode(
            "utf-8", errors="replace"
        )


def get_tokenizer(name: str, implementation: str = "hf") -> Tokenizer:
    """The tokenizer of model `name`: the ByteTokenizer (no HF tokenizer
    on the card's machine; JAX's offline fallback)."""
    return ByteTokenizer()


def check_tokenizer_compat(target: Tokenizer, draft: Tokenizer) -> bool:
    """Draft and target must share a vocabulary for token-level acceptance."""
    return target.vocab_size == draft.vocab_size
