"""Byte-level tokenizer (copy of llm_inference_lab_tpu/utils/tokenizer.py
ByteTokenizer). The card's machine has no ``transformers``, so the port has
no HF tokenizer; the JAX package falls back to this same class offline."""

from __future__ import annotations

from typing import List


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
