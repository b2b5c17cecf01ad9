"""Engine configuration: the fields of llm_inference_lab_tpu/config.py
EngineConfig that the ported slice reads.

The slice is vanilla drafting at a fixed K, greedy longest_prefix
acceptance, weight-only int4/int8 and a bf16 or int8 KV cache (per-row
scales), contiguous or paged;
a field of the JAX config with a single ported value has no field here until
a later slice ports a second value for it. So ``prefix_caching`` (off),
``admit_chunk`` (one-shot admission) and ``kv_lazy_pages`` (eager page
reservation, ``kv_lazy_pages=False`` in JAX) have no field yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class EngineConfig:
    base_model: str = "llama-3.2-3b"
    draft_model: Optional[str] = "llama-3.2-1b"
    max_draft: int = 4  # K
    max_seq_len: int = 1024
    max_new_tokens: int = 64
    dtype: str = "bfloat16"
    quantization: Optional[str] = None  # None | "int8" | "int4"
    quantize_embed: bool = False
    embed_bits: int = 8  # 8 (EmbedQuant) or 4 (EmbedQuant4, not ported yet)
    quantized_init: bool = False
    seed: int = 0
    eos_token_id: Optional[int] = None
    # KV cache layout: "contiguous" (one [max_seq] lane per slot) or "paged"
    # (a page pool and per-sequence page tables, models/paged.py).
    kv_layout: str = "contiguous"
    kv_page_size: int = 64
    kv_pages: Optional[int] = None  # pool size; None = slots * pages per sequence + 1
    # KV cache element type: None (the model dtype) or "int8" (symmetric
    # per-row scales, quantized as each row is written).
    kv_quantization: Optional[str] = None  # None | "int8"

    def validate(self) -> None:
        """Reject settings outside the ported slice instead of ignoring them."""
        if self.embed_bits not in (4, 8):
            raise ValueError(f"embed_bits must be 4 or 8, got {self.embed_bits}")
        if self.quantize_embed and self.embed_bits == 4:
            raise NotImplementedError("int4 embedding (EmbedQuant4) is not ported yet")
        if self.quantization not in (None, "int8", "int4"):
            raise ValueError(f"unknown quantization {self.quantization!r}")
        if self.kv_quantization not in (None, "int8"):
            raise ValueError(f"unknown kv_quantization {self.kv_quantization!r}")
        if self.kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_layout {self.kv_layout!r}")
        if self.kv_layout == "paged" and (self.kv_page_size <= 0 or 128 % self.kv_page_size):
            raise ValueError("kv_page_size must divide 128 (buffer bucketing)")
