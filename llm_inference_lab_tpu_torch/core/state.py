"""DecodeState: the decoding state of a batch, as tensors on the device.

Port of llm_inference_lab_tpu/core/state.py with only the fields the ported
slice reads. Invariants (as in the JAX package):

* ``tokens[b, :lengths[b]]`` are the committed tokens of sequence b; the
  buffer beyond is scratch.
* Both KV caches hold exactly the committed tokens [0, lengths[b]-1): all but
  the last committed token. Cache slot index == absolute position.
* ``active[b]`` is False once b hit EOS, its budget or the buffer end;
  inactive lanes still flow through the batched step but commit nothing.

The steps return a new DecodeState; the KV caches inside are updated in
place by the forwards.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from llm_inference_lab_tpu_torch.models.base import KVCache, Model


@dataclass
class DecodeState:
    tokens: torch.Tensor  # [B, max_len] int32
    lengths: torch.Tensor  # [B] int32 — committed length L
    prompt_lens: torch.Tensor  # [B] int32
    max_new: torch.Tensor  # [B] int32 — per-sequence generation budget
    active: torch.Tensor  # [B] bool
    target_cache: KVCache
    draft_cache: Optional[KVCache]
    proposed: torch.Tensor  # [B] int32 — draft tokens proposed
    accepted: torch.Tensor  # [B] int32 — draft tokens accepted
    bonus: torch.Tensor  # [B] int32 — bonus/fallback tokens emitted
    token_logprobs: torch.Tensor  # [B, max_len] f32 — target log-prob per token
    steps: int = 0  # decode steps run (counted on the host: the loop is there)


def init_state(target_model: Model, draft_model: Optional[Model], batch_size: int,
               max_seq_len: int, device, max_new_tokens: int = 64) -> DecodeState:
    B = batch_size

    def zeros_i32(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return DecodeState(
        tokens=zeros_i32(B, max_seq_len),
        lengths=zeros_i32(B),
        prompt_lens=zeros_i32(B),
        max_new=torch.full((B,), max_new_tokens, dtype=torch.int32, device=device),
        active=torch.zeros((B,), dtype=torch.bool, device=device),
        target_cache=target_model.init_cache(B, max_seq_len, device),
        draft_cache=(draft_model.init_cache(B, max_seq_len, device)
                     if draft_model is not None else None),
        proposed=zeros_i32(B),
        accepted=zeros_i32(B),
        bonus=zeros_i32(B),
        token_logprobs=torch.zeros((B, max_seq_len), dtype=torch.float32, device=device),
    )
