"""Acceptance policies (port of llm_inference_lab_tpu/core/policies.py).
Only ``longest_prefix``, the greedy default, is ported so far.

Contract: policy(draft_tokens [B,K], target_logits [B,K+1,V]) -> accept_len
[B] int32; only the first K target rows take part (row K is the bonus)."""

from __future__ import annotations

import torch

from llm_inference_lab_tpu_torch.ops.verify import verify_prefix


def longest_prefix(draft_tokens: torch.Tensor, target_logits: torch.Tensor) -> torch.Tensor:
    """Greedy argmax match. The [:, :-1] view is passed as it is: the
    verify_prefix kernel reads it through its strides, with no copy."""
    accept_len, _ = verify_prefix(draft_tokens, target_logits[:, :-1])
    return accept_len

