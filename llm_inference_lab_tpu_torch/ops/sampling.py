"""Token sampling: the greedy path of llm_inference_lab_tpu/ops/sampling.py
``sample_tokens``. Temperature, top-k/top-p/min-p filters and penalties come
with a later slice."""

from __future__ import annotations

import torch


def sample_tokens(logits: torch.Tensor, greedy: bool = True) -> torch.Tensor:
    """[B, V] logits -> [B] int32 ids (argmax, first maximal index on ties)."""
    if not greedy:
        raise NotImplementedError("stochastic sampling is not ported yet")
    return torch.argmax(logits, dim=-1).to(torch.int32)
