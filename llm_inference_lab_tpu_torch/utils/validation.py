"""Token validation (port of llm_inference_lab_tpu/utils/validation.py):
clamp out-of-vocab ids on the tensor's device.

Validation is needed only at the trust boundary (user-supplied prompt ids;
Engine.encode clamps them on the host) and as a cheap invariant check: the
samplers already clamp their outputs.
"""

from __future__ import annotations

from typing import Tuple

import torch


def validate_and_clamp_tokens(tokens: torch.Tensor, vocab_size: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the ids clamped into [0, vocab_size), the count of invalid ids as an
    int32 tensor), both on the tokens' device: no host read."""
    invalid = (tokens < 0) | (tokens >= vocab_size)
    return tokens.clamp(0, vocab_size - 1), invalid.sum(dtype=torch.int32)


def shared_vocab_size(target_vocab: int, draft_vocab: int) -> int:
    """Acceptance compares token ids, so proposals must lie in the vocab the
    draft and the target share."""
    return min(target_vocab, draft_vocab)
