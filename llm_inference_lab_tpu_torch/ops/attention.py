"""Decode attention over a length-masked static KV cache.

Port of llm_inference_lab_tpu/ops/attention.py (``attend_xla``'s contract):

    attend(q [B,S,H,D], k_cache [B,KVH,T,D], v_cache [B,KVH,T,D],
           positions [B,S]) -> [B,S,H,D]

A query at absolute position p attends to cache slots [0, p]: the engine
writes new rows at their positions before attending, so no separate length
mask is needed. Only the chain-decode mask is ported; the sliding window,
ring cache, tree mask, softcap, scale override and int8 caches raise.
The work goes to ``flash_decode`` (the kernel on CUDA tensors).
"""

from __future__ import annotations

import torch

from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode


def attend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           positions: torch.Tensor, *, tree_mask=None, window=None, ring_len=None,
           scale=None, softcap=None) -> torch.Tensor:
    unported = dict(tree_mask=tree_mask, window=window, ring_len=ring_len,
                    scale=scale, softcap=softcap)
    for name, value in unported.items():
        if value is not None:
            raise NotImplementedError(f"attention option {name} is not ported yet")
    if k_cache.dtype == torch.int8:
        raise NotImplementedError("int8 KV caches are not ported yet")
    return flash_decode(q, k_cache, v_cache, positions)
