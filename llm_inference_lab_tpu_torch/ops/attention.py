"""Attention over the KV cache: contiguous (``attend``) and paged
(``paged_attend``).

Port of the JAX package's attention dispatch (ops/attention.py
``attend_xla``'s contract; the routing of ops/pallas/flash_decode.py
``_kernel_wrapper`` and ops/pallas/paged_flash.py ``_wrapper``):

    attend(q [B,S,H,D], k_cache [B,KVH,T,D], v_cache [B,KVH,T,D],
           positions [B,S], k_scale [B,KVH,T] = None, v_scale = None)
        -> [B,S,H,D]
    paged_attend(q, k_pool [N,KVH,P,D], v_pool [N,KVH,P,D], positions,
                 table [B,M], k_scale [N,KVH,P] = None, v_scale = None)
        -> [B,S,H,D]

A query at absolute position p attends to cache positions [0, p]: the
engine writes new rows at their positions before attending, so no separate
length mask is needed. Routing, as in JAX: S <= 32 (draft, verify) goes to
the decode kernels, flash_decode or paged_flash; longer S (prefill) to
flash_prefill. A paged prefill first gathers its pages into a contiguous
view (JAX sends that case to its XLA gather; only Engine.generate_batch in
paged mode reaches it). An int8 cache (with its scales) is routed exactly
as a bf16 one, to the int8 variants of the same kernels. Only the chain
mask is ported: the sliding window, ring cache, tree mask, softcap and scale
override raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from llm_inference_lab_tpu_torch.models.paged import gather_pages
from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode
from llm_inference_lab_tpu_torch.ops.flash_prefill import flash_prefill
from llm_inference_lab_tpu_torch.ops.paged_flash import paged_flash

DECODE_MAX_S = 32  # longer query blocks are prefills


def _refuse_unported(**options) -> None:
    for name, value in options.items():
        if value is not None:
            raise NotImplementedError(f"attention option {name} is not ported yet")


def attend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           positions: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
           v_scale: Optional[torch.Tensor] = None, *, tree_mask=None, window=None,
           ring_len=None, scale=None, softcap=None) -> torch.Tensor:
    _refuse_unported(tree_mask=tree_mask, window=window, ring_len=ring_len, scale=scale,
                     softcap=softcap)
    if q.shape[1] <= DECODE_MAX_S:
        return flash_decode(q, k_cache, v_cache, positions, k_scale, v_scale)
    return flash_prefill(q, k_cache, v_cache, positions, k_scale, v_scale)


def paged_attend(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 positions: torch.Tensor, table: torch.Tensor,
                 k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None,
                 *, tree_mask=None, window=None, scale=None, softcap=None) -> torch.Tensor:
    _refuse_unported(tree_mask=tree_mask, window=window, scale=scale, softcap=softcap)
    if q.shape[1] <= DECODE_MAX_S:
        return paged_flash(q, k_pool, v_pool, positions, table, k_scale, v_scale)
    if k_scale is not None:
        k_scale, v_scale = gather_pages(k_scale, table), gather_pages(v_scale, table)
    return flash_prefill(q, gather_pages(k_pool, table), gather_pages(v_pool, table), positions,
                         k_scale, v_scale)
