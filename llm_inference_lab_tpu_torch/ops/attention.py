"""Attention over the KV cache: contiguous (``attend``) and paged
(``paged_attend``).

Port of the JAX package's attention dispatch (ops/attention.py
``attend_xla``'s contract; the routing of ops/pallas/flash_decode.py
``_kernel_wrapper`` and ops/pallas/paged_flash.py ``_wrapper``):

    attend(q [B,S,H,D], k_cache [B,KVH,T,D], v_cache [B,KVH,T,D],
           positions [B,S], k_scale [B,KVH,T] = None, v_scale = None,
           tree_mask=None, chunk_start=None, tree_bits=None,
           window=None, ring_len=None, scale=None, softcap=None)
        -> [B,S,H,D]
    paged_attend(q, k_pool [N,KVH,P,D], v_pool [N,KVH,P,D], positions,
                 table [B,M], k_scale [N,KVH,P] = None, v_scale = None,
                 tree_mask=None, chunk_start=None, tree_bits=None,
                 window=None, scale=None, softcap=None)
        -> [B,S,H,D]

A query at absolute position p attends to cache positions [0, p], or with a
sliding window to (p - window, p]: the engine writes new rows at their
positions before attending, so no separate length mask is needed. scale
replaces the score scale D**-0.5 and softcap caps the scores
(cap * tanh(s / cap)), as attend_xla's options do. Routing, as in JAX:
S <= 32 (draft, verify) goes to the decode kernels, flash_decode or
paged_flash; longer S (prefill) to flash_prefill, all with the options. A
window that cannot bind is dropped, as the JAX wrappers drop it: when the
cache holds no more positions than the window (T, or M * P for pages). The
rolling-buffer cache (ring_len R, contiguous only: slot = position mod R)
keeps its window unconditionally, as JAX does, since the modular mask needs
it; it goes to D for S <= 32 and to E for longer S (JAX sends ring prefill
chunks to attend_xla: its Pallas prefill has no modular mask). A
paged prefill first gathers its pages into a contiguous view (JAX sends that
case to its XLA gather; only Engine.generate_batch in paged mode reaches
it). An int8 cache (with its scales) is routed exactly as a
bf16 one, to the int8 variants of the same kernels. Gemma-2's per-layer
window gate (window_on, traced in JAX) is the caller's choice here: the
port's layer loop is Python and passes the window on local layers only.

The tree mask (tree speculation's verify chunk, attend_xla's tree branch):
``tree_mask`` [S, S] bool with ``chunk_start`` [B], the chunk's first slot
(a slot through the page table for ``paged_attend``): row s sees the slots
before the chunk and slot chunk_start + j iff tree_mask[s, j]; positions
are not read. Such a call goes to D's or F's tree variant
(flash_decode_tree, paged_flash_tree; their int8 forms for an int8 cache)
at every S, which takes S <= 32 on the card. ``tree_bits`` may carry the
mask's kernel form (ops/flash_decode.py tree_bits), computed once a
forward. A window that can bind and a ring are refused with the tree mask,
as the JAX forward refuses them (attend_xla's tree branch has neither).
"""

from __future__ import annotations

from typing import Optional

import torch

from llm_inference_lab_tpu_torch.models.paged import gather_pages
from llm_inference_lab_tpu_torch.ops.flash_decode import flash_decode, flash_decode_tree
from llm_inference_lab_tpu_torch.ops.flash_prefill import flash_prefill
from llm_inference_lab_tpu_torch.ops.paged_flash import paged_flash, paged_flash_tree

DECODE_MAX_S = 32  # longer query blocks are prefills


def _tree_options(options: dict, chunk_start) -> dict:
    """The options of a tree-masked call: scale and softcap; a binding window
    or a ring raises."""
    if chunk_start is None:
        raise ValueError("tree_mask needs chunk_start, the chunk's first slot [B]")
    if "window" in options or "ring_len" in options:
        raise NotImplementedError("sliding-window or ring attention with the tree mask over "
                                  "a cache longer than the window is not supported")
    return options


def _options(span: int, window: Optional[int], **options) -> dict:
    """The options in use, for the kernel wrappers: the window only where it
    can bind (keys (p - window, p] with p < span <= window reach back to 0
    anyway), or always with a ring."""
    if window is not None and (span > window or options.get("ring_len") is not None):
        options["window"] = window
    return {name: value for name, value in options.items() if value is not None}


def attend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           positions: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
           v_scale: Optional[torch.Tensor] = None, *,
           tree_mask: Optional[torch.Tensor] = None, chunk_start: Optional[torch.Tensor] = None,
           tree_bits: Optional[torch.Tensor] = None, window: Optional[int] = None,
           ring_len: Optional[int] = None, scale: Optional[float] = None,
           softcap: Optional[float] = None) -> torch.Tensor:
    options = _options(k_cache.shape[2], window, ring_len=ring_len, scale=scale,
                       softcap=softcap)
    if tree_mask is not None:
        return flash_decode_tree(q, k_cache, v_cache, tree_mask, chunk_start, k_scale, v_scale,
                                 tree_bits, **_tree_options(options, chunk_start))
    if q.shape[1] <= DECODE_MAX_S:
        return flash_decode(q, k_cache, v_cache, positions, k_scale, v_scale, **options)
    return flash_prefill(q, k_cache, v_cache, positions, k_scale, v_scale, **options)


def paged_attend(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 positions: torch.Tensor, table: torch.Tensor,
                 k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None,
                 *, tree_mask: Optional[torch.Tensor] = None,
                 chunk_start: Optional[torch.Tensor] = None,
                 tree_bits: Optional[torch.Tensor] = None, window: Optional[int] = None,
                 scale: Optional[float] = None, softcap: Optional[float] = None) -> torch.Tensor:
    options = _options(table.shape[1] * k_pool.shape[2], window, scale=scale, softcap=softcap)
    if tree_mask is not None:
        return paged_flash_tree(q, k_pool, v_pool, table, tree_mask, chunk_start, k_scale,
                                v_scale, tree_bits, **_tree_options(options, chunk_start))
    if q.shape[1] <= DECODE_MAX_S:
        return paged_flash(q, k_pool, v_pool, positions, table, k_scale, v_scale, **options)
    if k_scale is not None:
        k_scale, v_scale = gather_pages(k_scale, table), gather_pages(v_scale, table)
    return flash_prefill(q, gather_pages(k_pool, table), gather_pages(v_pool, table), positions,
                         k_scale, v_scale, **options)
