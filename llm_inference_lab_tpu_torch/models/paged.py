"""Paged KV cache: a page pool and per-sequence page tables.

Port of llm_inference_lab_tpu/models/paged.py (PagedKVCache, the paged
cache write, gather_pages and PageAllocator) for bf16 and int8 pools.
Layout, as in the JAX package:

    k/v pools  [n_layers, n_pages, n_kv_heads, page_size, head_dim]
    scales     [n_layers, n_pages, n_kv_heads, page_size] f32 (int8 pools;
               None for bf16 pools, as in models/base.py KVCache)
    table      [B, max_pages_per_seq] int32: page ids in position order;
               page j of a sequence holds positions [j*P, (j+1)*P). Unused
               entries point at page 0, which the position mask keeps
               unreachable.

Page 0 is the dummy page: the allocator never hands it out, so the junk rows
that inactive batch lanes write through a cleared (all-zero) table row land
where no live sequence reads. As the port's contiguous cache does, the write
goes into the pool IN PLACE.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from llm_inference_lab_tpu_torch.models.base import ModelConfig, kv_buffers, quantize_rows


@dataclass
class PagedKVCache:
    k: torch.Tensor  # [L, N_pages, KVH, P, D]
    v: torch.Tensor
    table: torch.Tensor  # [B, max_pages] int32
    k_scale: Optional[torch.Tensor] = None  # [L, N_pages, KVH, P] f32 (int8 pools)
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, cfg: ModelConfig, batch_size: int, max_seq_len: int, device,
               n_pages: Optional[int] = None, page_size: int = 64,
               table: Optional[torch.Tensor] = None,
               dtype: Optional[torch.dtype] = None) -> "PagedKVCache":
        """Default table: slot b owns pages [b*m, (b+1)*m), which is a
        contiguous cache in pages (Engine.generate_batch). Serving passes its
        own allocator-driven table, of which the cache keeps a private copy.
        dtype torch.int8 makes int8 pools with scale pools."""
        P = page_size
        m = (max_seq_len + P - 1) // P
        n_pages = n_pages if n_pages is not None else batch_size * m
        shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, P, cfg.head_dim)
        if table is None:
            table = torch.arange(batch_size * m, dtype=torch.int32,
                                 device=device).reshape(batch_size, m) % n_pages
        else:
            table = table.to(device=device, dtype=torch.int32).clone()
        k, v, k_scale, v_scale = kv_buffers(shape, dtype or cfg.dtype, device)
        return cls(k=k, v=v, table=table, k_scale=k_scale, v_scale=v_scale)

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def max_pages_per_seq(self) -> int:
        return self.table.shape[1]

    @property
    def max_seq_len(self) -> int:  # logical, per sequence
        return self.max_pages_per_seq * self.page_size


def page_slots(table: torch.Tensor, start: torch.Tensor, S: int, page_size: int):
    """Where the S new rows of each sequence go, for ``write_paged_layer``:
    (page [B, S], offset [B, S]), row (b, s) at position start[b] + s. The
    page ordinal clips to the table as the JAX scatter does. A forward
    computes it once for all its layers."""
    pos = start[:, None].long() + torch.arange(S, device=start.device)[None]
    ordinal = torch.div(pos, page_size, rounding_mode="floor").clamp(0, table.shape[1] - 1)
    return table.long().gather(1, ordinal), torch.remainder(pos, page_size)


def write_paged_layer(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
                      v_new: torch.Tensor, slots) -> None:
    """Write the new rows k_new/v_new [B, S, n_kv, d] (model compute order)
    of layer `layer` at ``slots = page_slots(...)``, in place; int8 pools
    quantize each row as it is written, with its scale (the port of
    update_paged_layer / scatter_paged_stack)."""
    page, off = slots
    # Advanced indices (page, off [B, S]) around the head slice index a
    # [B, S, n_kv, d] block (a [B, S, n_kv] block of scales): exactly the
    # model-order rows.
    for dst, scales, new in ((cache.k, cache.k_scale, k_new), (cache.v, cache.v_scale, v_new)):
        if dst.dtype == torch.int8:
            new, scale = quantize_rows(new)
            scales[layer][page, :, off] = scale
        dst[layer][page, :, off, :] = new.to(dst.dtype)


def gather_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[N_pages, KVH, P, D] + [B, max_pages] -> contiguous [B, KVH, M*P, D];
    a scale pool [N_pages, KVH, P] gathers to [B, KVH, M*P] alike."""
    g = pool[table.long()]  # [B, M, KVH, P(, D)]
    B, M, KVH, P = g.shape[:4]
    return g.transpose(1, 2).reshape(B, KVH, M * P, *g.shape[4:])


class PageAllocator:
    """Host-side free-list allocator for serving admission. Page ids reach
    the device only through table rows."""

    def __init__(self, n_pages: int, page_size: int):
        self.page_size = page_size
        self.n_pages = n_pages
        # Page 0 is the shared dummy target of unused table entries: never
        # handed out, so a stale or cleared table row cannot alias a live page.
        self._free: List[int] = list(range(n_pages - 1, 0, -1))

    def pages_needed(self, n_tokens: int) -> int:
        return (n_tokens + self.page_size - 1) // self.page_size

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages, or None if the pool cannot give them (the caller keeps
        the request queued: memory-aware admission)."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p != 0:
                self._free.append(p)
