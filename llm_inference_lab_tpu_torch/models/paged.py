"""Paged KV cache: a page pool and per-sequence page tables.

Port of llm_inference_lab_tpu/models/paged.py (PagedKVCache, the paged
cache write, gather_pages, PageAllocator and PrefixPageCache) for bf16 and
int8 pools.
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
goes into the pool IN PLACE (ops/kv_write.py: kernel H on the card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch

from llm_inference_lab_tpu_torch.models.base import ModelConfig, kv_buffers, lane_slots
from llm_inference_lab_tpu_torch.ops.kv_write import KVSlots, kv_write


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


def page_slots(table: torch.Tensor, start: torch.Tensor, S: int, page_size: int) -> KVSlots:
    """Where the S new rows of each sequence go, for ``write_paged_layer``:
    the KVSlots of every row (b, s), at position start[b] + s, landing at
    (page, offset). The page ordinal clips to the table as the JAX scatter
    does. A forward computes it once for all its layers, on the device."""
    rows = torch.arange(S, device=start.device)
    pos = start[:, None].long() + rows[None]
    ordinal = torch.div(pos, page_size, rounding_mode="floor").clamp(0, table.shape[1] - 1)
    return lane_slots(start.shape[0], rows, table.gather(1, ordinal),
                      torch.remainder(pos, page_size))


def write_paged_layer(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
                      v_new: torch.Tensor, slots: KVSlots) -> None:
    """Write the new rows k_new/v_new [B, S, n_kv, d] (model compute order)
    of layer `layer` at ``slots = page_slots(...)``, in place; int8 pools
    quantize each row as it is written, with its scale (the port of
    update_paged_layer / scatter_paged_stack): ops/kv_write.py, one launch
    on the card."""
    int8 = cache.k_scale is not None
    kv_write(cache.k[layer], cache.v[layer], cache.k_scale[layer] if int8 else None,
             cache.v_scale[layer] if int8 else None, k_new, v_new, slots)


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


class PrefixPageCache(PageAllocator):
    """PageAllocator with automatic prefix caching (host side), the JAX
    package's PrefixPageCache operation for operation, so the same sequence
    of calls hands out the same page ids.

    Full page_size-token chunks of a prompt are named by a chain hash (the
    chunk's tokens and the hash of the chunk before it), so a page is reused
    only under the same whole prefix. ``match`` gives the longest cached
    prefix, whose pages are shared (refcounted, and never written again by
    a request that reuses them: its writes start at its own prompt length,
    past every shared full chunk). After admission ``register`` publishes
    the request's own full prompt chunks. A page whose refcount falls to 0
    stays cached in an LRU pool, which ``alloc`` evicts from only when the
    free list runs dry. Shared pages reach the device only as page ids in
    table rows.

    ``root`` (the batcher's: None for the base model, a LoRA adapter's key
    otherwise) starts the chain, so a page is shared only among requests
    of one adapter: an adapter at the qkv site changes the K and V rows a
    page holds. JAX hashes the tokens alone and shares pages across
    adapters; with root None the hashes are JAX's."""

    def __init__(self, n_pages: int, page_size: int):
        super().__init__(n_pages, page_size)
        self._by_hash: dict = {}  # chain hash -> page id
        self._meta: dict = {}  # page id -> [chain hash, refcount, last use]
        self._clock = 0
        self.hits = 0  # pages served from the cache
        self.misses = 0  # pages registered fresh

    def chunk_hashes(self, ids: List[int], root: Any = None) -> List[Any]:
        """The chain hash of each FULL page_size chunk of ids, the chain
        started at root."""
        out: List[Any] = []
        parent: Any = root
        P = self.page_size
        for j in range(len(ids) // P):
            parent = hash((parent, tuple(ids[j * P: (j + 1) * P])))
            out.append(parent)
        return out

    def _evict(self, n: int) -> int:
        """Evict up to n unreferenced cached pages, least recently used
        first."""
        victims = sorted((m[2], pid) for pid, m in self._meta.items() if m[1] == 0)[:n]
        for _, pid in victims:
            self._by_hash.pop(self._meta.pop(pid)[0], None)
            self._free.append(pid)
        return len(victims)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            self._evict(n - len(self._free))
        return super().alloc(n)

    @property
    def reclaimable_pages(self) -> int:
        return sum(1 for m in self._meta.values() if m[1] == 0)

    def match(self, ids: List[int], max_tokens: int, root: Any = None) -> Tuple[List[int], int]:
        """The longest cached prefix of ids within max_tokens tokens (the
        batcher caps it at len(ids) - 2, so the suffix recomputes the hidden
        row the head modes carry): (shared pages, reused tokens), with a
        refcount taken on each page."""
        pages: List[int] = []
        self._clock += 1
        for h in self.chunk_hashes(ids[: max(max_tokens, 0)], root):
            pid = self._by_hash.get(h)
            if pid is None:
                break
            pages.append(pid)
        for pid in pages:
            self._meta[pid][1] += 1
            self._meta[pid][2] = self._clock
        self.hits += len(pages)
        return pages, len(pages) * self.page_size

    def register(self, ids: List[int], pages: List[int], reuse_len: int,
                 root: Any = None) -> None:
        """Publish a request's own full prompt chunks past the reused prefix;
        pages is its table prefix (shared and fresh, in position order)."""
        self._clock += 1
        hashes = self.chunk_hashes(ids, root)
        for j in range(reuse_len // self.page_size, len(hashes)):
            if hashes[j] in self._by_hash:  # a duplicate: the first stays
                continue
            self._by_hash[hashes[j]] = pages[j]
            self._meta[pages[j]] = [hashes[j], 1, self._clock]
        self.misses += len(hashes) - reuse_len // self.page_size

    def free(self, pages: List[int]) -> None:
        """Release a request's pages: a cached page drops a refcount and
        stays resident for reuse; the others go back to the free list."""
        self._clock += 1
        for p in pages:
            m = self._meta.get(p)
            if m is not None:
                m[1] = max(m[1] - 1, 0)
                m[2] = self._clock
            elif p != 0:
                self._free.append(p)
