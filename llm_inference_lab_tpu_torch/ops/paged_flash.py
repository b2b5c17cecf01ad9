"""Online-softmax decode attention over a paged bf16 or int8 KV pool.

Port of llm_inference_lab_tpu/ops/pallas/paged_flash.py, chain-decode
variants (mask kv_pos <= p) over bf16 pools (_kernel) and int8 pools with
per-row scale pools (_kernel_quant), with flash_decode's options (scale,
softcap, window; the window's page sweep is the kernel's key range). On a
CPU tensor
``paged_flash`` runs the plain version; on a CUDA tensor it launches
csrc/paged_flash.cu or raises. int8 pools go to ``paged_flash_int8``, with
its own launch count.

    paged_flash(q [B,S,H,D], k_pool [N,KVH,P,D], v_pool [N,KVH,P,D],
                positions [B,S], table [B,M], k_scale [N,KVH,P] = None,
                v_scale [N,KVH,P] = None, scale=None, softcap=None, window=None)
        -> [B,S,H,D] in q's dtype

Key j of sequence b is row j % P of page table[b, j // P]; P is a power of
two. The kernel is kernel D's (csrc/attn_mma.cuh) with the page table as its
address map, split over T as D is (decode_splits with T = M * P), so it
gives the same bits as flash_decode on the same keys; it reads only the
pages that hold a key of a block's live range (``paged_keys`` is that
address map written plainly, ``paged_flash_split_plain`` the whole kernel's
arithmetic, for the CPU tests). Page ids in the table must lie in [0, N):
the serving allocator hands out only such ids, and the kernel does not
check. The ring cache (ring_len) is contiguous only, as in JAX: it raises
here. ``paged_flash_tree`` is F's tree variant (paged_attend_xla's tree
branch): flash_decode_tree's mask through the page table, chunk_start a
slot (page ordinal * P + row).
"""

from __future__ import annotations

from typing import Optional

import torch

from llm_inference_lab_tpu_torch import build
from llm_inference_lab_tpu_torch.models.paged import gather_pages
from llm_inference_lab_tpu_torch.ops.flash_decode import (
    SPLIT,
    Options,
    check_queries,
    check_scales,
    data_ptrs,
    flash_decode_plain,
    flash_decode_split_plain,
    launch_tree,
    split_buffers,
)

LIBRARY = "paged_flash"  # csrc/paged_flash.cu


def paged_flash_plain(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                      positions: torch.Tensor, table: torch.Tensor,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None, **options) -> torch.Tensor:
    """Port of ops/paged_attention.py ``paged_attend_xla`` (chain mask):
    gather each sequence's pages (and, for int8 pools, their scales) into a
    contiguous [B, KVH, M*P, D] view (page ordinal j holds positions
    [j*P, (j+1)*P), so the position mask carries over) and run the plain
    attention; a row at position -1 gives zeros."""
    if k_scale is not None:
        k_scale, v_scale = gather_pages(k_scale, table), gather_pages(v_scale, table)
    return flash_decode_plain(q, gather_pages(k_pool, table), gather_pages(v_pool, table),
                              positions, k_scale, v_scale, **options)


def paged_keys(pool: torch.Tensor, table: torch.Tensor, positions: torch.Tensor,
               window: Optional[int] = None) -> torch.Tensor:
    """Kernel F's address map, plainly: the keys (or scales) [B, KVH, M*P(,
    D)] a sequence's rows read from a pool [N, KVH, P(, D)], key j from row
    j % P of page table[b, j // P], for j in the live range [lowest first
    visible key among the sequence's rows, largest position] and zeros
    elsewhere. The table is read only for the pages that hold a key of that
    range, so dead pages, pages below the window, unused table entries and
    page 0 never reach the result."""
    B, M = table.shape
    P = pool.shape[2]
    out = pool.new_zeros((B, pool.shape[1], M * P, *pool.shape[3:]))
    for b in range(B):
        live = positions[b][positions[b] >= 0]
        if not live.numel():
            continue
        hi = min(int(live.max()), M * P - 1)
        lo = max(int(live.min()) - window + 1, 0) if window is not None else 0
        for page in range(lo // P, hi // P + 1):
            a, e = max(lo, page * P), min(hi + 1, (page + 1) * P)
            out[b, :, a:e] = pool[int(table[b, page]), :, a - page * P:e - page * P]
    return out


def paged_flash_split_plain(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                            positions: torch.Tensor, table: torch.Tensor,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None, *, split: int = SPLIT,
                            **options) -> torch.Tensor:
    """Kernel F's arithmetic, plainly (the CPU tests; the wrapper never calls
    it): the pool read through paged_keys, then kernel D's split and combine
    (flash_decode_split_plain) over those keys, so it equals
    flash_decode_split_plain over the same keys laid out contiguously."""
    _refuse_ring(options)
    window = options.get("window")
    live = positions
    if options.get("tree_mask") is not None:  # a tree row's keys end at its chunk's last slot
        live = (options["chunk_start"][:, None] + q.shape[1] - 1).expand(q.shape[:2])
    scales = ()
    if k_scale is not None:
        scales = tuple(paged_keys(s, table, live, window) for s in (k_scale, v_scale))
    return flash_decode_split_plain(
        q, paged_keys(k_pool, table, live, window), paged_keys(v_pool, table, live, window),
        positions, *scales, split=split, **options)


def _refuse_ring(options: dict) -> None:
    if options.get("ring_len") is not None:
        raise ValueError("paged_flash: the ring cache (ring_len) needs the contiguous layout")


def _check_pools(name: str, q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 positions: torch.Tensor, table: torch.Tensor, cache_dtype: torch.dtype):
    """Pools [N, KVH, P, D] of cache_dtype with equal strides, [KVH, P, D]
    pages and a 16-byte aligned page stride; a contiguous int32 table
    [B, M] on q's device. Returns (B, S, H, D, KVH, P, M)."""
    B, S, H, D = check_queries(name, q, positions, k_pool, v_pool, cache_dtype=cache_dtype)
    N, KVH, P = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    if H % KVH or k_pool.shape != (N, KVH, P, D) or v_pool.shape != k_pool.shape:
        raise ValueError(f"{name} kernel: unsupported shapes q {tuple(q.shape)} "
                         f"pool {tuple(k_pool.shape)}")
    if P & (P - 1):
        raise ValueError(f"{name} kernel takes a page size that is a power of two, got {P}")
    if (k_pool.stride() != v_pool.stride() or k_pool.stride(3) != 1
            or k_pool.stride(2) != D or k_pool.stride(1) != P * D):
        raise ValueError(f"{name} kernel needs k and v pools with equal strides and "
                         "[KVH, P, D] pages")
    if (k_pool.stride(0) * k_pool.element_size()) % 16:
        raise ValueError(f"{name} kernel needs a 16-byte aligned page stride")
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[0] != B:
        raise TypeError(f"{name} kernel takes an int32 table [B, M]")
    if not table.is_contiguous() or table.device != q.device:
        raise ValueError(f"{name} kernel needs a contiguous table on q's device")
    return B, S, H, D, KVH, P, table.shape[1]


def paged_flash(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                positions: torch.Tensor, table: torch.Tensor,
                k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None, **options) -> torch.Tensor:
    """options: the keywords of flash_decode.Options but ring_len (scale,
    softcap, window)."""
    _refuse_ring(options)
    if k_pool.dtype == torch.int8:
        return paged_flash_int8(q, k_pool, v_pool, positions, table, k_scale, v_scale, **options)
    if not q.is_cuda:
        return paged_flash_plain(q, k_pool, v_pool, positions, table, **options)
    opts = Options(**options)
    opts.check()
    B, S, H, D, KVH, P, M = _check_pools("paged_flash", q, k_pool, v_pool, positions, table,
                                         torch.bfloat16)
    out = torch.empty_like(q)
    ws, counters, nz = split_buffers(q, KVH, M * P, opts)
    lib = build.library(LIBRARY)
    err = lib.paged_flash_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        positions.data_ptr(), out.data_ptr(), *data_ptrs(ws, counters), B, S, H, KVH, M, P, D,
        k_pool.stride(0), *opts.kernel_args(D), nz,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_flash")
    paged_flash.launches += 1
    return out


def paged_flash_int8(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                     positions: torch.Tensor, table: torch.Tensor, k_scale: torch.Tensor,
                     v_scale: torch.Tensor, **options) -> torch.Tensor:
    """paged_flash over int8 pools [N, KVH, P, D] with f32 scale pools
    [N, KVH, P]."""
    _refuse_ring(options)
    if not q.is_cuda:
        return paged_flash_plain(q, k_pool, v_pool, positions, table, k_scale, v_scale,
                                 **options)
    opts = Options(**options)
    opts.check()
    B, S, H, D, KVH, P, M = _check_pools("paged_flash_int8", q, k_pool, v_pool, positions, table,
                                         torch.int8)
    check_scales("paged_flash_int8", k_pool, k_scale, v_scale)
    if k_scale.stride(1) != P:
        raise ValueError("paged_flash_int8 kernel needs scale pools with [KVH, P] pages")
    out = torch.empty_like(q)
    ws, counters, nz = split_buffers(q, KVH, M * P, opts)
    lib = build.library(LIBRARY)
    err = lib.paged_flash_int8(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), table.data_ptr(), positions.data_ptr(), out.data_ptr(),
        *data_ptrs(ws, counters), B, S, H, KVH, M, P, D, k_pool.stride(0), k_scale.stride(0),
        *opts.kernel_args(D), nz, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_flash_int8")
    paged_flash_int8.launches += 1
    return out


paged_flash.launches = 0
paged_flash_int8.launches = 0


def paged_flash_tree(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                     table: torch.Tensor, tree_mask: torch.Tensor, chunk_start: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     bits: Optional[torch.Tensor] = None, **options) -> torch.Tensor:
    """Kernel F's tree variant (csrc/paged_flash_tree.cu): flash_decode_tree's
    function with the keys of sequence b read through table[b] (options:
    scale and softcap; bits: tree_bits(tree_mask), int32 [S, ceil(S / 32)],
    or None; any S). int8 pools go to paged_flash_tree_int8."""
    if k_pool.dtype == torch.int8:
        return paged_flash_tree_int8(q, k_pool, v_pool, table, tree_mask, chunk_start, k_scale,
                                     v_scale, bits, **options)
    if not q.is_cuda:
        return paged_flash_plain(q, k_pool, v_pool, torch.zeros(q.shape[:2], dtype=torch.int32),
                                 table, tree_mask=tree_mask, chunk_start=chunk_start, **options)
    out = launch_tree(LIBRARY, q, k_pool, v_pool, None, None, tree_mask, chunk_start,
                      Options(**options), bits, table, name="paged_flash_tree")
    paged_flash_tree.launches += 1
    return out


def paged_flash_tree_int8(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                          table: torch.Tensor, tree_mask: torch.Tensor, chunk_start: torch.Tensor,
                          k_scale: torch.Tensor, v_scale: torch.Tensor,
                          bits: Optional[torch.Tensor] = None, **options) -> torch.Tensor:
    """paged_flash_tree over int8 pools with f32 scale pools [N, KVH, P]."""
    if not q.is_cuda:
        return paged_flash_plain(q, k_pool, v_pool, torch.zeros(q.shape[:2], dtype=torch.int32),
                                 table, k_scale, v_scale, tree_mask=tree_mask,
                                 chunk_start=chunk_start, **options)
    out = launch_tree(LIBRARY, q, k_pool, v_pool, k_scale, v_scale, tree_mask, chunk_start,
                      Options(**options), bits, table, name="paged_flash_tree_int8")
    paged_flash_tree_int8.launches += 1
    return out


paged_flash_tree.launches = 0
paged_flash_tree_int8.launches = 0
