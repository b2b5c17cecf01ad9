"""kv_write: one layer's new K and V rows stored in the KV cache, quantized
for an int8 cache, in one launch (kernel H).

Port of the JAX package's cache writes (llm_inference_lab_tpu/models/base.py
_quantize_rows, scatter_stack_layer and update_cache_layer; models/paged.py
update_paged_layer), XLA scatters with no Pallas kernel:

    kv_write(k_dst, v_dst, k_scale, v_scale, k_new, v_new, slots)

k_dst, v_dst: a layer of the cache, [O, KVH, T, D] (O the batch rows of a
contiguous cache, or a pool's pages); k_scale, v_scale: its [O, KVH, T] f32
scales (an int8 cache) or None; k_new, v_new [B, S, KVH, D] in the model's
compute order, read through their strides (the RoPE output's K heads and a
view of the QKV projection); slots: a ``KVSlots``, the rows written in the
index form: source row (b[r], s[r]) lands at (outer[r], slot[r]) of every
head, computed once a forward on the device (models/base.py cache_slots,
slice_slots; models/paged.py page_slots). An int8 cache stores each row as
``quantize_rows`` quantizes it (JAX's _quantize_rows bit for bit) and its
scale at the same place; any other cache stores the row in its own type.

On a CPU cache the plain version runs (the rows gathered, quantized and
stored by advanced indexing); on a CUDA cache csrc/kv_write.cu launches, or
the call raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from llm_inference_lab_tpu_torch import build

LIBRARY = "kv_write"  # csrc/kv_write.cu


class KVSlots(NamedTuple):
    """The rows a forward writes, int32 [n] each: source row (b, s) of the
    new K and V lands at (outer, slot) of the cache's layer (slot the row's
    place in a lane or a page)."""

    b: torch.Tensor
    s: torch.Tensor
    outer: torch.Tensor
    slot: torch.Tensor


def quantize_rows(x: torch.Tensor):
    """[..., D] -> (int8 values [..., D], f32 scales [...]): symmetric per
    row, with the f32 steps of the JAX package's _quantize_rows, so the bytes
    and scales are the same bit for bit (amax over D, max(amax, 1e-8) / 127,
    round half to even, clip to +-127). Both divisions are IEEE divisions
    on the card too: torch turns a division by a Python scalar into a
    product with its reciprocal there, so 127 is a 0-dim tensor on x's
    device."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1).clamp_min(1e-8) / torch.full((), 127.0, device=x.device)
    q = torch.round(x32 / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def kv_write_plain(k_dst: torch.Tensor, v_dst: torch.Tensor, k_scale: Optional[torch.Tensor],
                   v_scale: Optional[torch.Tensor], k_new: torch.Tensor, v_new: torch.Tensor,
                   slots: KVSlots) -> None:
    """The rows of slots gathered ([n, KVH, D]), quantized for an int8
    cache, and stored by advanced indexing (the indices around the head
    slice index a [n, KVH, D] block, a [n, KVH] block of scales)."""
    for dst, scales, new in ((k_dst, k_scale, k_new), (v_dst, v_scale, v_new)):
        rows = new[slots.b, slots.s]
        if dst.dtype == torch.int8:
            rows, scale = quantize_rows(rows)
            scales[slots.outer, :, slots.slot] = scale
        dst[slots.outer, :, slots.slot, :] = rows.to(dst.dtype)


def _check(k_dst, v_dst, k_scale, v_scale, k_new, v_new, slots: KVSlots) -> None:
    O, KVH, T, D = k_dst.shape
    if v_dst.shape != k_dst.shape or v_dst.dtype != k_dst.dtype:
        raise ValueError("kv_write kernel: k and v caches of one shape and type")
    src = k_new.dtype
    if src not in (torch.bfloat16, torch.float32) or v_new.dtype != src:
        raise TypeError(f"kv_write kernel takes bf16 or f32 rows, got {k_new.dtype}, "
                        f"{v_new.dtype}")
    if k_dst.dtype not in (src, torch.int8):
        raise TypeError(f"kv_write kernel stores {src} rows in a {src} or int8 cache, not "
                        f"{k_dst.dtype}")
    for name, new in (("k", k_new), ("v", v_new)):
        if new.dim() != 4 or new.shape[2:] != (KVH, D):
            raise ValueError(f"kv_write kernel: {name} rows [B, S, {KVH}, {D}], got "
                             f"{tuple(new.shape)}")
    # One set of strides serves K and V: the kernel takes k's.
    if k_dst.stride()[1:] != (T * D, D, 1) or v_dst.stride() != k_dst.stride():
        raise ValueError("kv_write kernel needs k and v cache layers of one stride whose inner "
                         "three dims are contiguous")
    if k_dst.dtype == torch.int8:
        for sc in (k_scale, v_scale):
            if (sc is None or sc.dtype != torch.float32 or sc.shape != (O, KVH, T)
                    or sc.stride() != (k_scale.stride(0), T, 1)):
                raise ValueError(f"kv_write kernel: an int8 cache needs f32 scales [{O}, {KVH}, "
                                 f"{T}] of one stride with contiguous inner dims")
    for t in slots:
        if t.dtype != torch.int32 or not t.is_contiguous() or t.shape != slots.b.shape:
            raise ValueError("kv_write kernel takes contiguous int32 slot indices of one length")
    tensors = [k_dst, v_dst, k_new, v_new, *slots] + (
        [k_scale, v_scale] if k_dst.dtype == torch.int8 else [])
    if any(t.device != k_dst.device for t in tensors):
        raise ValueError("kv_write kernel needs every tensor on the cache's device")


def kv_write(k_dst: torch.Tensor, v_dst: torch.Tensor, k_scale: Optional[torch.Tensor],
             v_scale: Optional[torch.Tensor], k_new: torch.Tensor, v_new: torch.Tensor,
             slots: KVSlots) -> None:
    if not k_dst.is_cuda:
        return kv_write_plain(k_dst, v_dst, k_scale, v_scale, k_new, v_new, slots)
    _check(k_dst, v_dst, k_scale, v_scale, k_new, v_new, slots)
    n = slots.b.shape[0]
    if n == 0:  # a rank's slice of T that holds none of the rows
        return None
    O, KVH, T, D = k_dst.shape
    int8 = k_dst.dtype == torch.int8
    err = build.library(LIBRARY).kv_write(
        k_new.data_ptr(), v_new.data_ptr(), k_dst.data_ptr(), v_dst.data_ptr(),
        k_scale.data_ptr() if int8 else None, v_scale.data_ptr() if int8 else None,
        *(t.data_ptr() for t in slots), n, KVH, D, T, *k_new.stride(), *v_new.stride(),
        k_dst.stride(0), k_scale.stride(0) if int8 else 0, int(k_new.dtype == torch.float32),
        int(int8), torch.cuda.current_stream(k_dst.device).cuda_stream)
    build.check(err, "kv_write")
    kv_write.launches += 1
    return None


kv_write.launches = 0
