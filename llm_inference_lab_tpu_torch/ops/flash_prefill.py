"""Online-softmax attention for prefill-length query blocks over a
contiguous bf16 or int8 KV cache.

Port of llm_inference_lab_tpu/ops/pallas/flash_prefill.py, chain-mask
variants (mask kv_pos <= p) over a bf16 cache (_kernel) and an int8 cache
with per-row scales (_kernel_quant), with flash_decode's options (scale,
softcap, window; a warp of 16 rows skips the tiles none of them sees) and
its ring_len: a prefill chunk over the rolling-buffer cache, which JAX sends to
attend_xla's ring branch because its Pallas prefill has no modular mask.
On a CPU tensor ``flash_prefill`` runs the plain version,
``flash_decode_plain`` (kernels D and E compute one function, attend_xla's
chain mask or its ring rule); on a CUDA tensor it
launches csrc/flash_prefill.cu or raises. An int8 cache goes to
``flash_prefill_int8``, with its own launch count. ``attend`` sends it
S > 32, as the JAX dispatcher does: the serving admission's [G, P] prefill
and Engine.generate's prompt.

    flash_prefill(q [B,S,H,D], k [B,KVH,T,D], v [B,KVH,T,D], positions [B,S],
                  k_scale [B,KVH,T] = None, v_scale [B,KVH,T] = None,
                  scale=None, softcap=None, window=None, ring_len=None)
        -> [B,S,H,D] in q's dtype

Positions need not start at 0 (a chunk may resume at any base); a row at
position -1 returns zeros, as attend_xla does.
"""

from __future__ import annotations

from typing import Optional

import torch

from llm_inference_lab_tpu_torch.ops.flash_decode import Options, flash_decode_plain, launch_planes

def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                  k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None,
                  **options) -> torch.Tensor:
    """options: the keywords of flash_decode.Options (scale, softcap, window,
    ring_len)."""
    if k.dtype == torch.int8:
        return flash_prefill_int8(q, k, v, positions, k_scale, v_scale, **options)
    if not q.is_cuda:
        return flash_decode_plain(q, k, v, positions, **options)
    out = launch_planes("flash_prefill", q, k, v, positions, None, None, Options(**options))
    flash_prefill.launches += 1
    return out


def flash_prefill_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                       k_scale: torch.Tensor, v_scale: torch.Tensor, **options) -> torch.Tensor:
    """flash_prefill over an int8 cache k, v [B, KVH, T, D] with f32 scales
    [B, KVH, T]."""
    if not q.is_cuda:
        return flash_decode_plain(q, k, v, positions, k_scale, v_scale, **options)
    out = launch_planes("flash_prefill", q, k, v, positions, k_scale, v_scale, Options(**options))
    flash_prefill_int8.launches += 1
    return out


flash_prefill.launches = 0
flash_prefill_int8.launches = 0
