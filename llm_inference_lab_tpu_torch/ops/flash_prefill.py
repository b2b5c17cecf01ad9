"""Online-softmax attention for prefill-length query blocks over a
contiguous bf16 KV cache.

Port of llm_inference_lab_tpu/ops/pallas/flash_prefill.py, bf16 chain-mask
variant (mask kv_pos <= p, scale D**-0.5). On a CPU tensor ``flash_prefill``
runs the plain version, ``flash_decode_plain`` (kernels D and E compute one
function, attend_xla's chain mask); on a CUDA tensor it launches
csrc/flash_prefill.cu or raises. ``attend`` sends it S > 32, as the JAX dispatcher does: the
serving admission's [G, P] prefill and Engine.generate's prompt.

    flash_prefill(q [B,S,H,D], k [B,KVH,T,D], v [B,KVH,T,D], positions [B,S])
        -> [B,S,H,D] in q's dtype

Positions need not start at 0 (a chunk may resume at any base); a row at
position -1 returns zeros, as attend_xla does.
"""

from __future__ import annotations

import torch

from llm_inference_lab_tpu_torch import build
from llm_inference_lab_tpu_torch.ops.flash_decode import (
    check_planes,
    check_queries,
    flash_decode_plain,
)

MAX_GROUP = 4  # the kernel runs 2 * group warps per 32-position block


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    if not q.is_cuda:
        return flash_decode_plain(q, k, v, positions)
    B, S, H, D = check_queries("flash_prefill", q, positions, k, v)
    check_planes("flash_prefill", q, k, v)
    KVH, T = k.shape[1], k.shape[2]
    if H // KVH > MAX_GROUP:
        raise ValueError(f"flash_prefill kernel takes GQA groups up to {MAX_GROUP}, got {H // KVH}")
    out = torch.empty_like(q)
    lib = build.library("flash_prefill")
    err = lib.flash_prefill_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(), out.data_ptr(),
        B, S, H, KVH, T, D, k.stride(0), k.stride(1), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
