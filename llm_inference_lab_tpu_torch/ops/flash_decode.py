"""Online-softmax decode attention over a contiguous bf16 KV cache.

Port of llm_inference_lab_tpu/ops/pallas/flash_decode.py, bf16 chain-decode
variant (mask kv_pos <= p, scale D**-0.5). On a CPU tensor ``flash_decode``
runs the plain version; on a CUDA tensor it launches csrc/flash_decode.cu or
raises. The kernel serves every S (draft S = 1, verify S = K+1, the S = 160
prefill), where the TPU dispatcher sent bf16 caches and this prefill to XLA.

    flash_decode(q [B,S,H,D], k [B,KVH,T,D], v [B,KVH,T,D], positions [B,S])
        -> [B,S,H,D] in q's dtype

A query row with no visible key (position -1) returns zeros, as attend_xla
does; the Pallas tile body returns the mean of V there.
"""

from __future__ import annotations

import torch

from llm_inference_lab_tpu_torch import build

BT = 32  # kernel keys per tile


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
    """attend_xla's chain-decode math in f32: scores, causal-by-position mask,
    softmax, zeros on rows with no visible key, probabilities rounded to the
    cache dtype before P @ V (as attend_xla rounds them)."""
    B, S, H, D = q.shape
    KVH, T = k.shape[1], k.shape[2]
    group = H // KVH
    qg = q.reshape(B, S, KVH, group, D).float()
    scores = torch.einsum("bsngd,bntd->bngst", qg, k.float()) * (D ** -0.5)
    kv_pos = torch.arange(T, device=q.device)
    mask = kv_pos[None, None, None, None, :] <= positions[:, None, None, :, None]
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(-1, keepdim=True), probs, torch.zeros_like(probs))
    out = torch.einsum("bngst,bntd->bsngd", probs.to(v.dtype).float(), v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    if not q.is_cuda:
        return flash_decode_plain(q, k, v, positions)
    B, S, H, D = q.shape
    KVH, T = k.shape[1], k.shape[2]
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError("flash_decode kernel takes bf16 q and caches")
    if positions.dtype != torch.int32 or positions.shape != (B, S):
        raise TypeError("flash_decode kernel takes int32 positions [B, S]")
    if D not in (64, 128) or T % BT or H % KVH or k.shape != (B, KVH, T, D) or v.shape != k.shape:
        raise ValueError(f"flash_decode kernel: unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if k.stride() != v.stride() or k.stride(3) != 1 or k.stride(2) != D:
        raise ValueError("flash_decode kernel needs k and v with equal strides and [T, D] planes")
    if not (q.is_contiguous() and positions.is_contiguous()):
        raise ValueError("flash_decode kernel needs contiguous q and positions")
    if not (q.device == k.device == v.device == positions.device):
        raise ValueError("flash_decode kernel needs all operands on one device")
    out = torch.empty_like(q)
    # The kernel reads q, k and v and each (b, kv head) plane in 16-byte
    # vectors: a misaligned view would fault on the card after the launch.
    if (any(t.data_ptr() % 16 for t in (q, k, v, out))
            or k.stride(0) % 8 or k.stride(1) % 8):
        raise ValueError("flash_decode kernel needs 16-byte aligned q, k, v and plane strides")
    lib = build.library("flash_decode")
    err = lib.flash_decode_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(), out.data_ptr(),
        B, S, H, KVH, T, D, k.stride(0), k.stride(1), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
