"""Online-softmax decode attention over a contiguous bf16 KV cache.

Port of llm_inference_lab_tpu/ops/pallas/flash_decode.py, bf16 chain-decode
variant (mask kv_pos <= p, scale D**-0.5). On a CPU tensor ``flash_decode``
runs the plain version; on a CUDA tensor it launches csrc/flash_decode.cu or
raises. ``attend`` sends it the decode-shaped calls (S <= 32: draft S = 1,
verify S = K+1); longer S goes to flash_prefill.

    flash_decode(q [B,S,H,D], k [B,KVH,T,D], v [B,KVH,T,D], positions [B,S])
        -> [B,S,H,D] in q's dtype

A query row with no visible key (position -1) returns zeros, as attend_xla
does; the Pallas tile body returns the mean of V there.
"""

from __future__ import annotations

import torch

from llm_inference_lab_tpu_torch import build


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


def check_queries(name: str, q: torch.Tensor, positions: torch.Tensor, *caches: torch.Tensor):
    """The checks every attention kernel makes on q, positions and its K/V
    tensors: bf16, D in {64, 128}, int32 positions [B, S], contiguous q and
    positions, one device, 16-byte aligned q and caches (the kernels read
    16-byte vectors: a misaligned view would fault on the card after the
    launch). Returns (B, S, H, D)."""
    B, S, H, D = q.shape
    if q.dtype != torch.bfloat16 or any(c.dtype != torch.bfloat16 for c in caches):
        raise TypeError(f"{name} kernel takes bf16 q and caches")
    if positions.dtype != torch.int32 or positions.shape != (B, S):
        raise TypeError(f"{name} kernel takes int32 positions [B, S]")
    if D not in (64, 128):
        raise ValueError(f"{name} kernel: head dim {D} is not 64 or 128")
    if not (q.is_contiguous() and positions.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous q and positions")
    if any(t.device != q.device for t in (positions, *caches)):
        raise ValueError(f"{name} kernel needs all operands on one device")
    if any(t.data_ptr() % 16 for t in (q, *caches)):
        raise ValueError(f"{name} kernel needs 16-byte aligned q and caches")
    return B, S, H, D


def check_planes(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """k and v [B, KVH, T, D] with equal strides and unit-stride [T, D]
    planes at 16-byte aligned batch and head strides (a layer's view of the
    stacked cache qualifies)."""
    B, S, H, D = q.shape
    KVH, T = k.shape[1], k.shape[2]
    if H % KVH or k.shape != (B, KVH, T, D) or v.shape != k.shape:
        raise ValueError(f"{name} kernel: unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if k.stride() != v.stride() or k.stride(3) != 1 or k.stride(2) != D:
        raise ValueError(f"{name} kernel needs k and v with equal strides and [T, D] planes")
    if k.stride(0) % 8 or k.stride(1) % 8:
        raise ValueError(f"{name} kernel needs 16-byte aligned plane strides")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    if not q.is_cuda:
        return flash_decode_plain(q, k, v, positions)
    B, S, H, D = check_queries("flash_decode", q, positions, k, v)
    check_planes("flash_decode", q, k, v)
    KVH, T = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = build.library("flash_decode")
    err = lib.flash_decode_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(), out.data_ptr(),
        B, S, H, KVH, T, D, k.stride(0), k.stride(1), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
