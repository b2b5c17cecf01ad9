"""RMSNorm whose rows do not depend on how many rows a call holds.

JAX computes rms_norm outside Pallas (llm_inference_lab_tpu/models/
transformer.py rms_norm, fused by XLA). torch's ``mean`` on the card chooses
its reduction by the shape of the call, so the same row can round
differently in a 5-row verify and a 256-row prefill; csrc/rms_norm.cu sums
each row in a fixed order in a block of its own. On a CPU tensor
``rms_norm`` runs the plain version; on a CUDA tensor it launches the
kernel or raises.

    rms_norm(x [.., N], scale [N], eps, one_offset=False) -> [.., N] in x's dtype

one_offset: Gemma's weights stored as (w - 1), so the weight is 1 + w in f32.
"""

from __future__ import annotations

import torch

from llm_inference_lab_tpu_torch import build


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float,
                   one_offset: bool = False) -> torch.Tensor:
    """JAX's formula in f32: x32 * rsqrt(mean(x32 * x32) + eps) * scale."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    if one_offset:
        scale = 1.0 + scale.float()
    # A bf16 scale promotes to f32 inside the product: no separate cast.
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             one_offset: bool = False) -> torch.Tensor:
    if not x.is_cuda:
        return rms_norm_plain(x, scale, eps, one_offset)
    N = x.shape[-1]
    if x.dtype != torch.bfloat16 or scale.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("rms_norm kernel takes bf16 x and a bf16 or f32 weight")
    if scale.shape != (N,) or not scale.is_contiguous() or scale.device != x.device:
        raise ValueError(f"rms_norm kernel needs a contiguous weight [{N}] on x's device")
    if N % 8:
        raise ValueError(f"rms_norm kernel needs a row length divisible by 8, got {N}")
    x2 = x.reshape(-1, N).contiguous()
    if x2.data_ptr() % 16:
        raise ValueError("rms_norm kernel needs 16-byte aligned rows")
    out = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return out.reshape(x.shape)
    err = build.library("rms_norm").rms_norm_bf16(
        x2.data_ptr(), scale.data_ptr(), out.data_ptr(), x2.shape[0], N, float(eps),
        int(one_offset), int(scale.dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "rms_norm")
    rms_norm.launches += 1
    return out.reshape(x.shape)


rms_norm.launches = 0
