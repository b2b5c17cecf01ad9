"""verify_prefix: batched argmax-and-match acceptance op.

Port of llm_inference_lab_tpu/ops/pallas/verify_pallas.py (and the contract
of ops/verify.py):

    verify_prefix(draft_tokens [B,K] int32, target_logits [B,K,V] f32)
        -> (accept_len [B] int32, accepted_mask [B,K] bool)

Argmax ties break to the lowest index. A row that holds any NaN rejects,
as in the Pallas kernel; verify_prefix_xla instead argmaxes such a row as
jnp.argmax does. The logits may be a strided view (the first K rows of the
verify forward's [B, K+1, V] logits): the kernel reads them in place.
On a CPU tensor the plain version runs; on a CUDA tensor the kernel in
csrc/verify_prefix.cu launches or the call raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from llm_inference_lab_tpu_torch import build


def verify_prefix_plain(draft_tokens: torch.Tensor,
                        target_logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    V = target_logits.shape[-1]
    arg = torch.argmax(target_logits, dim=-1)  # first maximal index on ties
    arg = torch.where(torch.isnan(target_logits).any(-1), V, arg)
    prefix = torch.cumprod((arg == draft_tokens).to(torch.int32), dim=-1)
    return prefix.sum(-1).to(torch.int32), prefix.bool()


def verify_prefix(draft_tokens: torch.Tensor,
                  target_logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if not target_logits.is_cuda:
        return verify_prefix_plain(draft_tokens, target_logits)
    B, K, V = target_logits.shape
    if target_logits.dtype != torch.float32 or target_logits.stride(2) != 1:
        raise TypeError("verify_prefix kernel takes f32 logits with unit stride along V")
    if draft_tokens.dtype != torch.int32 or draft_tokens.shape != (B, K):
        raise TypeError("verify_prefix kernel takes int32 draft tokens [B, K]")
    if draft_tokens.device != target_logits.device:
        raise ValueError("verify_prefix kernel needs draft tokens and logits on one device")
    draft = draft_tokens.contiguous()
    dev = target_logits.device
    arg = torch.empty((B * K,), dtype=torch.int32, device=dev)
    mask = torch.empty((B, K), dtype=torch.bool, device=dev)
    accept_len = torch.empty((B,), dtype=torch.int32, device=dev)
    lib = build.library("verify_prefix")
    err = lib.verify_prefix_f32(
        draft.data_ptr(), target_logits.data_ptr(), arg.data_ptr(), mask.data_ptr(),
        accept_len.data_ptr(), B, K, V, target_logits.stride(1), target_logits.stride(0),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "verify_prefix")
    verify_prefix.launches += 1
    return accept_len, mask


verify_prefix.launches = 0
