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
csrc/verify_prefix.cu launches or the call raises. The kernel splits each
row's V columns over ``verify_plan(B * K, V)`` blocks and combines the
splits in the last block of each sequence, in one launch;
``verify_prefix_split_plain`` is the same split and combine in torch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from llm_inference_lab_tpu_torch import build
from llm_inference_lab_tpu_torch.ops.flash_decode import ticket_counters

SMS = 132  # H100 SXM streaming multiprocessors
# The plan aims at rows * splits near BLOCKS_PER_SM blocks an SM, and no
# split reads less than MIN_SPLIT columns (8 KB) of a row. From a sweep on
# an NVIDIA H100 80GB HBM3 at 700 W (tests/torch_ids_probe.py --sweep): 8
# and 2048 were the fastest, or within 0.0004 ms of it, at every verify
# shape of the paths.
BLOCKS_PER_SM = 8
MIN_SPLIT = 2048
MAX_K = 32  # the kernel's last block keeps a sequence's K arguments in shared memory
LIBRARY = "verify_prefix"  # csrc/verify_prefix.cu


def split_width(V: int, splits: int) -> int:
    """Columns a split covers: ceil(V / splits) rounded up to a multiple of
    4, so that every split of a 16-byte aligned row starts on 16 bytes."""
    per = -(-V // splits)
    return -(-per // 4) * 4


def verify_plan(rows: int, V: int) -> int:
    """Splits of each row's V columns, from (rows, V) alone: rows * splits
    near BLOCKS_PER_SM * SMS blocks, no split below MIN_SPLIT columns (one
    split for a shorter row), and none empty: split z covers [z * width,
    min(V, (z + 1) * width)), width = split_width(V, splits)."""
    n = max(1, min(BLOCKS_PER_SM * SMS // max(rows, 1), V // MIN_SPLIT))
    while -(-V // split_width(V, n)) != n:  # fewer splits cover V at this width
        n = -(-V // split_width(V, n))
    return n


def verify_prefix_plain(draft_tokens: torch.Tensor,
                        target_logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    V = target_logits.shape[-1]
    arg = torch.argmax(target_logits, dim=-1)  # first maximal index on ties
    arg = torch.where(torch.isnan(target_logits).any(-1), V, arg)
    return _prefix(arg, draft_tokens)


def _prefix(arg: torch.Tensor, draft_tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    prefix = torch.cumprod((arg == draft_tokens).to(torch.int32), dim=-1)
    return prefix.sum(-1).to(torch.int32), prefix.bool()


def verify_prefix_split_plain(draft_tokens: torch.Tensor, target_logits: torch.Tensor,
                              splits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split and combine in torch: split z of every row keeps
    (max, lowest index of it, saw NaN) over its columns [z * width, min(V,
    (z + 1) * width)); the splits are combined in ascending order, a larger
    value or an equal value at a lower index winning (an empty split, index
    V, never wins), and a row that saw a NaN in any split gets V."""
    B, K, V = target_logits.shape
    width = split_width(V, splits)
    best = torch.full((B, K), float("-inf"), dtype=torch.float32, device=target_logits.device)
    idx = torch.full((B, K), V, dtype=torch.int64, device=target_logits.device)
    nan = torch.zeros((B, K), dtype=torch.bool, device=target_logits.device)
    for z in range(splits):
        part = target_logits[..., min(V, z * width):min(V, (z + 1) * width)]
        if part.shape[-1] == 0:
            continue
        holes = torch.isnan(part)
        part = torch.where(holes, float("-inf"), part)
        v, i = part.max(-1).values, part.argmax(-1) + z * width
        win = (v > best) | ((v == best) & (i < idx))
        best, idx, nan = torch.where(win, v, best), torch.where(win, i, idx), nan | holes.any(-1)
    return _prefix(torch.where(nan, V, idx), draft_tokens)


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
    if K > MAX_K:
        raise ValueError(f"verify_prefix kernel takes K <= {MAX_K}, got {K}")
    draft = draft_tokens.contiguous()
    dev = target_logits.device
    mask = torch.empty((B, K), dtype=torch.bool, device=dev)
    accept_len = torch.empty((B,), dtype=torch.int32, device=dev)
    if B * K == 0:
        return accept_len.zero_(), mask
    splits = verify_plan(B * K, V)
    ws = torch.empty((3, B * K, splits), dtype=torch.int32, device=dev)
    err = build.library(LIBRARY).verify_prefix_f32(
        draft.data_ptr(), target_logits.data_ptr(), ws.data_ptr(),
        ticket_counters(dev, B).data_ptr(), mask.data_ptr(), accept_len.data_ptr(), B, K, V,
        target_logits.stride(1), target_logits.stride(0), splits, split_width(V, splits),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "verify_prefix")
    verify_prefix.launches += 1
    return accept_len, mask


verify_prefix.launches = 0
