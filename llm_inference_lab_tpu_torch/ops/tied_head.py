"""tied_head: the int8 tied head's f32 logits, read from the table in place.

Port of llm_inference_lab_tpu/ops/quant.py EmbedQuant.head_logits (an XLA
dot_general with f32 output, no Pallas kernel), kernel G:

    tied_head(x [.., D] bf16, q int8 [V, D], scale f32 [V]) -> f32 [.., V]
    logits[m, v] = (sum_d f32(x[m, d]) * f32(q[v, d])) * scale[v]

q is the embedding table the lookup gathers from, row-major, one row a
token: no second layout and no bf16 copy of it. Each product of a bf16 and
an int8 value is exact in f32, so only the order of the sum may differ from
JAX's. On a CPU tensor the plain version runs (the product on f32 copies,
as ops/quant.py f32_logits computes it on the CPU); on a CUDA tensor
csrc/tied_head.cu launches or the call raises. A row's logits have the same
bits at every M on the card (the kernel's sum order depends on D alone).
D must be a multiple of 16 (every family's width); any V (a rank's padded
vocabulary slice under the model axis too) and any M. Below WIDE_MIN_M rows
the kernel's decode body runs (4 warps a block stream the table once, the
tiles' sums in shared memory), from it the wide body (a tiled product, 128
vocabulary rows by 128 tokens a block); both give a row the same bits.
"""

from __future__ import annotations

import torch

from llm_inference_lab_tpu_torch import build

LIBRARY = "tied_head"  # csrc/tied_head.cu
WIDE_MIN_M = 24  # rows from which a call takes the wide body (faster from 24 on the card)


def tied_head_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [.., D] @ q[V, D]^T with f32 products and sums, then the row scales
    on the vocabulary axis in f32 (JAX's dot_general with
    preferred_element_type=f32, times scale)."""
    lead = x.shape[:-1]
    y = torch.mm(x.reshape(-1, x.shape[-1]).float(), q.float().t()) * scale
    return y.reshape(*lead, q.shape[0])


def tied_head(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if not x.is_cuda:
        return tied_head_plain(x, q, scale)
    V, D = q.shape
    if x.dtype != torch.bfloat16 or q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("tied_head kernel takes bf16 x, an int8 table and f32 scales")
    if x.shape[-1] != D or scale.shape != (V,):
        raise ValueError(f"tied_head kernel: x [.., {D}] and scale [{V}] for a [{V}, {D}] "
                         f"table, got {tuple(x.shape)} and {tuple(scale.shape)}")
    if D % 16:
        raise ValueError(f"tied_head kernel needs a width divisible by 16, got {D}")
    if not (q.is_contiguous() and scale.is_contiguous()) or q.data_ptr() % 16:
        raise ValueError("tied_head kernel needs a contiguous, 16-byte aligned table and "
                         "contiguous scales")
    if q.device != x.device or scale.device != x.device:
        raise ValueError("tied_head kernel needs x, the table and the scales on one device")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, D).contiguous()
    if x2.data_ptr() % 16:
        raise ValueError("tied_head kernel needs 16-byte aligned rows of x")
    M = x2.shape[0]
    out = torch.empty((M, V), dtype=torch.float32, device=x.device)
    if M == 0:
        return out.reshape(*lead, V)
    lib = build.library(LIBRARY)
    entry = lib.tied_head_wide_f32 if M >= WIDE_MIN_M else lib.tied_head_f32
    err = entry(x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), M, V, D,
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "tied_head")
    tied_head.launches += 1
    return out.reshape(*lead, V)


tied_head.launches = 0
