"""int4 dequantizing matmul: y = (x @ unpack4(w)) * scale.

Port of llm_inference_lab_tpu/ops/pallas/quant_matmul.py (int4 path) and of
its reference quant_matmul_xla. On a CPU tensor ``quant_matmul`` runs the
plain version; on a CUDA tensor it launches csrc/quant_matmul_int4.cu or
raises. The kernel serves every M, so the prefill (M = 160) goes through it
too, where the TPU dispatcher sent M > 32 to XLA.
"""

from __future__ import annotations

import torch

from llm_inference_lab_tpu_torch import build

BN = 256  # kernel columns per block
SPLIT_ROWS = 64  # the kernel splits K in units of this many packed rows
TARGET_BLOCKS = 4 * 132  # about four blocks per H100 SM


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[.., d_in//2, d_out] packed bytes -> [.., d_in, d_out] int8 in [-8, 7]."""
    lo = (packed & 0x0F) - 8  # un-bias the low nibble
    hi = packed >> 4  # arithmetic shift sign-extends the high nibble
    return torch.cat([lo, hi], dim=-2)


def quant_matmul_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [M, K]; w int8 [K/2, N] packed int4; scale f32 [N]. f32 accumulation,
    output in x's dtype (quant_matmul_xla's contract)."""
    y = torch.matmul(x.float(), unpack_int4(w).float()) * scale
    return y.to(x.dtype)


def ksplit_for(K: int, N: int) -> int:
    """How many blocks share the K reduction of one column block: the largest
    divisor of the chunk count that keeps the grid near TARGET_BLOCKS. It
    depends on (K, N) only, never on M, so every M sums in the same order."""
    chunks = (K // 2) // SPLIT_ROWS
    nblk = N // BN
    best = 1
    for d in range(1, chunks + 1):
        if chunks % d == 0 and nblk * d <= TARGET_BLOCKS:
            best = d
    return best


def quant_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if not x.is_cuda:
        return quant_matmul_plain(x, w, scale)
    M, K = x.shape
    N = w.shape[-1]
    if x.dtype != torch.bfloat16 or w.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("quant_matmul kernel takes bf16 x, int8 w, f32 scale")
    if w.shape != (K // 2, N) or scale.shape != (N,) or K % 2:
        raise ValueError(f"bad shapes x {tuple(x.shape)} w {tuple(w.shape)} scale {tuple(scale.shape)}")
    if N % BN or (K // 2) % SPLIT_ROWS:
        raise ValueError(f"quant_matmul kernel needs N % {BN} == 0 and K % {2 * SPLIT_ROWS} == 0, "
                         f"got K={K} N={N}")
    if not (x.is_contiguous() and w.is_contiguous() and scale.is_contiguous()):
        raise ValueError("quant_matmul kernel needs contiguous operands")
    if w.data_ptr() % 16 or not (w.device == x.device == scale.device):
        raise ValueError("quant_matmul kernel needs w 16-byte aligned and all operands on one device")
    ks = ksplit_for(K, N)
    ws = torch.empty((ks, M, N), dtype=torch.float32, device=x.device)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    lib = build.library("quant_matmul_int4")
    err = lib.qmm_int4(x.data_ptr(), w.data_ptr(), scale.data_ptr(), ws.data_ptr(),
                       out.data_ptr(), M, K, N, ks,
                       torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "quant_matmul_int4")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
