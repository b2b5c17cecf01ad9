"""Dequantizing matmuls: y = (x @ unpack4(w)) * scale (int4, kernel A) and
y = (x @ w) * scale (int8, kernel B).

Port of llm_inference_lab_tpu/ops/pallas/quant_matmul.py (int4 and int8
paths) and of its reference quant_matmul_xla. On a CPU tensor
``quant_matmul`` and ``quant_matmul_int8`` run their plain versions; on a
CUDA tensor they launch csrc/quant_matmul_int4.cu and
csrc/quant_matmul_int8.cu or raise. Each file holds two bodies, routed by
M alone: below MMA_MIN_M rows (every decode and verify call: M = 1, 2, 5,
8, 16, 40) the decode body of csrc/qmm_decode.cuh (tensor cores, every row
of x in one block, one launch a call, the K split by ``decode_plan``);
at MMA_MIN_M rows and above (prefills: M = 160, Mistral's 512-row chunks,
admission waves of G * P rows, where the TPU dispatcher sent M > 32 to XLA)
the tensor-core path of csrc/qmm_mma.cuh, through ``quant_matmul_mma`` and
``quant_matmul_int8_mma``, each with its own launch count. Both sum a row in
an order fixed by (K, N) and the weight type, never by M (``decode_plan``,
``mma_plan``), so within each body a row rounds alike at every M; the two
bodies round a row differently (chip_smoke.py's row_stability counts it).

``quant_matmul_f32`` (and ``quant_matmul_f32_mma`` from MMA_MIN_M rows) is
kernel A with an f32 output, both bodies instantiated with the output type
(the scale applied to the f32 sum, nothing rounded): the EmbedQuant4 tied
head (ops/quant.py), whose logits JAX rounds to bf16 through dense and the
port keeps in f32, and an int4 row-parallel partial sum under the model
axis (ops/quant.py dense_f32). ``quant_matmul_int8_f32`` (and
``quant_matmul_int8_f32_mma``) is kernel B's: an int8 partial sum, which the
ranks add in f32 before the sum is rounded once. Their plain versions are
``quant_matmul_plain`` and ``quant_matmul_plain_int8`` with
``out_dtype=torch.float32``; each wrapper has its own launch count.
"""

from __future__ import annotations

import torch

from llm_inference_lab_tpu_torch import build
from llm_inference_lab_tpu_torch.ops.flash_decode import data_ptrs, ticket_counters

DECODE_BN = 256  # decode body: output columns a block
DECODE_KTILE = 64  # decode body: weight rows a k-tile (packed rows at int4)
SMS = 132  # H100 SXM streaming multiprocessors
DECODE_MIN_BLOCKS = 96  # the decode plan's floor on blocks a call
MMA_MIN_M = 64  # rows from which the tensor-core path takes the call
MMA_BN = 128  # tensor-core path: output columns a block
MMA_KTILE = 64  # tensor-core path: k-values a k-tile (its unit of K split)
N_ALIGN = 64  # both bodies take any N that is a multiple of this
# The kernel libraries (csrc/<name>.cu) of A (int4) and B (int8).
INT4_LIBRARY, INT8_LIBRARY = "quant_matmul_int4", "quant_matmul_int8"


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[.., d_in//2, d_out] packed bytes -> [.., d_in, d_out] int8 in [-8, 7]."""
    lo = (packed & 0x0F) - 8  # un-bias the low nibble
    hi = packed >> 4  # arithmetic shift sign-extends the high nibble
    return torch.cat([lo, hi], dim=-2)


def quant_matmul_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                       out_dtype=None) -> torch.Tensor:
    """x [M, K]; w int8 [K/2, N] packed int4; scale f32 [N]. f32 accumulation,
    output in x's dtype (quant_matmul_xla's contract), or in out_dtype
    (torch.float32: the f32 instantiation's, the scaled sum unrounded)."""
    y = torch.matmul(x.float(), unpack_int4(w).float()) * scale
    return y.to(out_dtype or x.dtype)


def quant_matmul_plain_int8(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                            out_dtype=None) -> torch.Tensor:
    """x [M, K]; w int8 [K, N]; scale f32 [N]. f32 accumulation, output in
    x's dtype (quant_matmul_xla's contract), or in out_dtype (torch.float32:
    the f32 instantiation's, the scaled sum unrounded)."""
    y = torch.matmul(x.float(), w.float()) * scale
    return y.to(out_dtype or x.dtype)


def decode_plan(K: int, N: int, bits: int = 4) -> int:
    """The decode body's K split, from (K, N) and the weight type alone:
    with the fixed column tile and k-tile it is all that decides the order
    of a row's sums, so every M rounds a row alike. As many splits as keep
    the grid of N / DECODE_BN column tiles at one block an SM or fewer, and
    one more where that leaves fewer than DECODE_MIN_BLOCKS blocks; at most
    one a k-tile. Split z takes k-tiles [z nk / ks, (z + 1) nk / ks). A
    tail tile (N % 256 != 0) counts as a block."""
    ktiles = (K // 2 if bits == 4 else K) // DECODE_KTILE
    nblk = -(-N // DECODE_BN)
    ks = max(1, SMS // nblk)
    if nblk * ks < DECODE_MIN_BLOCKS:
        ks += 1
    return max(1, min(ks, ktiles))


def takes_mma(M: int) -> bool:
    """Whether an M-row call goes to the tensor-core path: M alone decides,
    through MMA_MIN_M."""
    return M >= MMA_MIN_M


def mma_plan(K: int, N: int, bits: int = 4) -> int:
    """The tensor-core path's K split, from (K, N) and the weight type alone:
    with the fixed k-tile it is all that decides the order of a row's sums.
    int4 never splits. int8 splits K in two at N <= 4096 (32 or fewer column
    blocks), where one block a column tile leaves the card half empty at a
    160-row prefill; measured on an H100 by tests/torch_qmm_probe.py (PERF.md
    §6)."""
    if bits == 8 and -(-N // MMA_BN) <= 32 and (K // MMA_KTILE) % 2 == 0:
        return 2
    return 1


def _launch(name: str, x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
            bits: int, mma: bool = False, f32: bool = False) -> torch.Tensor:
    """Check the operands of kernel A (bits 4, w [K/2, N]) or B (bits 8,
    w [K, N]) and launch its decode body or (mma) its tensor-core path, with
    a bf16 output or (f32) an f32 one: bf16
    x, int8 w, f32 scale [N], N a multiple of 64 (a tail of column tiles
    is masked in the kernel: the weights keep their shape and bytes), K of
    64, contiguous
    operands on one device, x and w 16-byte aligned (a layer's view of the
    stacked weight qualifies)."""
    M, K = x.shape
    N = w.shape[-1]
    rows = K // 2 if bits == 4 else K
    if x.dtype != torch.bfloat16 or w.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes bf16 x, int8 w, f32 scale")
    if w.shape != (rows, N) or scale.shape != (N,) or (bits == 4 and K % 2):
        raise ValueError(f"bad shapes x {tuple(x.shape)} w {tuple(w.shape)} scale {tuple(scale.shape)}")
    if N % N_ALIGN or N < N_ALIGN or K % MMA_KTILE:
        raise ValueError(f"{name} kernel needs N % {N_ALIGN} == 0 and K % {MMA_KTILE} == 0, "
                         f"got K={K} N={N}")
    if not (x.is_contiguous() and w.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous operands")
    if x.data_ptr() % 16 or w.data_ptr() % 16 or not (w.device == x.device == scale.device):
        raise ValueError(f"{name} kernel needs x and w 16-byte aligned and all operands on one "
                         "device")
    if M < 1:
        raise ValueError(f"{name} kernel needs M >= 1")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = torch.empty((M, N), dtype=torch.float32 if f32 else torch.bfloat16, device=x.device)
    lib = build.library(name)
    tail = "_f32" if f32 else ""
    if mma:
        ks = mma_plan(K, N, bits)
        ws = torch.empty((ks, M, N), dtype=torch.float32, device=x.device) if ks > 1 else None
        err = getattr(lib, f"qmm_int{bits}_mma{tail}")(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), *data_ptrs(ws), out.data_ptr(), M, K,
            N, ks, stream)
        build.check(err, name + " (tensor-core path)")
        return out
    ks = decode_plan(K, N, bits)
    ws = counters = None
    if ks > 1:
        ws = torch.empty((ks, M, N), dtype=torch.float32, device=x.device)
        counters = ticket_counters(x.device, -(-N // DECODE_BN))
    err = getattr(lib, f"qmm_int{bits}{tail}")(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), *data_ptrs(ws, counters), out.data_ptr(),
        M, K, N, ks, stream)
    build.check(err, name)
    return out


def quant_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int4: x [M, K] @ packed w [K/2, N], times scale [N]; M >= MMA_MIN_M
    goes to quant_matmul_mma."""
    if not x.is_cuda:
        return quant_matmul_plain(x, w, scale)
    if takes_mma(x.shape[0]):
        return quant_matmul_mma(x, w, scale)
    out = _launch(INT4_LIBRARY, x, w, scale, bits=4)
    quant_matmul.launches += 1
    return out


def quant_matmul_mma(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Kernel A's tensor-core path (csrc/qmm_mma.cuh), which quant_matmul
    takes from MMA_MIN_M rows on; it computes any M >= 1."""
    if not x.is_cuda:
        return quant_matmul_plain(x, w, scale)
    out = _launch(INT4_LIBRARY, x, w, scale, bits=4, mma=True)
    quant_matmul_mma.launches += 1
    return out


def quant_matmul_f32(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Kernel A with an f32 output: x bf16 [M, K] @ packed w [K/2, N], times
    scale [N], the f32 sum scaled and not rounded (the EmbedQuant4 head);
    M >= MMA_MIN_M goes to quant_matmul_f32_mma."""
    if not x.is_cuda:
        return quant_matmul_plain(x, w, scale, out_dtype=torch.float32)
    if takes_mma(x.shape[0]):
        return quant_matmul_f32_mma(x, w, scale)
    out = _launch(INT4_LIBRARY, x, w, scale, bits=4, f32=True)
    quant_matmul_f32.launches += 1
    return out


def quant_matmul_f32_mma(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """quant_matmul_f32's tensor-core path (csrc/qmm_mma.cuh, f32 out)."""
    if not x.is_cuda:
        return quant_matmul_plain(x, w, scale, out_dtype=torch.float32)
    out = _launch(INT4_LIBRARY, x, w, scale, bits=4, mma=True, f32=True)
    quant_matmul_f32_mma.launches += 1
    return out


def quant_matmul_int8(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8: x [M, K] @ w [K, N], times scale [N]; M >= MMA_MIN_M goes to
    quant_matmul_int8_mma."""
    if not x.is_cuda:
        return quant_matmul_plain_int8(x, w, scale)
    if takes_mma(x.shape[0]):
        return quant_matmul_int8_mma(x, w, scale)
    out = _launch(INT8_LIBRARY, x, w, scale, bits=8)
    quant_matmul_int8.launches += 1
    return out


def quant_matmul_int8_mma(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Kernel B's tensor-core path, as quant_matmul_mma for int8 weights."""
    if not x.is_cuda:
        return quant_matmul_plain_int8(x, w, scale)
    out = _launch(INT8_LIBRARY, x, w, scale, bits=8, mma=True)
    quant_matmul_int8_mma.launches += 1
    return out


def quant_matmul_int8_f32(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Kernel B with an f32 output: x bf16 [M, K] @ w int8 [K, N], times
    scale [N], the f32 sum scaled and not rounded (an int8 row-parallel
    partial sum); M >= MMA_MIN_M goes to quant_matmul_int8_f32_mma."""
    if not x.is_cuda:
        return quant_matmul_plain_int8(x, w, scale, out_dtype=torch.float32)
    if takes_mma(x.shape[0]):
        return quant_matmul_int8_f32_mma(x, w, scale)
    out = _launch(INT8_LIBRARY, x, w, scale, bits=8, f32=True)
    quant_matmul_int8_f32.launches += 1
    return out


def quant_matmul_int8_f32_mma(x: torch.Tensor, w: torch.Tensor,
                              scale: torch.Tensor) -> torch.Tensor:
    """quant_matmul_int8_f32's tensor-core path (csrc/qmm_mma.cuh, f32 out)."""
    if not x.is_cuda:
        return quant_matmul_plain_int8(x, w, scale, out_dtype=torch.float32)
    out = _launch(INT8_LIBRARY, x, w, scale, bits=8, mma=True, f32=True)
    quant_matmul_int8_f32_mma.launches += 1
    return out


quant_matmul.launches = 0
quant_matmul_mma.launches = 0
quant_matmul_f32.launches = 0
quant_matmul_f32_mma.launches = 0
quant_matmul_int8.launches = 0
quant_matmul_int8_mma.launches = 0
quant_matmul_int8_f32.launches = 0
quant_matmul_int8_f32_mma.launches = 0
