// int4 weight-only dequantizing matmul for Hopper (sm_90a), kernel A.
//
// Replaces: llm_inference_lab_tpu/ops/pallas/quant_matmul.py
//           quant_matmul_pallas, int4 path (_kernel_int4 / _kernel_int4_st).
//
// Computes  y[M, N] = (x[M, K] @ unpack4(w)[K, N]) * scale[N]
// with f32 accumulation and a bf16 output. w is the JAX package's "v2
// split-K halves" bytes: byte [i, n] holds w[i, n] + 8 in its low nibble and
// w[i + K/2, n] as two's complement in its high nibble. A per-layer weight is
// a pointer into the stacked [L, K/2, N] buffer: no copy.
//
// What bounds it on the H100: below 64 rows (decode and verify) the K/2 * N
// weight bytes, read once at 3.35 TB/s; from 64 rows on (prefill) the
// operations. The wrapper (ops/quant_matmul.py) routes by M alone: M < 64
// to the decode body, csrc/qmm_decode.cuh (tensor cores, all rows in one
// block, one launch a call), M >= 64 to the prefill body, csrc/qmm_mma.cuh
// (wgmma). Each header carries its design.

#include "qmm_decode.cuh"

// M < 64 rows (csrc/qmm_decode.cuh): x bf16 [M, K], 16-byte aligned; w int8
// [K/2, N]; scale f32 [N]; out bf16 [M, N]; with ksplit > 1, ws f32
// [ksplit, M, N] and counters (>= N / 256 of them, zero; left zero).
// Requires N % 256 == 0, K % 64 == 0 and 1 <= ksplit <= K / 64 (checked
// here and by the Python wrapper, which also picks ksplit: decode_plan).
extern "C" int qmm_int4(const void* x, const void* w, const void* scale, void* ws,
                        void* counters, void* out, int M, int K, int N, int ksplit,
                        void* stream) {
  return qmm::launch_decode<4>(x, w, scale, ws, counters, out, M, K, N, ksplit, stream);
}

// The tensor-core path for M >= 64 rows (csrc/qmm_mma.cuh): the same x, w,
// scale and out, ws f32 [ksplit, M, N] when ksplit > 1. Requires N % 128 ==
// 0 and K % 64 == 0, ksplit dividing K / 64, x 16-byte aligned (checked by
// the Python wrapper, and all but the alignment here).
extern "C" int qmm_int4_mma(const void* x, const void* w, const void* scale, void* ws,
                            void* out, int M, int K, int N, int ksplit, void* stream) {
  return qmm::launch<4>(x, w, scale, ws, out, M, K, N, ksplit, stream);
}
