// int8 weight-only dequantizing matmul for Hopper (sm_90a), kernel B.
//
// Replaces: llm_inference_lab_tpu/ops/pallas/quant_matmul.py
//           quant_matmul_pallas, int8 path (_kernel_int8 / _kernel_int8_st).
//
// Computes  y[M, N] = (x[M, K] @ w[K, N]) * scale[N]
// with f32 accumulation and a bf16 output, the contract of the JAX package's
// quant_matmul_xla. w holds one symmetric int8 weight per byte; a per-layer
// weight is a pointer into the stacked [L, K, N] buffer: no copy.
//
// What bounds it on the H100: below 64 rows (decode and verify, M = 1 to
// 40 on the paths) the K * N weight bytes, read once at 3.35 TB/s (the 3B
// w_gate_up, 3072 x 16384, is 50.3 MB: 15.0 us); from 64 rows on (an
// admission prefill, M = G * P) the operations. The wrapper routes by M
// alone, as kernel A's does: M < 64 to csrc/qmm_decode.cuh, M >= 64 to
// csrc/qmm_mma.cuh. Each header carries its design.

#include "qmm_decode.cuh"

// M < 64 rows (csrc/qmm_decode.cuh): x bf16 [M, K], 16-byte aligned; w int8
// [K, N]; scale f32 [N]; out bf16 [M, N]; with ksplit > 1, ws f32
// [ksplit, M, N] and counters (>= N / 256 of them, zero; left zero).
// Requires N % 256 == 0, K % 64 == 0 and 1 <= ksplit <= K / 32 (checked
// here and by the Python wrapper, which also picks ksplit: decode_plan).
extern "C" int qmm_int8(const void* x, const void* w, const void* scale, void* ws,
                        void* counters, void* out, int M, int K, int N, int ksplit,
                        void* stream) {
  return qmm::launch_decode<8>(x, w, scale, ws, counters, out, M, K, N, ksplit, stream);
}

// The tensor-core path for M >= 64 rows (csrc/qmm_mma.cuh): the same x, w,
// scale and out, ws f32 [ksplit, M, N] when ksplit > 1. Requires N % 128 ==
// 0 and K % 64 == 0, ksplit dividing K / 64, x 16-byte aligned (checked by
// the Python wrapper, and all but the alignment here).
extern "C" int qmm_int8_mma(const void* x, const void* w, const void* scale, void* ws,
                            void* out, int M, int K, int N, int ksplit, void* stream) {
  return qmm::launch<8>(x, w, scale, ws, out, M, K, N, ksplit, stream);
}
