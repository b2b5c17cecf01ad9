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
// What bounds it on the H100: at decode (M = 1 to 40) the K * N weight
// bytes, read once at 3.35 TB/s (the 3B w_gate_up, 3072 x 16384, is 50.3 MB:
// 15.0 us); the activations are tiny. At an admission prefill (M = G * P,
// up to 4096) the operations do, and the wrapper sends every call of 64
// rows or more to the tensor-core path at the end of this file
// (csrc/qmm_mma.cuh), as kernel A's does.
//
// Design of the split-K kernel, every call of M < 64 rows (the frame of
// quant_matmul_int4.cu, one weight per byte):
//  * A block owns 256 output columns (64 threads x 4 columns, one 4-byte
//    load per weight row per thread: a warp reads 128 contiguous bytes) and
//    one K range. K is split across blocks (grid.y) so the card gets
//    hundreds of blocks even at N = 2048; each split writes f32 partial sums
//    to a workspace and a second kernel adds the splits in order and applies
//    the scale once. No atomics: results are deterministic.
//  * Inside a block, threadIdx.y interleaves weight rows (row j goes to
//    thread row j % 4); the four partials are added in fixed order through
//    shared memory.
//  * A split covers a multiple of 64 rows. x is staged in shared memory 256
//    rows at a time, for up to MB = 32 rows of x per block; grid.z covers M
//    in blocks of MB.
//  * Latency, not bandwidth, is what a decode call waits on: each block
//    moves only tens of KB. So a thread issues its weight loads in batches
//    (16 words at decode) before it uses any, and the first batch before x
//    is staged.
//  * Every output element is summed in an order that depends only on K and
//    N, never on M or MB (fmaf, fixed split and interleave). So the verify
//    forward (M = 5, or 40 for 8 serving slots) rounds each row exactly as
//    the single-row step does, and greedy speculative output equals
//    baseline output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_mma.cuh"

namespace {

constexpr int BN = 256;   // output columns per block
constexpr int TX = 64;    // threads along N (4 columns each)
constexpr int TY = 4;     // row interleave inside a block
constexpr int KCH = 256;  // rows of x staged per chunk

// Loads one thread's 4-byte words of UNR weight rows, row0 + u * TY, all
// issued before any is used.
template <int UNR>
__device__ __forceinline__ void load_words(int (&wv)[UNR], const int8_t* __restrict__ w, int row0,
                                           int N, int n0) {
#pragma unroll
  for (int u = 0; u < UNR; ++u)
    wv[u] = __ldg(reinterpret_cast<const int*>(w + (size_t)(row0 + u * TY) * N + n0));
}

template <int MB>
__global__ void __launch_bounds__(TX * TY)
qmm_int8_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                float* __restrict__ ws, int M, int K, int N, int rows_per_split) {
  // Weight words in flight per thread: 16 rows at decode, 4 where the
  // MB x 4 accumulators already take most of the registers.
  constexpr int UNR = MB >= 32 ? 4 : 16;
  __shared__ float xs[MB][KCH];
  __shared__ float red[TY][BN];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int n0 = blockIdx.x * BN + 4 * tx;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MB;
  const int r_begin = split * rows_per_split;

  float acc[MB][4];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  const int r_end = r_begin + rows_per_split;
  for (int c0 = r_begin; c0 < r_end; c0 += KCH) {
    const int nrow = min(KCH, r_end - c0);  // a multiple of 64, so of TY * UNR
    int wv[UNR];
    // The first batch of weight loads goes out before x is staged, so the
    // two wait on memory together.
    load_words<UNR>(wv, w, c0 + ty, N, n0);
    __syncthreads();
    for (int e = tid; e < MB * KCH; e += TX * TY) {
      const int m = e / KCH, j = e % KCH;
      float v = 0.f;
      if (m0 + m < M && j < nrow) v = __bfloat162float(x[(size_t)(m0 + m) * K + c0 + j]);
      xs[m][j] = v;
    }
    __syncthreads();
    for (int jb = 0; jb < nrow; jb += TY * UNR) {
      if (jb > 0) load_words<UNR>(wv, w, c0 + jb + ty, N, n0);
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int j = jb + ty + u * TY;
        float wf[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) wf[c] = (float)((int)((unsigned)wv[u] << (24 - 8 * c)) >> 24);
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          const float xv = xs[m][j];  // one address per warp: a broadcast
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, wf[c], acc[m][c]);
        }
      }
    }
  }

  // Add the TY interleaved partials in fixed order, one row at a time.
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 4; ++c) red[ty][4 * tx + c] = acc[m][c];
    __syncthreads();
    if (m0 + m < M) {
      float v = red[0][tid];
#pragma unroll
      for (int t = 1; t < TY; ++t) v += red[t][tid];
      ws[((size_t)split * M + m0 + m) * N + (size_t)blockIdx.x * BN + tid] = v;
    }
  }
}

template <int MB>
void launch(const void* x, const void* w, void* ws, int M, int K, int N, int ksplit,
            cudaStream_t st) {
  dim3 grid(N / BN, ksplit, (M + MB - 1) / MB);
  dim3 block(TX, TY);
  qmm_int8_kernel<MB><<<grid, block, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<float*>(ws), M, K, N, K / ksplit);
}

}  // namespace

// x bf16 [M, K]; w int8 [K, N]; scale f32 [N]; ws f32 [ksplit, M, N];
// out bf16 [M, N]. Requires N % 256 == 0 and (K / ksplit) % 64 == 0
// (checked by the Python wrapper).
extern "C" int qmm_int8(const void* x, const void* w, const void* scale, void* ws, void* out,
                        int M, int K, int N, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 2) {
    launch<2>(x, w, ws, M, K, N, ksplit, st);
  } else if (M <= 8) {
    launch<8>(x, w, ws, M, K, N, ksplit, st);
  } else {
    launch<32>(x, w, ws, M, K, N, ksplit, st);
  }
  const size_t total = (size_t)M * N;
  qmm::finish_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), M, N, ksplit);
  return (int)cudaGetLastError();
}

// The tensor-core path for M >= 64 rows (csrc/qmm_mma.cuh): the same x, w,
// scale and out, ws f32 [ksplit, M, N] when ksplit > 1. Requires N % 128 ==
// 0 and K % 64 == 0, ksplit dividing K / 64, x 16-byte aligned (checked by
// the Python wrapper, and all but the alignment here).
extern "C" int qmm_int8_mma(const void* x, const void* w, const void* scale, void* ws,
                            void* out, int M, int K, int N, int ksplit, void* stream) {
  return qmm::launch<8>(x, w, scale, ws, out, M, K, N, ksplit, stream);
}
