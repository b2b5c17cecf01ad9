// int4 weight-only dequantizing matmul for Hopper (sm_90a).
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
// What bounds it on the H100: at decode (M = 1 or 2) the K/2 * N weight
// bytes, read once at 3.35 TB/s; the activations are tiny. From M = 64 rows
// on (prefill) the operations do, and the wrapper sends those calls to the
// tensor-core path at the end of this file (csrc/qmm_mma.cuh).
//
// Design of the split-K kernel, every call of M < 64 rows (simple first):
//  * A block owns 256 output columns (64 threads x 4 columns, one 4-byte
//    load per packed row per thread: a warp reads 128 contiguous bytes) and
//    one K range. The K reduction is split across blocks (grid.y) so the
//    card gets hundreds of blocks even at N = 2048; each split writes its
//    f32 partial sums to a workspace and a second kernel adds the splits in
//    order and applies the scale. No atomics: results are deterministic.
//  * Inside a block, threadIdx.y interleaves packed rows (row j goes to
//    thread row j % 4); the four partials are added in fixed order through
//    shared memory.
//  * A split covers a multiple of 64 packed rows. x is staged in shared
//    memory 128 packed rows (256 input features) at a time, for up to
//    MB = 32 rows of x per block; grid.z covers M in blocks of MB.
//  * Latency, not bandwidth, is what a decode call waits on: each block
//    moves only a few KB. So a thread issues its weight loads in batches
//    (16 words at decode) before it uses any, and the first batch before
//    x is staged.
//  * Every output element is summed in an order that depends only on K and
//    N, never on M or MB (fmaf, fixed split and interleave). So the verify
//    forward (M = 2) and the baseline step (M = 1) round identically and
//    greedy speculative output equals baseline output.
//  * Dequantization: lo = (b & 0xF) - 8, hi = b >> 4 (arithmetic shift).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_mma.cuh"

namespace {

constexpr int BN = 256;   // output columns per block
constexpr int TX = 64;    // threads along N (4 columns each)
constexpr int TY = 4;     // packed-row interleave inside a block
constexpr int KCH = 128;  // packed rows of x staged per chunk

// Loads one thread's 4-byte words of UNR packed rows, row0 + u * TY, all
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
qmm_int4_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                float* __restrict__ ws, int M, int K, int N, int rows_per_split) {
  // Weight words in flight per thread: 16 rows at decode, 4 where the
  // MB x 4 accumulators already take most of the registers.
  constexpr int UNR = MB >= 32 ? 4 : 16;
  __shared__ float xs[MB][2][KCH];
  __shared__ float red[TY][BN];
  const int half = K / 2;
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
    for (int e = tid; e < MB * 2 * KCH; e += TX * TY) {
      const int m = e / (2 * KCH), h = (e / KCH) % 2, j = e % KCH;
      float v = 0.f;
      if (m0 + m < M && j < nrow) v = __bfloat162float(x[(size_t)(m0 + m) * K + h * half + c0 + j]);
      xs[m][h][j] = v;
    }
    __syncthreads();
    for (int jb = 0; jb < nrow; jb += TY * UNR) {
      if (jb > 0) load_words<UNR>(wv, w, c0 + jb + ty, N, n0);
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int j = jb + ty + u * TY;
        float lo[4], hi[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int b = (int)((unsigned)wv[u] << (24 - 8 * c)) >> 24;  // signed byte c
          lo[c] = (float)((b & 0xF) - 8);
          hi[c] = (float)(b >> 4);
        }
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          const float xl = xs[m][0][j], xh = xs[m][1][j];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[m][c] = fmaf(xl, lo[c], acc[m][c]);
            acc[m][c] = fmaf(xh, hi[c], acc[m][c]);
          }
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
  qmm_int4_kernel<MB><<<grid, block, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<float*>(ws), M, K, N, (K / 2) / ksplit);
}

}  // namespace

// x bf16 [M, K]; w int8 [K/2, N]; scale f32 [N]; ws f32 [ksplit, M, N];
// out bf16 [M, N]. Requires N % 256 == 0 and (K/2/ksplit) % 64 == 0
// (checked by the Python wrapper).
extern "C" int qmm_int4(const void* x, const void* w, const void* scale, void* ws, void* out,
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
extern "C" int qmm_int4_mma(const void* x, const void* w, const void* scale, void* ws,
                            void* out, int M, int K, int N, int ksplit, void* stream) {
  return qmm::launch<4>(x, w, scale, ws, out, M, K, N, ksplit, stream);
}
