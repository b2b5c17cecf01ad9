// RMSNorm over the rows of a bf16 matrix, for Hopper, with a fixed order of
// summation: every row's bits are independent of the number of rows.
//
// Replaces: no Pallas kernel. llm_inference_lab_tpu/models/transformer.py
//           rms_norm is plain JAX (XLA fuses it):
//             x32 = f32(x); var = mean(x32 * x32); y = x32 * rsqrt(var + eps)
//             out = bf16(y * s), s = f32(w) (Gemma: 1 + f32(w))
//
// Why a kernel: torch's mean on the card picks its reduction by the shape
// of the whole call, so a row of a 5-row verify and the same row of a
// 256-row prefill can round their mean differently, and a bf16 output step
// flips (tests/torch_kv_align_probe.py found it). Here one block owns one
// row; thread t sums the squares of its own 8-column chunks t, t + THREADS,
// ... in ascending order, then a fixed tree (shuffles within each warp,
// then warp 0 over the warps' sums in ascending order) gives the row's
// sum. Nothing depends on M, so a row has the same bits in any call.
//
// What bounds it on the H100: bytes (the row read once, written once, the
// weight read from L2): M * N * 4 bytes at 3.35 TB/s; at decode M = 1 to
// 40 it is launch latency.
//
// x, out bf16 [M, N] with contiguous rows, N % 8 == 0, 16-byte aligned
// (checked in Python); w [N], bf16 or f32 (w_f32 says which).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <class W>
__device__ __forceinline__ float weight(const W* w, int c);

template <>
__device__ __forceinline__ float weight<float>(const float* w, int c) {
  return w[c];
}

template <>
__device__ __forceinline__ float weight<__nv_bfloat16>(const __nv_bfloat16* w, int c) {
  return __bfloat162float(w[c]);
}

template <class W>
__global__ void __launch_bounds__(THREADS)
rms_norm_kernel(const __nv_bfloat16* __restrict__ x, const W* __restrict__ w,
                __nv_bfloat16* __restrict__ out, int N, float eps, int one_offset) {
  __shared__ float warp_sums[WARPS];
  __shared__ float inv_s;
  const int row = blockIdx.x, tid = threadIdx.x;
  const __nv_bfloat16* xr = x + (size_t)row * N;
  __nv_bfloat16* orow = out + (size_t)row * N;
  const int chunks = N / 8;

  float sum = 0.f;
  for (int c = tid; c < chunks; c += THREADS) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c * 8);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = __bfloat1622float2(h[u]);
      sum = __fadd_rn(sum, __fmul_rn(f.x, f.x));
      sum = __fadd_rn(sum, __fmul_rn(f.y, f.y));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
  if (tid % 32 == 0) warp_sums[tid / 32] = sum;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) total = __fadd_rn(total, warp_sums[i]);
    inv_s = rsqrtf(__fadd_rn(__fdiv_rn(total, (float)N), eps));
  }
  __syncthreads();
  const float inv = inv_s;

  for (int c = tid; c < chunks; c += THREADS) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c * 8);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint4 res;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = __bfloat1622float2(h[u]);
      float s0 = weight(w, c * 8 + 2 * u), s1 = weight(w, c * 8 + 2 * u + 1);
      if (one_offset) s0 = __fadd_rn(1.f, s0), s1 = __fadd_rn(1.f, s1);
      o[u] = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(f.x, inv), s0),
                                   __fmul_rn(__fmul_rn(f.y, inv), s1));
    }
    *reinterpret_cast<uint4*>(orow + c * 8) = res;
  }
}

}  // namespace

extern "C" int rms_norm_bf16(const void* x, const void* w, void* out, int M, int N, float eps,
                             int one_offset, int w_f32, void* stream) {
  if (M <= 0) return 0;
  if (N % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  if (w_f32)
    rms_norm_kernel<float><<<M, THREADS, 0, st>>>(xp, static_cast<const float*>(w), op, N, eps,
                                                   one_offset);
  else
    rms_norm_kernel<__nv_bfloat16><<<M, THREADS, 0, st>>>(
        xp, static_cast<const __nv_bfloat16*>(w), op, N, eps, one_offset);
  return (int)cudaGetLastError();
}
