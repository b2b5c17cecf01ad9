// RMSNorm over the rows of a bf16 matrix, for Hopper, with a fixed order of
// summation: every row's bits are independent of the number of rows. Two
// entries: rms_norm_bf16 (the norm alone: the first norm of a forward) and
// add_rms_norm_bf16 (the residual add fused with the norm that follows it:
// every other norm of a forward).
//
// Replaces: no Pallas kernel. llm_inference_lab_tpu/models/transformer.py
//           rms_norm is plain JAX (XLA fuses it):
//             x32 = f32(x); var = mean(x32 * x32); y = x32 * rsqrt(var + eps)
//             out = bf16(y * s), s = f32(w) (Gemma: 1 + f32(w))
//           and the layer loop's residual adds (transformer.py:424-435):
//             x = x + a (Gemma-2: a = rms_norm(a, post_w) first); x_norm =
//             rms_norm(x, w_next)
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
// The fused entry: x_new = bf16(f32(x) + f32(a')) rounded as torch's bf16
// add rounds (one f32 add, then round to nearest even), a' = a or, with a
// post weight (Gemma-2's sandwich norm), the norm of a; then the norm of
// x_new. Both norms run the reduction above in the same block, on rows
// held in registers (at most CPT 16-byte chunks a thread, so N <= 8192),
// so x and a are read once and x_new is written once. Its outputs have the
// bits of rms_norm_bf16 applied to torch's x + a'.
//
// What bounds it on the H100: bytes. The norm alone: the row read once and
// written once, the weight from L2: M * N * 4 bytes at 3.35 TB/s. The fused
// entry: x and a read, x_new and the norm written: M * N * 8 bytes, where
// the unfused pair (torch's add, then the norm) moves M * N * 10 in two
// launches. At decode (M = 1 to 40) a call is launch latency: the fusion
// saves the add's launch.
//
// x, a, outputs bf16 [M, N] with contiguous rows, N % 8 == 0, 16-byte
// aligned (checked in Python); w, post_w [N], bf16 or f32 (w_f32 says which,
// for both).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CPT = 4;  // the fused entry's 16-byte chunks a thread: N <= CPT * THREADS * 8

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

// sum + the squares of a chunk's 8 values, in element order.
__device__ __forceinline__ float add_squares(float sum, const uint4& raw) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 f = __bfloat1622float2(h[u]);
    sum = __fadd_rn(sum, __fmul_rn(f.x, f.x));
    sum = __fadd_rn(sum, __fmul_rn(f.y, f.y));
  }
  return sum;
}

// The row's 1 / rms from each thread's partial sum: xor-shuffles within each
// warp, then thread 0 adds the warps' sums in ascending order. Every thread
// of the block calls it; each call ends behind a barrier.
__device__ __forceinline__ float row_inv(float sum, int N, float eps, float* warp_sums,
                                         float* inv_s) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
  if (tid % 32 == 0) warp_sums[tid / 32] = sum;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) total = __fadd_rn(total, warp_sums[i]);
    *inv_s = rsqrtf(__fadd_rn(__fdiv_rn(total, (float)N), eps));
  }
  __syncthreads();
  return *inv_s;
}

// bf16((x * inv) * s) for the 8 values of chunk c, s = w (or 1 + w).
template <class W>
__device__ __forceinline__ uint4 scale_chunk(const uint4& raw, const W* w, int c, float inv,
                                             int one_offset) {
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
  return res;
}

// bf16(f32(x) + f32(a)) for the 8 values of a chunk: torch's bf16 add.
__device__ __forceinline__ uint4 add_chunk(const uint4& xr, const uint4& ar) {
  const __nv_bfloat162* hx = reinterpret_cast<const __nv_bfloat162*>(&xr);
  const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&ar);
  uint4 res;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 fx = __bfloat1622float2(hx[u]), fa = __bfloat1622float2(ha[u]);
    o[u] = __floats2bfloat162_rn(__fadd_rn(fx.x, fa.x), __fadd_rn(fx.y, fa.y));
  }
  return res;
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
  for (int c = tid; c < chunks; c += THREADS)
    sum = add_squares(sum, *reinterpret_cast<const uint4*>(xr + c * 8));
  const float inv = row_inv(sum, N, eps, warp_sums, &inv_s);
  for (int c = tid; c < chunks; c += THREADS)
    *reinterpret_cast<uint4*>(orow + c * 8) =
        scale_chunk(*reinterpret_cast<const uint4*>(xr + c * 8), w, c, inv, one_offset);
}

// POST: a' = rms_norm(a, post_w) (Gemma-2), else a' = a. Writes x_new =
// x + a' to x_out and rms_norm(x_new, w) to out.
template <class W, bool POST>
__global__ void __launch_bounds__(THREADS)
add_rms_norm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ a,
                    const W* __restrict__ w, const W* __restrict__ post_w,
                    __nv_bfloat16* __restrict__ x_out, __nv_bfloat16* __restrict__ out, int N,
                    float eps, int one_offset) {
  __shared__ float warp_sums[WARPS];
  __shared__ float inv_s;
  const int tid = threadIdx.x, chunks = N / 8;
  const size_t base = (size_t)blockIdx.x * N;
  uint4 xv[CPT], av[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = tid + j * THREADS;
    if (c < chunks) {
      xv[j] = *reinterpret_cast<const uint4*>(x + base + c * 8);
      av[j] = *reinterpret_cast<const uint4*>(a + base + c * 8);
    }
  }
  if (POST) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      if (tid + j * THREADS < chunks) sum = add_squares(sum, av[j]);
    const float inv = row_inv(sum, N, eps, warp_sums, &inv_s);
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      if (tid + j * THREADS < chunks) av[j] = scale_chunk(av[j], post_w, tid + j * THREADS, inv,
                                                          one_offset);
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = tid + j * THREADS;
    if (c < chunks) {
      xv[j] = add_chunk(xv[j], av[j]);
      *reinterpret_cast<uint4*>(x_out + base + c * 8) = xv[j];
      sum = add_squares(sum, xv[j]);
    }
  }
  const float inv = row_inv(sum, N, eps, warp_sums, &inv_s);
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = tid + j * THREADS;
    if (c < chunks)
      *reinterpret_cast<uint4*>(out + base + c * 8) = scale_chunk(xv[j], w, c, inv, one_offset);
  }
}

template <class W>
int launch_add(const void* x, const void* a, const void* w, const void* post_w, void* x_out,
               void* out, int M, int N, float eps, int one_offset, cudaStream_t st) {
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* ap = static_cast<const __nv_bfloat16*>(a);
  __nv_bfloat16* xo = static_cast<__nv_bfloat16*>(x_out);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  if (post_w)
    add_rms_norm_kernel<W, true><<<M, THREADS, 0, st>>>(
        xp, ap, static_cast<const W*>(w), static_cast<const W*>(post_w), xo, op, N, eps,
        one_offset);
  else
    add_rms_norm_kernel<W, false><<<M, THREADS, 0, st>>>(
        xp, ap, static_cast<const W*>(w), nullptr, xo, op, N, eps, one_offset);
  return (int)cudaGetLastError();
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

// post_w may be null (no sandwich norm); x_out may alias nothing else.
extern "C" int add_rms_norm_bf16(const void* x, const void* a, const void* w, const void* post_w,
                                 void* x_out, void* out, int M, int N, float eps, int one_offset,
                                 int w_f32, void* stream) {
  if (M <= 0) return 0;
  if (N % 8 || N > CPT * THREADS * 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w_f32 ? launch_add<float>(x, a, w, post_w, x_out, out, M, N, eps, one_offset, st)
               : launch_add<__nv_bfloat16>(x, a, w, post_w, x_out, out, M, N, eps, one_offset,
                                           st);
}
