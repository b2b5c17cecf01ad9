// Greedy draft verification: batched argmax-and-match, for Hopper.
//
// Replaces: llm_inference_lab_tpu/ops/pallas/verify_pallas.py
//           verify_prefix_pallas (_kernel).
//
// For each (b, k): arg = argmax over V of logits[b, k, :], lowest index on
// ties; a row that holds any NaN gets arg = V (so it never matches and
// rejects, as in the Pallas kernel, where max() is NaN and no column equals
// it). Then mask[b, k] = arg == draft[b, k] for every k up to the first
// mismatch, and accept_len[b] = the number of accepted positions.
//
// The logits are the verify forward's [B, K+1, V] f32 tensor, read through
// its batch and row strides: the first K rows are not contiguous, and a row
// need not start on 16 bytes (V = 50257).
//
// What bounds it on the H100: the K * V * 4 bytes of logits, read once at
// 3.35 TB/s (513 KB at K = 1, V = 128256: 0.15 us). One block a row left
// one SM to read them; the split puts the row on many.
//
// Design: one launch. Block (z, row) scans the columns [z * width, min(V,
// (z + 1) * width)) of its row (verify_plan in ops/verify.py picks nsplit
// and width, a multiple of 4, from (rows, V) alone) with 16-byte loads, and
// scalar loads for the up to 3 columns at each edge where the row's address
// is not 16-byte aligned. Each thread keeps (max, lowest index, saw NaN);
// warps and then the block combine with the same rule, and the block writes
// its triple to the workspace. Then a fence and a ticket on the sequence's
// counter (kernel D's protocol, attn_mma.cuh): the last of the sequence's
// K * nsplit blocks combines each row's splits, sets arg = V for a row with
// a NaN anywhere, walks the prefix, writes the mask and accept_len and
// resets the counter. The combine keeps the larger value and, between
// equal values, the lower index: a total order on (value, index), so the
// result is the row's argmax with the lowest index whatever the order in
// which threads, warps and splits meet, and a split that saw no value (an
// empty range: index INT_MAX) never wins. Exact and deterministic.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct Best {
  float v;
  int i, nan;
};

__device__ __forceinline__ void take(Best& b, float v, int i, int nan) {
  if (v > b.v || (v == b.v && i < b.i)) {
    b.v = v;
    b.i = i;
  }
  b.nan |= nan;
}

__device__ __forceinline__ void see(Best& b, float v, int i) {
  if (isnan(v))
    b.nan = 1;
  else
    take(b, v, i, 0);
}

__device__ __forceinline__ Best warp_best(Best b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, b.v, o);
    const int i = __shfl_xor_sync(0xffffffffu, b.i, o);
    const int n = __shfl_xor_sync(0xffffffffu, b.nan, o);
    take(b, v, i, n);
  }
  return b;
}

// ws: [rows, nsplit] of (value, index, nan) as three int32 planes.
__global__ void __launch_bounds__(THREADS)
verify_kernel(const float* __restrict__ logits, const int* __restrict__ draft,
              int* __restrict__ ws, unsigned* __restrict__ counters, uint8_t* __restrict__ mask,
              int* __restrict__ accept_len, int K, int V, long long row_stride,
              long long batch_stride, int nsplit, int width) {
  __shared__ Best warp_part[WARPS];
  __shared__ int args[32];
  __shared__ int last_s;
  const int z = blockIdx.x, row = blockIdx.y, b = row / K, kk = row % K;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rows = gridDim.y;
  const float* x = logits + b * batch_stride + kk * row_stride;
  const int lo = min(V, z * width), hi = min(V, lo + width);

  Best best = {-INFINITY, INT_MAX, 0};
  // Columns [lo, a0) and [a1, hi) one by one; [a0, a1) in float4s.
  const int mis = (int)((reinterpret_cast<uintptr_t>(x + lo) >> 2) & 3);
  const int a0 = min(hi, lo + ((4 - mis) & 3));
  const int a1 = a0 + ((hi - a0) & ~3);
  if (tid < a0 - lo) see(best, x[lo + tid], lo + tid);
  if (tid < hi - a1) see(best, x[a1 + tid], a1 + tid);
  const float4* x4 = reinterpret_cast<const float4*>(x + a0);
  for (int j = tid; j < (a1 - a0) / 4; j += THREADS) {
    const float4 v = __ldcs(x4 + j);
    const int c = a0 + 4 * j;
    see(best, v.x, c);
    see(best, v.y, c + 1);
    see(best, v.z, c + 2);
    see(best, v.w, c + 3);
  }
  best = warp_best(best);
  if (lane == 0) warp_part[warp] = best;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < WARPS; ++w) take(best, warp_part[w].v, warp_part[w].i, warp_part[w].nan);
    const size_t slot = (size_t)row * nsplit + z, plane = (size_t)rows * nsplit;
    ws[slot] = __float_as_int(best.v);
    ws[plane + slot] = best.i;
    ws[2 * plane + slot] = best.nan;
  }

  // Ticket: the last block of sequence b finishes it.
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(&counters[b], 1u) == (unsigned)(K * nsplit) - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const size_t plane = (size_t)rows * nsplit;
  for (int r = warp; r < K; r += WARPS) {  // warp r combines row r's splits
    const size_t s0 = (size_t)(b * K + r) * nsplit;
    Best m = {-INFINITY, INT_MAX, 0};
    for (int zz = lane; zz < nsplit; zz += 32)
      take(m, __int_as_float(__ldcg(ws + s0 + zz)), __ldcg(ws + plane + s0 + zz),
           __ldcg(ws + 2 * plane + s0 + zz));
    m = warp_best(m);
    if (lane == 0) args[r] = m.nan ? V : m.i;
  }
  __syncthreads();
  if (tid == 0) {
    int run = 1, n = 0;
    for (int r = 0; r < K; ++r) {
      run = run && (args[r] == draft[b * K + r]);
      mask[b * K + r] = (uint8_t)run;
      n += run;
    }
    accept_len[b] = n;
    counters[b] = 0u;  // ready for the next launch on the stream
  }
}

}  // namespace

// draft int32 [B, K] contiguous; logits f32 with unit stride along V;
// ws int32 [3, B * K, nsplit]; counters uint32 [>= B], zero on entry and on
// exit; mask bool [B, K]; accept_len int32 [B]. K <= 32.
extern "C" int verify_prefix_f32(const void* draft, const void* logits, void* ws, void* counters,
                                 void* mask, void* accept_len, int B, int K, int V,
                                 long long row_stride, long long batch_stride, int nsplit,
                                 int width, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (K > 32 || nsplit <= 0 || width <= 0 || width % 4 || B * K > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  verify_kernel<<<dim3(nsplit, B * K), THREADS, 0, st>>>(
      static_cast<const float*>(logits), static_cast<const int*>(draft), static_cast<int*>(ws),
      static_cast<unsigned*>(counters), static_cast<uint8_t*>(mask),
      static_cast<int*>(accept_len), K, V, row_stride, batch_stride, nsplit, width);
  return (int)cudaGetLastError();
}
