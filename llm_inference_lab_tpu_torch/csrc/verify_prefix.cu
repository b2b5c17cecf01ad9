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
// its batch and row strides: the first K rows are not contiguous.
//
// What bounds it on the H100: the K * V * 4 bytes of logits, read once at
// 3.35 TB/s (513 KB at K = 1, V = 128256: well under a microsecond, so
// launch latency dominates on the main path).
//
// Design: pass 1 runs one 1024-thread block per (b, k) row; each thread
// scans a strided slice keeping (max, lowest index, saw NaN), then warps and
// the block combine with the same rule. Pass 2 is one thread per sequence
// walking its K matches. No atomics: the result is exact and deterministic.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;

__device__ __forceinline__ void combine(float& best, int& idx, int& nan, float ob, int oi, int on) {
  if (ob > best || (ob == best && oi < idx)) {
    best = ob;
    idx = oi;
  }
  nan |= on;
}

__global__ void __launch_bounds__(THREADS)
argmax_rows_kernel(const float* __restrict__ logits, int* __restrict__ arg, int K, int V,
                   long long row_stride, long long batch_stride) {
  __shared__ float sb[THREADS / 32];
  __shared__ int si[THREADS / 32];
  __shared__ int sn[THREADS / 32];
  const int row = blockIdx.x, b = row / K, kk = row % K;
  const float* x = logits + b * batch_stride + kk * row_stride;
  float best = -INFINITY;
  int idx = INT_MAX, nan = 0;
  for (int i = threadIdx.x; i < V; i += THREADS) {
    const float val = x[i];
    if (isnan(val)) {
      nan = 1;
    } else if (val > best || (val == best && i < idx)) {
      best = val;
      idx = i;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, o);
    const int oi = __shfl_down_sync(0xffffffffu, idx, o);
    const int on = __shfl_down_sync(0xffffffffu, nan, o);
    combine(best, idx, nan, ob, oi, on);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sb[warp] = best;
    si[warp] = idx;
    sn[warp] = nan;
  }
  __syncthreads();
  if (warp == 0) {
    best = sb[lane];
    idx = si[lane];
    nan = sn[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_down_sync(0xffffffffu, best, o);
      const int oi = __shfl_down_sync(0xffffffffu, idx, o);
      const int on = __shfl_down_sync(0xffffffffu, nan, o);
      combine(best, idx, nan, ob, oi, on);
    }
    if (lane == 0) arg[row] = nan ? V : idx;
  }
}

__global__ void prefix_kernel(const int* __restrict__ draft, const int* __restrict__ arg,
                              uint8_t* __restrict__ mask, int* __restrict__ accept_len, int B,
                              int K) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int run = 1, n = 0;
  for (int kk = 0; kk < K; ++kk) {
    run = run && (arg[b * K + kk] == draft[b * K + kk]);
    mask[b * K + kk] = (uint8_t)run;
    n += run;
  }
  accept_len[b] = n;
}

}  // namespace

// draft int32 [B, K] contiguous; logits f32 with unit stride along V;
// arg_ws int32 [B*K]; mask bool [B, K]; accept_len int32 [B].
extern "C" int verify_prefix_f32(const void* draft, const void* logits, void* arg_ws, void* mask,
                                 void* accept_len, int B, int K, int V, long long row_stride,
                                 long long batch_stride, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  argmax_rows_kernel<<<B * K, THREADS, 0, st>>>(static_cast<const float*>(logits),
                                                static_cast<int*>(arg_ws), K, V, row_stride,
                                                batch_stride);
  prefix_kernel<<<(B + 127) / 128, 128, 0, st>>>(
      static_cast<const int*>(draft), static_cast<const int*>(arg_ws),
      static_cast<uint8_t*>(mask), static_cast<int*>(accept_len), B, K);
  return (int)cudaGetLastError();
}
