// Online-softmax GQA attention over a contiguous bf16 KV cache, for Hopper.
//
// Replaces: llm_inference_lab_tpu/ops/pallas/flash_decode.py
//           flash_decode_attention (tile body _accum_tile), bf16 chain-decode
//           variant: mask kv_pos <= p, scale D**-0.5. The window, ring,
//           softcap, scale-override and int8-cache variants are not ported yet.
//
//   out[b, s, h, :] = softmax_t(q[b,s,h] . k[b,h/g,t] * scale | t <= p[b,s]) @ v
//
// q bf16 [B, S, H, D]; k, v bf16 [B, KVH, T, D] (one layer's view of the
// stacked [L, B, KVH, T, D] cache, given by its batch and head strides);
// positions int32 [B, S]; out bf16 [B, S, H, D]. f32 m / l / accumulator.
//
// What bounds it on the H100: the bytes of K and V up to max(p) + 1 (plus q
// and out), at 3.35 TB/s. At the main path's T = 256 that is well under a
// megabyte per call, so launch latency and the per-block load latency of
// the few (b, kv-head) blocks dominate; no tensor cores are needed.
//
// Design (simple first):
//  * The GQA group is folded into the rows: row r = s * group + g. A block
//    owns one (b, kv head) and up to 64 rows (4 warps x 16 rows); grid.y
//    covers more rows, so the same kernel serves S = 1 (draft), S = 2
//    (K = 1 verify) and the S = 160 prefill.
//  * The TPU's sequential T grid axis becomes a loop inside the block over
//    32-key tiles of K and V staged in shared memory, up to the largest
//    position among the block's rows. One lane owns one key for the scores;
//    one warp owns one query row for the online softmax; the P.V product
//    broadcasts each p_j by shuffle and each lane accumulates D/32 columns.
//  * A row skips every tile that starts after its position, so its result
//    depends only on its own position and the cache, never on S or on its
//    neighbours: verify (S = 2) and baseline (S = 1) round identically.
//  * A row with no visible key (position -1) returns zeros, as attend_xla
//    does. The Pallas tile body would return the mean of V there (it masks
//    with a finite -1e30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;  // query rows per block
constexpr int WARPS = 4;
constexpr int RPW = ROWS / WARPS;
constexpr int BT = 32;  // keys per tile: one per lane

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const int* __restrict__ pos,
                    __nv_bfloat16* __restrict__ out, int S, int H, int KVH, int T,
                    long long stride_kb, long long stride_kh, float scale) {
  constexpr int DPL = D / 32;  // output columns per lane
  constexpr int C8 = D / 8;    // 16-byte chunks per row
  constexpr int KPAD = D + 8;  // padded K rows: conflict-free 16-byte reads
  __shared__ __align__(16) __nv_bfloat16 qs[ROWS][D];
  __shared__ __align__(16) __nv_bfloat16 ks[BT][KPAD];
  __shared__ __align__(16) __nv_bfloat16 vs[BT][D];
  __shared__ int kmax_s;

  const int b = blockIdx.x / KVH, h = blockIdx.x % KVH;
  const int group = H / KVH;
  const int nrows = S * group;
  const int r0 = blockIdx.y * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int e = threadIdx.x; e < ROWS * C8; e += WARPS * 32) {
    const int lr = e / C8, c = e % C8, r = r0 + lr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows) {
      const int s = r / group, g = r % group;
      val = *reinterpret_cast<const uint4*>(q + (((size_t)b * S + s) * H + h * group + g) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(&qs[lr][c * 8]) = val;
  }
  if (threadIdx.x == 0) kmax_s = -1;
  __syncthreads();
  for (int lr = threadIdx.x; lr < ROWS; lr += WARPS * 32) {
    const int r = r0 + lr;
    if (r < nrows) atomicMax(&kmax_s, pos[b * S + r / group]);
  }
  __syncthreads();
  const int kend = min(kmax_s + 1, T);
  const int ntiles = kend > 0 ? (kend + BT - 1) / BT : 0;

  float m[RPW], l[RPW], acc[RPW][DPL];
  int prow[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = r0 + warp + WARPS * i;
    prow[i] = r < nrows ? pos[b * S + r / group] : -1;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[i][d] = 0.f;
  }

  const __nv_bfloat16* kb = k + b * stride_kb + h * stride_kh;
  const __nv_bfloat16* vb = v + b * stride_kb + h * stride_kh;
  for (int t = 0; t < ntiles; ++t) {
    const int t0 = t * BT;
    __syncthreads();
    for (int e = threadIdx.x; e < BT * C8; e += WARPS * 32) {
      const int j = e / C8, c = e % C8;
      const size_t off = (size_t)(t0 + j) * D + c * 8;
      *reinterpret_cast<uint4*>(&ks[j][c * 8]) = *reinterpret_cast<const uint4*>(kb + off);
      *reinterpret_cast<uint4*>(&vs[j][c * 8]) = *reinterpret_cast<const uint4*>(vb + off);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int p = prow[i];
      if (p < t0) continue;  // warp-uniform: nothing visible in this tile
      const int lr = warp + WARPS * i;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < C8; ++c) {
        const uint4 kv4 = *reinterpret_cast<const uint4*>(&ks[lane][c * 8]);
        const uint4 qv4 = *reinterpret_cast<const uint4*>(&qs[lr][c * 8]);
        const __nv_bfloat162* kk = reinterpret_cast<const __nv_bfloat162*>(&kv4);
        const __nv_bfloat162* qq = reinterpret_cast<const __nv_bfloat162*>(&qv4);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 kf = __bfloat1622float2(kk[u]);
          const float2 qf = __bfloat1622float2(qq[u]);
          dot = fmaf(qf.x, kf.x, dot);
          dot = fmaf(qf.y, kf.y, dot);
        }
      }
      const float sc = (t0 + lane <= p) ? dot * scale : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(sc));  // finite: key t0 is visible
      const float alpha = expf(m[i] - m_new);
      const float pj = expf(sc - m_new);
      l[i] = l[i] * alpha + warp_sum(pj);
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[i][d] *= alpha;
#pragma unroll 8
      for (int j = 0; j < BT; ++j) {
        const float pb = __shfl_sync(0xffffffffu, pj, j);
        const __nv_bfloat162* vr = reinterpret_cast<const __nv_bfloat162*>(&vs[j][lane * DPL]);
#pragma unroll
        for (int d = 0; d < DPL / 2; ++d) {
          const float2 vf = __bfloat1622float2(vr[d]);
          acc[i][2 * d] = fmaf(pb, vf.x, acc[i][2 * d]);
          acc[i][2 * d + 1] = fmaf(pb, vf.y, acc[i][2 * d + 1]);
        }
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = r0 + warp + WARPS * i;
    if (r >= nrows) continue;
    const int s = r / group, g = r % group;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    __nv_bfloat16* o = out + (((size_t)b * S + s) * H + h * group + g) * D + lane * DPL;
#pragma unroll
    for (int d = 0; d < DPL; ++d) o[d] = __float2bfloat16(acc[i][d] * inv);
  }
}

}  // namespace

// Requires D in {64, 128}, T % 32 == 0, H % KVH == 0, contiguous q / out /
// positions and unit-stride [T, D] planes in k and v (checked in Python).
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v, const void* pos,
                                 void* out, int B, int S, int H, int KVH, int T, int D,
                                 long long stride_kb, long long stride_kh, float scale,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nrows = S * (H / KVH);
  dim3 grid(B * KVH, (nrows + ROWS - 1) / ROWS);
  dim3 block(WARPS * 32);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* pp = static_cast<const int*>(pos);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 128) {
    flash_decode_kernel<128><<<grid, block, 0, st>>>(qp, kp, vp, pp, op, S, H, KVH, T,
                                                     stride_kb, stride_kh, scale);
  } else if (D == 64) {
    flash_decode_kernel<64><<<grid, block, 0, st>>>(qp, kp, vp, pp, op, S, H, KVH, T,
                                                    stride_kb, stride_kh, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
