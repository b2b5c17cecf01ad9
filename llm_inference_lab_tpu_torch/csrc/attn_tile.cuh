// Shared body of the port's online-softmax attention kernels for Hopper:
// flash_decode.cu (kernel D), flash_prefill.cu (kernel E) and
// paged_flash.cu (kernel F) include it.
//
// Replaces the tile body the three Pallas kernels share:
// llm_inference_lab_tpu/ops/pallas/flash_decode.py _accum_tile / _finalize
// (bf16 chain mask kv_pos <= p, scale D**-0.5, f32 m / l / accumulator).
//
// A block owns one (b, kv head) and ROWS = 16 * warps query rows, where row
// r stands for query position s = r / group and head h * group + r % group:
// the GQA group is folded into the rows. Its q rows are staged in shared
// memory; then the block walks 32-key tiles of K and V (also in shared
// memory) up to the largest position among its rows. One lane owns one key
// for the scores; one warp owns one query row for the online softmax; the
// P.V product broadcasts each p_j by shuffle and each lane accumulates D/32
// output columns.
//
// Row independence, on which the engine's parity rests: a row skips every
// tile that starts after its position, and keys at or past the block's end
// are loaded as zeros and masked. So a row's bits depend only on its own
// position, its q and the keys [0, p]: not on S, the other rows of its
// block, how many rows a block holds, T beyond p, or whether the keys are
// read from a contiguous plane or through a page table. D, E and F give the
// same bits for the same keys. The softmax arithmetic is written with
// explicit rounding intrinsics (__fmul_rn, __fsub_rn, __fmaf_rn), so the
// compiler cannot contract it differently in the three kernels. A row with
// no visible key (position -1) returns zeros, as attend_xla does (the
// Pallas body returns the mean of V).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int BT = 32;   // keys per tile: one per lane
constexpr int RPW = 16;  // query rows per warp

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
struct Tile {
  __nv_bfloat16 k[BT][D + 8];  // padded rows: conflict-free 16-byte reads
  __nv_bfloat16 v[BT][D];
};

// Keys of one (b, kv head) plane of a contiguous [T, D] cache.
template <int D>
struct PlaneKeys {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __device__ __forceinline__ size_t operator()(int key) const { return (size_t)key * D; }
};

// Keys of one sequence in a page pool [N, KVH, P, D], k and v already
// offset to the kv head: key j lives in page table[j / P] at row j % P.
// The page is looked up per key, so any page size works.
template <int D>
struct PagedKeys {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* table;  // this sequence's table row
  int P;
  long long stride_page;
  __device__ __forceinline__ size_t operator()(int key) const {
    return (size_t)table[key / P] * stride_page + (size_t)(key % P) * D;
  }
};

// The whole block: q [B, S, H, D] bf16, positions [B, S] int32, out
// [B, S, H, D] bf16; rows [r0, r0 + ROWS) of sequence b, kv head h; keys
// [0, T) available. qs: shared memory for ROWS * D bf16 (16-byte aligned).
template <int D, class Keys>
__device__ __forceinline__ void attend_rows(const __nv_bfloat16* __restrict__ q,
                                            const int* __restrict__ pos,
                                            __nv_bfloat16* __restrict__ out, const Keys& keys,
                                            int b, int h, int S, int H, int KVH, int r0, int T,
                                            float scale, __nv_bfloat16* qs, Tile<D>& tile,
                                            int& kmax_s) {
  constexpr int DPL = D / 32;  // output columns per lane
  constexpr int C8 = D / 8;    // 16-byte chunks per row
  const int nthreads = blockDim.x, warps = nthreads / 32, rows = warps * RPW;
  const int group = H / KVH;
  const int nrows = S * group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int e = threadIdx.x; e < rows * C8; e += nthreads) {
    const int lr = e / C8, c = e % C8, r = r0 + lr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows) {
      const int s = r / group, g = r % group;
      val = *reinterpret_cast<const uint4*>(q + (((size_t)b * S + s) * H + h * group + g) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(qs + (size_t)lr * D + c * 8) = val;
  }
  if (threadIdx.x == 0) kmax_s = -1;
  __syncthreads();
  for (int lr = threadIdx.x; lr < rows; lr += nthreads) {
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
    const int r = r0 + warp + warps * i;
    prow[i] = r < nrows ? pos[b * S + r / group] : -1;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[i][d] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int t0 = t * BT;
    __syncthreads();
    for (int e = threadIdx.x; e < BT * C8; e += nthreads) {
      const int j = e / C8, c = e % C8, key = t0 + j;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (key < kend) {  // never read past the block's last visible key
        const size_t off = keys(key) + c * 8;
        kv4 = *reinterpret_cast<const uint4*>(keys.k + off);
        vv4 = *reinterpret_cast<const uint4*>(keys.v + off);
      }
      *reinterpret_cast<uint4*>(&tile.k[j][c * 8]) = kv4;
      *reinterpret_cast<uint4*>(&tile.v[j][c * 8]) = vv4;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int p = prow[i];
      if (p < t0) continue;  // warp-uniform: nothing visible in this tile
      const __nv_bfloat16* qrow = qs + (size_t)(warp + warps * i) * D;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < C8; ++c) {
        const uint4 kv4 = *reinterpret_cast<const uint4*>(&tile.k[lane][c * 8]);
        const uint4 qv4 = *reinterpret_cast<const uint4*>(qrow + c * 8);
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
      const float sc = (t0 + lane <= p && t0 + lane < T) ? __fmul_rn(dot, scale) : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(sc));  // finite: key t0 is visible
      const float alpha = expf(__fsub_rn(m[i], m_new));
      const float pj = expf(__fsub_rn(sc, m_new));
      l[i] = __fmaf_rn(l[i], alpha, warp_sum(pj));
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[i][d] = __fmul_rn(acc[i][d], alpha);
#pragma unroll 8
      for (int j = 0; j < BT; ++j) {
        const float pb = __shfl_sync(0xffffffffu, pj, j);
        const __nv_bfloat162* vr = reinterpret_cast<const __nv_bfloat162*>(&tile.v[j][lane * DPL]);
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
    const int r = r0 + warp + warps * i;
    if (r >= nrows) continue;
    const int s = r / group, g = r % group;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    __nv_bfloat16* o = out + (((size_t)b * S + s) * H + h * group + g) * D + lane * DPL;
#pragma unroll
    for (int d = 0; d < DPL; ++d) o[d] = __float2bfloat16(__fmul_rn(acc[i][d], inv));
  }
}

}  // namespace attn
