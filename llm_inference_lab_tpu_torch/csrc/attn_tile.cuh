// Body of the port's CUDA-core online-softmax attention kernel for Hopper,
// paged_flash.cu (kernel F). Kernels D and E (flash_decode.cu,
// flash_prefill.cu) used it until they moved to the tensor-core body
// attn_mma.cuh, which takes Options, first_key and allow_shared from here;
// where the text below speaks of D and E, it describes F's arithmetic,
// which D and E no longer share bit for bit.
//
// Replaces the tile body the three Pallas kernels share:
// llm_inference_lab_tpu/ops/pallas/flash_decode.py _accum_tile / _finalize
// (chain mask kv_pos <= p, f32 m / l / accumulator) with its static options
// scale (default D**-0.5), softcap, window and ring_len, for a bf16 cache and
// for an int8 cache with per-key f32 scales (the Pallas _kernel_quant
// variants).
//
// A block owns one (b, kv head) and rows_per_warp<D> * warps query rows,
// where row r stands for query position s = r / group and head h * group +
// r % group: the GQA group is folded into the rows. Its q rows are staged in
// shared memory; then the block walks 32-key tiles of K and V (also in
// shared memory) from the lowest first visible key among its rows up to the
// largest position among them. One lane owns one key for the scores; one
// warp owns one query row for the online softmax; the P.V product
// broadcasts each p_j by shuffle and each lane accumulates D/32 output
// columns. A warp holds acc[rows][D/32] per lane, so it takes 16 rows at
// D <= 128 and 8 at D = 256 (64 accumulator registers either way).
//
// Options (runtime arguments, 0 = off; with all of them off the arithmetic is
// the plain chain mask's, instruction for instruction):
//  * scale: the score scale (Gemma-2's query_pre_attn_scalar**-0.5).
//  * softcap: s -> softcap * tanh(s / softcap), after the score scale (and
//    for int8 after k's per-key scale) and before the mask, as in Pallas.
//  * window: a row at position p also masks keys at or below p - window
//    (Mistral, Gemma-2's local layers).
//  * ring (ring_len, needs a window): the rolling-buffer cache of Mistral's
//    kv_ring, where position j lives in slot j % ring of a plane of T <=
//    ring slots. Pallas masks slots: slot s is seen iff rel = (p - s) mod
//    ring < window and rel <= p. The body walks positions instead, as it
//    does without a ring, and loads position j from slot j % ring: a row
//    sees position j iff p - min(window, ring) < j <= p, j >= 0 and
//    j % ring < T, which is the same set of slots. So a row visits its
//    tiles in position order, the wrap of the ring costs nothing, and its
//    bits are those of a full cache holding the same rows. The keys type
//    carries the ring as a compile-time flag (PlaneKeys<D, T, true>): the
//    kernels instantiate the body with and without it and pick one by the
//    runtime argument, so the body without a ring has no ring code in it.
//
// The int8 cache (T = int8_t): the tile holds K and V as int8 (half the
// shared memory of bf16) and the keys' k and v scales. As in the Pallas
// body, k's scale multiplies the score column after the score scale
// (dot(q, k) * scale * ks[j]), the softmax sum l takes the unscaled p_j,
// and v's scale multiplies p_j before the P.V product (p_j * vs[j]), so the
// tiles are never dequantized. A key not loaded has zero bytes and zero
// scales.
//
// Row independence, on which the engine's parity rests: a row skips every
// tile that starts after its position and, with a window, every tile that
// ends before its first visible key p - window + 1 (with a ring, also every
// tile none of whose keys it sees has a slot below T); keys at or past the
// block's end are loaded as zeros and masked. So a row's bits depend only on
// its own position, its q and the keys (p - window, p] (and their scales):
// not on S, the other rows of its block, how many rows a block or a warp
// holds, T beyond p, or whether the keys are read from a contiguous plane, a
// ring or through a page table. D, E and F give the same bits for the same
// keys. Skipping the tiles a row does not see is also what keeps the
// running max finite: every tile a row processes holds a key it sees. The
// softmax arithmetic is written with explicit rounding intrinsics (__fmul_rn,
// __fsub_rn, __fmaf_rn, __fdiv_rn), so the compiler cannot contract it
// differently in the three kernels. A row with no visible key (position -1)
// returns zeros, as attend_xla does (the Pallas body returns the mean of V).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace attn {

constexpr int BT = 32;  // keys per tile: one per lane

// Query rows per warp: acc[RPW][D / 32] stays at 64 f32 registers a lane.
template <int D>
constexpr int RPW = D <= 128 ? 16 : 8;

// The static options of the Pallas tile body; 0 turns softcap, window and
// ring off.
struct Options {
  float scale;    // score scale
  float softcap;  // > 0: s -> softcap * tanh(s / softcap)
  int window;     // > 0: keys (p - window, p] only
  int ring;       // > 0 (with a window; >= BT): position j lives in slot j % ring
};

// A ring plane of T < ring slots (a cache shorter than the ring) holds only
// the positions j with j % ring < T. Whether one of the positions [a, b]
// (0 <= a <= b) is among them.
__device__ __forceinline__ bool ring_holds_one(int a, int b, int ring, int T) {
  if (T >= ring) return true;
  const int s = a % ring;
  return s < T || a + (ring - s) <= b;
}

// First key a row at position p >= 0 sees.
__device__ __forceinline__ int first_key(int p, int window) {
  return window > 0 ? max(p - window + 1, 0) : 0;
}

// Lets `kernel` take up to `dyn` bytes of dynamic shared memory beside its
// `stat` bytes of static shared memory, where the two pass the default 48 KB
// a block may take. Set once per kernel (the first launch).
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, size_t dyn, size_t stat) {
  if (dyn + stat <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
}

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

template <int D, class T>
struct Tile;

template <int D>
struct Tile<D, __nv_bfloat16> {
  __nv_bfloat16 k[BT][D + 8];  // padded rows: conflict-free 16-byte reads
  __nv_bfloat16 v[BT][D];
};

template <int D>
struct Tile<D, int8_t> {
  int8_t k[BT][D + 16];  // padded rows: conflict-free 16-byte reads
  int8_t v[BT][D];
  float ks[BT];  // the keys' k and v scales (0 for a key not loaded)
  float vs[BT];
};

// Keys of one (b, kv head) plane of a contiguous [T, D] cache, by slot; for
// int8, ks / vs point at the plane's [T] scales (unused for bf16). With RING
// the plane is a rolling buffer of opt.ring slots, position j in slot
// j % ring (attend_rows maps positions to slots); without, slot == position.
template <int D, class T, bool RING>
struct PlaneKeys {
  static constexpr bool kRing = RING;
  const T* k;
  const T* v;
  const float* ks;
  const float* vs;
  __device__ __forceinline__ size_t operator()(int slot) const { return (size_t)slot * D; }
  __device__ __forceinline__ size_t scale(int slot) const { return (size_t)slot; }
};

// Keys of one sequence in a page pool [N, KVH, P, D], k and v already
// offset to the kv head: key j lives in page table[j / P] at row j % P.
// The page is looked up per key, so any page size works. For int8, ks / vs
// point at the kv head's scales in the [N, KVH, P] scale pools.
template <int D, class T>
struct PagedKeys {
  static constexpr bool kRing = false;
  const T* k;
  const T* v;
  const float* ks;
  const float* vs;
  const int* table;  // this sequence's table row
  int P;
  long long stride_page;
  long long stride_spage;  // page stride of the scale pools
  __device__ __forceinline__ size_t operator()(int key) const {
    return (size_t)table[key / P] * stride_page + (size_t)(key % P) * D;
  }
  __device__ __forceinline__ size_t scale(int key) const {
    return (size_t)table[key / P] * stride_spage + (size_t)(key % P);
  }
};

// Columns [lane * DPL, lane * DPL + DPL) of an int8 V row, as floats.
template <int DPL>
__device__ __forceinline__ void int8_cols(const int8_t* p, float (&f)[DPL]) {
  if constexpr (DPL == 4) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    f[0] = (float)c.x, f[1] = (float)c.y, f[2] = (float)c.z, f[3] = (float)c.w;
  } else if constexpr (DPL == 8) {
    const int2 c = *reinterpret_cast<const int2*>(p);
    const char4 a = *reinterpret_cast<const char4*>(&c.x), b = *reinterpret_cast<const char4*>(&c.y);
    f[0] = (float)a.x, f[1] = (float)a.y, f[2] = (float)a.z, f[3] = (float)a.w;
    f[4] = (float)b.x, f[5] = (float)b.y, f[6] = (float)b.z, f[7] = (float)b.w;
  } else {
    static_assert(DPL == 2, "head dim 64, 128 or 256");
    const char2 c = *reinterpret_cast<const char2*>(p);
    f[0] = (float)c.x, f[1] = (float)c.y;
  }
}

// The whole block: q [B, S, H, D] bf16, positions [B, S] int32, out
// [B, S, H, D] bf16; rows [r0, r0 + RPW<D> * warps) of sequence b, kv head
// h; slots [0, T) available (a ring's position j in slot j % opt.ring, else
// slot j), of element type T_ (bf16, or int8 with scales).
// qs: shared memory for that many rows of D bf16 (16-byte aligned).
template <int D, class T_, class Keys>
__device__ __forceinline__ void attend_rows(const __nv_bfloat16* __restrict__ q,
                                            const int* __restrict__ pos,
                                            __nv_bfloat16* __restrict__ out, const Keys& keys,
                                            int b, int h, int S, int H, int KVH, int r0, int T,
                                            const Options opt, __nv_bfloat16* qs,
                                            Tile<D, T_>& tile, int& kmax_s, int& kmin_s) {
  constexpr bool INT8 = std::is_same<T_, int8_t>::value;
  constexpr bool RING = Keys::kRing;
  constexpr int DPL = D / 32;  // output columns per lane
  constexpr int C8 = D / 8;    // 16-byte chunks per q row
  constexpr int KC = D * (int)sizeof(T_) / 16;  // 16-byte chunks per K / V row
  constexpr int EPC = 16 / (int)sizeof(T_);     // cache elements per chunk
  constexpr int R = RPW<D>;
  constexpr int DOT_UNROLL = C8 < 16 ? C8 : 16;  // q.k chunks in flight
  const int nthreads = blockDim.x, warps = nthreads / 32, rows = warps * R;
  const int group = H / KVH;
  const int nrows = S * group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // A ring's slots hold at most its last `ring` positions: attend_xla's
  // rel < window with rel < ring is the window min(window, ring).
  const int window = RING ? min(opt.window, opt.ring) : opt.window;

  for (int e = threadIdx.x; e < rows * C8; e += nthreads) {
    const int lr = e / C8, c = e % C8, r = r0 + lr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows) {
      const int s = r / group, g = r % group;
      val = *reinterpret_cast<const uint4*>(q + (((size_t)b * S + s) * H + h * group + g) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(qs + (size_t)lr * D + c * 8) = val;
  }
  if (threadIdx.x == 0) kmax_s = -1, kmin_s = INT_MAX;
  __syncthreads();
  for (int lr = threadIdx.x; lr < rows; lr += nthreads) {
    const int r = r0 + lr;
    const int p = r < nrows ? pos[b * S + r / group] : -1;
    if (p >= 0) atomicMax(&kmax_s, p), atomicMin(&kmin_s, first_key(p, window));
  }
  __syncthreads();
  // Tiles [tfirst, ntiles) of positions: from the lowest first visible key to
  // the largest position (no tile at all when every row is dead). Without a
  // ring the plane ends at position T; a ring's positions run on past T, and
  // the loads check each one's slot.
  const int kend = RING ? kmax_s + 1 : min(kmax_s + 1, T);
  const int ntiles = kend > 0 ? (kend + BT - 1) / BT : 0;
  const int tfirst = kend > 0 ? kmin_s / BT : 0;

  float m[R], l[R], acc[R][DPL];
  int prow[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + warp + warps * i;
    prow[i] = r < nrows ? pos[b * S + r / group] : -1;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[i][d] = 0.f;
  }

  for (int t = tfirst; t < ntiles; ++t) {
    const int t0 = t * BT;
    const int s0 = RING ? t0 % opt.ring : t0;
    // The slot of position t0 + j (j < BT): one modulo a tile, then at most
    // one wrap (ring >= BT), a select rather than a branch, so the tile's
    // loads still issue back to back.
    const auto slot = [&](int j) {
      const int s = s0 + j;
      if constexpr (RING) return s >= opt.ring ? s - opt.ring : s;
      return s;
    };
    __syncthreads();
    for (int e = threadIdx.x; e < BT * KC; e += nthreads) {
      const int j = e / KC, c = e % KC, key = t0 + j, s = slot(j);
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (key < kend && (!RING || s < T)) {  // never past the block's last key or the plane
        const size_t off = keys(s) + c * EPC;
        kv4 = *reinterpret_cast<const uint4*>(keys.k + off);
        vv4 = *reinterpret_cast<const uint4*>(keys.v + off);
      }
      *reinterpret_cast<uint4*>(&tile.k[j][c * EPC]) = kv4;
      *reinterpret_cast<uint4*>(&tile.v[j][c * EPC]) = vv4;
    }
    if constexpr (INT8) {
      for (int j = threadIdx.x; j < BT; j += nthreads) {
        const int key = t0 + j, s = slot(j);
        const bool live = key < kend && (!RING || s < T);
        tile.ks[j] = live ? keys.ks[keys.scale(s)] : 0.f;
        tile.vs[j] = live ? keys.vs[keys.scale(s)] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int p = prow[i];
      // Warp-uniform: nothing visible in this tile (it starts after p, or
      // ends before the row's first visible key, or none of the ring's
      // positions the row sees in it has a slot in the plane).
      if (p < t0 || (window > 0 && t0 + BT + window <= p + 1)) continue;
      if constexpr (RING) {
        if (!ring_holds_one(max(t0, p - window + 1), min(t0 + BT - 1, p), opt.ring, T)) continue;
      }
      const __nv_bfloat16* qrow = qs + (size_t)(warp + warps * i) * D;
      float dot = 0.f;
      if constexpr (INT8) {
#pragma unroll
        for (int c = 0; c < KC; ++c) {  // 16 bytes of k against two q chunks
          const uint4 kv4 = *reinterpret_cast<const uint4*>(&tile.k[lane][c * 16]);
          const char4* kk = reinterpret_cast<const char4*>(&kv4);
#pragma unroll
          for (int hq = 0; hq < 2; ++hq) {
            const uint4 qv4 = *reinterpret_cast<const uint4*>(qrow + c * 16 + hq * 8);
            const __nv_bfloat162* qq = reinterpret_cast<const __nv_bfloat162*>(&qv4);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const char4 k4 = kk[2 * hq + u];
              const float2 q0 = __bfloat1622float2(qq[2 * u]);
              const float2 q1 = __bfloat1622float2(qq[2 * u + 1]);
              dot = fmaf(q0.x, (float)k4.x, dot);
              dot = fmaf(q0.y, (float)k4.y, dot);
              dot = fmaf(q1.x, (float)k4.z, dot);
              dot = fmaf(q1.y, (float)k4.w, dot);
            }
          }
        }
      } else {
#pragma unroll (DOT_UNROLL)
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
      }
      const int key = t0 + lane;
      float sc = -INFINITY;
      if (key <= p && slot(lane) < T && (window <= 0 || key > p - window)) {
        sc = __fmul_rn(dot, opt.scale);
        if constexpr (INT8) sc = __fmul_rn(sc, tile.ks[lane]);
        if (opt.softcap > 0.f) sc = __fmul_rn(tanhf(__fdiv_rn(sc, opt.softcap)), opt.softcap);
      }
      // Finite: the row sees a key of this tile (the skip above).
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float alpha = expf(__fsub_rn(m[i], m_new));
      const float pj = expf(__fsub_rn(sc, m_new));
      l[i] = __fmaf_rn(l[i], alpha, warp_sum(pj));
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[i][d] = __fmul_rn(acc[i][d], alpha);
      if constexpr (INT8) {
        const float pw = __fmul_rn(pj, tile.vs[lane]);  // l above took the unscaled p_j
#pragma unroll 8
        for (int j = 0; j < BT; ++j) {
          const float pb = __shfl_sync(0xffffffffu, pw, j);
          float vf[DPL];
          int8_cols<DPL>(&tile.v[j][lane * DPL], vf);
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[i][d] = fmaf(pb, vf[d], acc[i][d]);
        }
      } else {
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
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
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
