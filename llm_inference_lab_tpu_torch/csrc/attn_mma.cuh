// Tensor-core body of kernels D (flash_decode.cu), E (flash_prefill.cu) and
// F (paged_flash.cu): online-softmax GQA attention over a bf16 or int8 KV
// cache with mma.sync.m16n8k16 (bf16 in, f32 accumulate), K/V tiles
// double-buffered in shared memory with cp.async and fed to the tensor cores
// by ldmatrix. D and E read a contiguous plane (or a ring), F a page pool
// through a page table; the three differ only in where key j is loaded
// from (the address map), so they give the same bits on the same keys.
//
// Replaces the tile body the Pallas kernels share:
// llm_inference_lab_tpu/ops/pallas/flash_decode.py _accum_tile / _finalize
// (paged_flash.py _body calls it too), with its static options scale,
// softcap, window and ring_len, for a bf16 cache and an int8 cache with
// per-key f32 scales. What it computes, as
// Pallas does: scores q.k^T in f32, times the scale, for int8 times k's
// per-key scale, then the softcap, then the mask; the online softmax in f32
// (l takes the unscaled p; exp(x - m) is 2^(x log2 e - m log2 e), one fma
// and the card's ex2.approx; the combine of kernel D uses expf); p (for
// int8 times v's per-key scale) rounded to
// bf16 before the P.V product (Pallas rounds p to the cache's compute dtype,
// flash_decode.py:95). An int8 tile is converted to bf16 in shared memory on
// its way to the tensor cores, which is exact: the scales go to the score
// columns and to p, never to the tile.
//
// Block: 4 warps, 64 query rows; row r is query position r / group and head
// h * group + r % group of one (b, kv head): the GQA group is folded into the
// rows, so the group's heads share each K/V tile. Warp w owns rows
// [16 w, 16 w + 16) as one m16 fragment. The block walks key tiles of BK<D>
// positions (64, or 32 at head dim 256, where the accumulator alone is 128
// f32 registers a thread) from its lowest first visible key to its largest
// position; a warp skips a tile in which none of its rows sees a key.
//
// Tiles sit at absolute key positions (multiples of BK<D>), and a tile in
// which a row sees no key leaves that row exactly unchanged: its p are 0,
// its alpha exactly 1, and no -inf - -inf is ever formed (a row that has
// seen nothing keeps m = -inf, l = 0, acc = 0). So a row's bits depend only
// on its position, its q and its keys: not on S, the rows beside it, how
// many rows a block holds, T past its position, or whether its keys come
// from a contiguous plane, a ring or a page pool. The address maps:
//  * PLANE: position j is row j of the [T, D] plane;
//  * RING: position j is slot j % ring (one % a tile and a select a key, so
//    a ring needs at least BK<D> slots);
//  * PAGED: position j is row j % P of pool page table[b, j / P] (P a power
//    of two); the table is read once for each page a tile spans, into
//    shared memory beside the tile, and only for pages that hold a key of
//    the block's live range. A paged block loads no key outside [its lowest
//    first visible key, its largest position] (zeros instead), so dead
//    pages, pages below the window, unused table entries and the dummy
//    page 0 are never read for a live row.
//  * SHARD: position j is row j - t0 of the [T, D] plane, which holds the
//    positions [t0, t0 + T) only (a rank's slice of a cache whose T is split
//    over the seq axis, or a K/V block of ring attention); no other key
//    exists. The output is then f32, not rounded, with each row's f32
//    log-sum-exp m + log(l) beside it (-inf for a row that saw no key), so
//    the slices' rows merge exactly as the splits of kernel D combine.
// A row with no visible key (position -1) returns zeros, as attend_xla
// does.
//
// The tree variant (kernels D and F, TREE = true) is attend_xla's tree
// branch: the S rows of a verify chunk are the nodes of a speculation tree,
// written at slots chunk_start .. chunk_start + S - 1 of their sequence but
// at logical positions by depth, so a row's keys are not [first key,
// position]. Row s sees every key before chunk_start[b] and key
// chunk_start[b] + j of the chunk iff bit j % 32 of word j / 32 of its
// ancestry row bits[s] is set (its own node and its ancestors; a row has
// W = ceil(S / 32) words, any S); nothing past the chunk. The block's key
// range is [0, chunk_start + S), so the splits past the chunk stay empty;
// the ancestry bits mask inside it. A thread reads a row's words from
// global memory through the read-only path, only for a key tile that
// reaches into the chunk, and only the (at most three) words the tile's
// part of the chunk spans; static shared memory does not grow with S. No
// window or ring.
// Over a shard (D's shard variant with TREE) chunk_start is an absolute
// position like the tile's keys: a rank's slice may hold the keys before
// the chunk, part of the chunk (a chunk straddles two slices) or nothing a
// row sees, which leaves that row's log-sum-exp at -inf.
//
// Split over T (kernels D and F, nz >= 1): block z of a (b, kv head, row
// block) takes the keys of split lo / SPLIT + z, where lo is the block's
// lowest first visible key and splits are fixed absolute ranges of SPLIT
// positions (independent of S and T). Each block writes f32 (m, l, acc)
// partials of its rows to a workspace; the last block to take a ticket on
// the row block's counter combines them, in ascending split order, skipping
// the splits in which a row saw nothing, and resets the counter to 0. One
// launch, no memset, no host sync. A row whose keys lie in one split gets
// acc / l in both paths (the combine's weight is exp(0) = 1), so with nz = 1
// the block writes its rows directly. If the block's rows span more splits
// than the grid has (rows of one sequence further apart than the wrapper
// assumed), those rows are written as NaN rather than wrong.
//
// The softmax arithmetic is written with explicit rounding intrinsics
// (__fmul_rn, __fadd_rn, __fmaf_rn, __fdiv_rn), so the compiler cannot
// contract it differently in the three kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// Internal linkage (an unnamed namespace): flash_decode.cu and
// flash_prefill.cu build into separate libraries, each with its own CUDA
// runtime, and a kernel symbol shared by name between the two would be
// registered with one runtime and launched through the other.
namespace mma {
namespace {

constexpr int WARPS = 4;
constexpr int ROWS = 16 * WARPS;  // query rows a block
constexpr int SPLIT = 256;        // keys a split of kernels D and F (a multiple of every BK)

// Where key position j is loaded from (see the head of this file).
enum Map { MAP_PLANE, MAP_RING, MAP_PAGED, MAP_SHARD };

// The static options of the Pallas tile body; 0 turns softcap, window and
// ring off.
struct Options {
  float scale;    // score scale
  float softcap;  // > 0: s -> softcap * tanh(s / softcap)
  int window;     // > 0: keys (p - window, p] only
  int ring;       // > 0 (with a window; >= 64): position j lives in slot j % ring
};

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

// Keys a tile: 64, or 32 at head dim 256 (the accumulator is 128 registers).
// Every head dim here (64, 96, 128, 256) is a multiple of 16, which is all
// the body needs: D / 16 k-steps of the score product, D / 8 output n-tiles,
// whole 16-byte rows; at 96 the q and bf16 tile rows are 208 bytes, 13
// 16-byte units, odd, so ldmatrix's 8 rows still fall in 8 distinct bank
// groups.
template <int D>
constexpr int BK = D == 256 ? 32 : 64;

// Dynamic shared memory: q rows, two stages of K and V (and for int8 their
// per-key scales), and for int8 one bf16 copy of the current tile.
template <int D, class T>
struct Layout {
  static constexpr bool INT8 = std::is_same<T, int8_t>::value;
  static constexpr int QS = D + 8;  // bf16 row stride of q and bf16 tiles: ldmatrix conflict-free
  static constexpr int RS = INT8 ? D + 16 : QS * 2;  // bytes a staged K or V row
  static constexpr size_t q_bytes = (size_t)ROWS * QS * 2;
  static constexpr size_t kv_bytes = (size_t)BK<D> * RS;       // K (or V) of one stage
  static constexpr size_t sc_bytes = INT8 ? BK<D> * 4 : 0;     // ks (or vs) of one stage
  static constexpr size_t stage_bytes = 2 * kv_bytes + 2 * sc_bytes;
  static constexpr size_t conv_bytes = INT8 ? (size_t)2 * BK<D> * QS * 2 : 0;
  static constexpr size_t total = q_bytes + 2 * stage_bytes + conv_bytes;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 (or 4) bytes global -> shared; n < the size zero-fills the rest (n = 0:
// nothing is read).
__device__ __forceinline__ void cp16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low 16 bits
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// The same bits on the four lanes of a quad: (a + b) + (c + d) in every
// order of commutation.
__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// F's page table: table int32 [B, n] of page ids, pages of 1 << lg rows.
struct Pages {
  const int* table;
  int n, lg;
};

// The tree variant's operands: bits uint32 [S, W] with W = ceil(S / 32),
// bit j % 32 of bits[s, j / 32] set iff node s sees node j of the chunk;
// start int32 [B], the chunk's first slot.
struct Tree {
  const unsigned* bits;
  const int* start;
};

// The shard map's operands: the plane's first position, and lse f32
// [B, H, S] for each row's log-sum-exp.
struct Shard {
  int t0;
  float* lse;
};

// The whole kernel. q bf16 [B, S, H, D]; positions int32 [B, S]; out bf16
// [B, S, H, D]. PLANE and RING: k, v [B, KVH, T, D] planes through their
// batch and head strides (bf16, or int8 with scales ks, vs [B, KVH, T]
// through theirs). PAGED: k, v pools [N, KVH, P, D] with page stride
// stride_kb and head stride stride_kh (scale pools [N, KVH, P]: stride_sb,
// stride_sh), T = pages.n * P, key j of sequence b on page pages.table[b, j
// >> lg]. nz = 0: kernel E, the block walks all its keys and writes its
// rows. nz >= 1: kernels D and F, grid.z = nz splits; ws holds gridDim.x *
// gridDim.y * nz * ROWS * (D + 2) floats and counters gridDim.x * gridDim.y
// zeros (nz > 1). TREE: pos is not read; tree gives each row's keys.
// SHARD: out is f32 and shard.lse gets each row's log-sum-exp.
template <int D, class T_, int MAP, bool TREE>
__global__ void __launch_bounds__(WARPS * 32)
attend_kernel(const __nv_bfloat16* __restrict__ q, const T_* __restrict__ k,
              const T_* __restrict__ v, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ pos,
              void* __restrict__ out, float* __restrict__ ws,
              unsigned* __restrict__ counters, int S, int H, int KVH, int Tk,
              long long stride_kb, long long stride_kh, long long stride_sb, long long stride_sh,
              Options opt, int nz, Pages pages, Tree tree, Shard shard) {
  constexpr bool RING = MAP == MAP_RING;
  constexpr bool PAGED = MAP == MAP_PAGED;
  constexpr bool SHARD = MAP == MAP_SHARD;
  using L = Layout<D, T_>;
  constexpr bool INT8 = L::INT8;
  constexpr int BKD = BK<D>;
  constexpr int NT = BKD / 8;  // score n-tiles of 8 keys
  constexpr int KT = BKD / 16;  // P.V k-steps of 16 keys
  constexpr int DT = D / 8;     // output n-tiles of 8 columns
  constexpr int QS = L::QS;
  constexpr int CH = D * (int)sizeof(T_) / 16;  // 16-byte chunks a cache row
  constexpr float NEG_INF = -INFINITY;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int pos_s[ROWS];
  __shared__ int lo_s, hi_s;
  __shared__ unsigned last_s;
  __shared__ int page_s[2][PAGED ? BK<D> : 1];  // the pages a stage's tile spans

  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* stages = smem + L::q_bytes;
  __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(stages + 2 * L::stage_bytes);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / KVH, h = blockIdx.x % KVH;
  const int group = H / KVH, nrows = S * group, r0 = blockIdx.y * ROWS;
  // A ring's slots hold at most its last `ring` positions: attend_xla's
  // rel < window with rel < ring is the window min(window, ring).
  const int window = RING ? min(opt.window, opt.ring) : opt.window;
  // A page pool has no batch axis: the table gives each key's page.
  const size_t boff = PAGED ? 0 : (size_t)b * stride_kb;
  const size_t sboff = PAGED ? 0 : (size_t)b * stride_sb;
  const T_* kp = k + boff + (size_t)h * stride_kh;
  const T_* vp = v + boff + (size_t)h * stride_kh;
  const float* ksp = INT8 ? ks + sboff + (size_t)h * stride_sh : nullptr;
  const float* vsp = INT8 ? vs + sboff + (size_t)h * stride_sh : nullptr;
  const int* table = PAGED ? pages.table + (size_t)b * pages.n : nullptr;

  // The tree's chunk starts at slot cs of this sequence (0 without a tree).
  const int cs = TREE ? tree.start[b] : 0;
  // The plane's first position: the shard's t0, else 0.
  const int kbeg = SHARD ? shard.t0 : 0;

  // q rows (zeros past the last row) and positions (-1 past it). A tree row
  // takes the chunk's last slot as its position: its keys are [0, cs + S).
  for (int e = tid; e < ROWS * (D / 8); e += WARPS * 32) {
    const int lr = e / (D / 8), c = e % (D / 8), r = r0 + lr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows) {
      const int s = r / group, gi = r % group;
      val = *reinterpret_cast<const uint4*>(q + (((size_t)b * S + s) * H + h * group + gi) * D +
                                            c * 8);
    }
    *reinterpret_cast<uint4*>(qs + (size_t)lr * QS + c * 8) = val;
  }
  if (tid < ROWS) {
    const int r = r0 + tid;
    if constexpr (TREE) {
      pos_s[tid] = r < nrows ? cs + S - 1 : -1;
    } else {
      pos_s[tid] = r < nrows ? pos[b * S + r / group] : -1;
    }
  }
  if (tid == 0) lo_s = INT_MAX, hi_s = -1;
  __syncthreads();
  if (tid < ROWS) {
    const int p = pos_s[tid];
    if (p >= 0) atomicMin(&lo_s, first_key(p, window)), atomicMax(&hi_s, p);
  }
  // This warp's rows: lowest first visible key and largest position.
  int wlo = INT_MAX, whi = -1;
  {
    const int p = lane < 16 ? pos_s[warp * 16 + lane] : -1;
    if (p >= 0) wlo = first_key(p, window), whi = p;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      wlo = min(wlo, __shfl_xor_sync(0xffffffffu, wlo, o));
      whi = max(whi, __shfl_xor_sync(0xffffffffu, whi, o));
    }
  }
  __syncthreads();
  const int lo = SHARD ? max(lo_s, kbeg) : lo_s, hi = hi_s;
  // Positions [lo, kend) exist: without a ring the plane ends at T (a shard's
  // at t0 + T); a ring's positions run on past T and each load checks its
  // slot.
  const int kend = RING ? hi + 1 : min(hi + 1, kbeg + Tk);
  const bool any = hi >= 0 && kend > lo;
  int ta = any ? lo / BKD : 0, tb = any ? (kend - 1) / BKD : -1;
  const int nsp = any ? (kend - 1) / SPLIT - lo / SPLIT + 1 : 0;  // splits the block's keys span
  const int z = blockIdx.z;
  if (nz > 0) {
    if (z < nsp) {
      const int s0 = (lo / SPLIT + z) * SPLIT;
      ta = max(ta, s0 / BKD);
      tb = min(tb, (s0 + SPLIT) / BKD - 1);
    } else {
      tb = ta - 1;  // nothing in this split: take the ticket only
    }
  }

  // Stage st <- the keys of tile t (zeros for keys that do not exist, and
  // for a page pool also for keys outside [lo, kend)).
  const auto load = [&](int t, int st) {
    unsigned char* sb = stages + st * L::stage_bytes;
    float* kst = reinterpret_cast<float*>(sb + 2 * L::kv_bytes);
    const int t0 = t * BKD;
    if constexpr (PAGED) {
      // The pages the tile spans, each looked up once (a page holding no
      // key of [lo, kend) is not looked up); block-uniform, so the barrier
      // is reached by every thread. A stage's page ids are read only here,
      // and two barriers of the loop lie between this stage's last use and
      // its next fill.
      int* pg = page_s[st];
      const int lg = pages.lg, pmask = (1 << lg) - 1;
      const int pg0 = t0 >> lg, npg = ((t0 + BKD - 1) >> lg) - pg0 + 1;
      for (int i = tid; i < npg; i += WARPS * 32) {
        const int pi = pg0 + i;
        pg[i] = (pi << lg) < kend && ((pi + 1) << lg) > lo ? table[pi] : 0;
      }
      __syncthreads();
      for (int e = tid; e < BKD * CH; e += WARPS * 32) {
        const int j = e / CH, c = e % CH, key = t0 + j;
        const bool live = key >= lo && key < kend;
        const size_t off = live ? (size_t)pg[(key >> lg) - pg0] * stride_kb +
                                      (size_t)(key & pmask) * D + c * (16 / sizeof(T_))
                                : 0;
        cp16(sb + (size_t)j * L::RS + c * 16, kp + off, live ? 16 : 0);
        cp16(sb + L::kv_bytes + (size_t)j * L::RS + c * 16, vp + off, live ? 16 : 0);
      }
      if constexpr (INT8) {
        for (int j = tid; j < BKD; j += WARPS * 32) {
          const int key = t0 + j;
          const bool live = key >= lo && key < kend;
          const size_t off =
              live ? (size_t)pg[(key >> lg) - pg0] * stride_sb + (size_t)(key & pmask) : 0;
          cp4(kst + j, ksp + off, live ? 4 : 0);
          cp4(kst + BKD + j, vsp + off, live ? 4 : 0);
        }
      }
    } else {
      const int s0 = RING ? t0 % opt.ring : t0 - kbeg;  // a shard's slot may be < 0
      for (int e = tid; e < BKD * CH; e += WARPS * 32) {
        const int j = e / CH, c = e % CH;
        int slot = s0 + j;
        if (RING && slot >= opt.ring) slot -= opt.ring;
        const bool live = t0 + j < kend && slot < Tk && (!SHARD || slot >= 0);
        const size_t off = live ? (size_t)slot * D + c * (16 / sizeof(T_)) : 0;
        cp16(sb + (size_t)j * L::RS + c * 16, kp + off, live ? 16 : 0);
        cp16(sb + L::kv_bytes + (size_t)j * L::RS + c * 16, vp + off, live ? 16 : 0);
      }
      if constexpr (INT8) {
        for (int j = tid; j < BKD; j += WARPS * 32) {
          int slot = s0 + j;
          if (RING && slot >= opt.ring) slot -= opt.ring;
          const bool live = t0 + j < kend && slot < Tk && (!SHARD || slot >= 0);
          cp4(kst + j, ksp + (live ? slot : 0), live ? 4 : 0);
          cp4(kst + BKD + j, vsp + (live ? slot : 0), live ? 4 : 0);
        }
      }
    }
  };

  const int g = lane >> 2, tq = lane & 3;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;
  const int p0 = pos_s[lr0], p1 = pos_s[lr1];
  // The tree variant: each row's W ancestry words (null past the last row).
  const int W = TREE ? (S + 31) >> 5 : 0;
  const unsigned* anc0 = nullptr;
  const unsigned* anc1 = nullptr;
  if constexpr (TREE) {
    if (r0 + lr0 < nrows) anc0 = tree.bits + (size_t)((r0 + lr0) / group) * W;
    if (r0 + lr1 < nrows) anc1 = tree.bits + (size_t)((r0 + lr1) / group) * W;
  }
  // Row r sees key k iff (unsigned)(k - lo_r) <= span_r: its keys are
  // [first visible key, position] (cut at the plane's ends without a ring);
  // a row with none gets lo_r = 2^30, which no key reaches. A ring plane
  // shorter than the ring also checks each key's slot (slot_check).
  const auto row_range = [&](int p, unsigned& span) {
    const int first = max(first_key(p, window), kbeg);
    const int last = RING ? p : min(p, kbeg + Tk - 1);
    const bool any_key = p >= 0 && last >= first;
    span = any_key ? (unsigned)(last - first) : 0u;
    return any_key ? first : 1 << 30;
  };
  unsigned span0, span1;
  const int lo0 = row_range(p0, span0), lo1 = row_range(p1, span1);
  const bool slot_check = RING && Tk < opt.ring;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  if (ta <= tb) load(ta, 0);
  cp_commit();
  for (int t = ta; t <= tb; ++t) {
    const int st = (t - ta) & 1;
    if (t < tb) load(t + 1, st ^ 1);
    cp_commit();
    cp_wait1();
    __syncthreads();
    unsigned char* sb = stages + st * L::stage_bytes;
    const __nv_bfloat16* Kt = reinterpret_cast<const __nv_bfloat16*>(sb);
    const __nv_bfloat16* Vt = reinterpret_cast<const __nv_bfloat16*>(sb + L::kv_bytes);
    const float* kst = reinterpret_cast<const float*>(sb + 2 * L::kv_bytes);
    const float* vst = kst + BKD;
    if constexpr (INT8) {  // int8 -> bf16 (exact) into conv
      for (int e = tid; e < 2 * BKD * (D / 16); e += WARPS * 32) {
        const int kv = e / (BKD * (D / 16)), j = (e / (D / 16)) % BKD, c = e % (D / 16);
        const uint4 raw =
            *reinterpret_cast<const uint4*>(sb + kv * L::kv_bytes + (size_t)j * L::RS + c * 16);
        const int8_t* by = reinterpret_cast<const int8_t*>(&raw);
        uint4 a, z4;
        unsigned* pa = reinterpret_cast<unsigned*>(&a);
        unsigned* pz = reinterpret_cast<unsigned*>(&z4);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          pa[u] = pack_bf16((float)by[2 * u], (float)by[2 * u + 1]);
          pz[u] = pack_bf16((float)by[8 + 2 * u], (float)by[9 + 2 * u]);
        }
        __nv_bfloat16* dst = conv + (size_t)kv * BKD * QS + (size_t)j * QS + c * 16;
        *reinterpret_cast<uint4*>(dst) = a;
        *reinterpret_cast<uint4*>(dst + 8) = z4;
      }
      __syncthreads();
      Kt = conv;
      Vt = conv + (size_t)BKD * QS;
    }
    const int t0 = t * BKD;
    if (t0 <= whi && t0 + BKD > wlo) {  // warp-uniform: a row of this warp sees a key here
      float sc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned a[4];
        ldsm_x4(a, qs + (size_t)(warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * QS + kk * 16 +
                       (lane >> 4) * 8);
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2) {
          unsigned bb[4];
          ldsm_x4(bb, Kt + (size_t)(n2 * 16 + (lane & 7) + (lane >> 4) * 8) * QS + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          mma16816(sc[2 * n2], a, bb[0], bb[1]);
          mma16816(sc[2 * n2 + 1], a, bb[2], bb[3]);
        }
      }
      const int s0 = RING ? t0 % opt.ring : t0;
      const int d0 = t0 + 2 * tq - lo0, d1 = t0 + 2 * tq - lo1;
      // The tree variant: the words of the chunk's part of this tile, from
      // word wb on (a tile of at most 64 keys spans at most three words).
      unsigned w00 = 0u, w01 = 0u, w02 = 0u, w10 = 0u, w11 = 0u, w12 = 0u;
      int wb = 0;
      if constexpr (TREE) {
        const int rel0 = t0 - cs;
        if (rel0 + BKD > 0 && rel0 < S) {
          wb = max(rel0, 0) >> 5;
          const auto word = [&](const unsigned* row, int w) {
            return row != nullptr && w < W ? __ldg(row + w) : 0u;
          };
          w00 = word(anc0, wb), w01 = word(anc0, wb + 1), w02 = word(anc0, wb + 2);
          w10 = word(anc1, wb), w11 = word(anc1, wb + 1), w12 = word(anc1, wb + 2);
        }
      }
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = n * 8 + 2 * tq + (e & 1);
          bool seen = (unsigned)((e < 2 ? d0 : d1) + n * 8 + (e & 1)) <= (e < 2 ? span0 : span1);
          if (slot_check) {
            int slot = s0 + jj;
            if (slot >= opt.ring) slot -= opt.ring;
            seen = seen && slot < Tk;
          }
          if constexpr (TREE) {  // in the chunk (0 <= rel < S): the ancestry bit
            const int rel = t0 + jj - cs;
            if (seen && rel >= 0) {
              const int wi = (rel >> 5) - wb;
              const unsigned w = e < 2 ? (wi == 0 ? w00 : wi == 1 ? w01 : w02)
                                       : (wi == 0 ? w10 : wi == 1 ? w11 : w12);
              seen = (w >> (rel & 31)) & 1u;
            }
          }
          float s = __fmul_rn(sc[n][e], opt.scale);
          if constexpr (INT8) s = __fmul_rn(s, kst[jj]);
          if (opt.softcap > 0.f) s = __fmul_rn(tanhf(__fdiv_rn(s, opt.softcap)), opt.softcap);
          s = seen ? s : NEG_INF;
          sc[n][e] = s;
          if (e < 2) mx0 = fmaxf(mx0, s);
          else mx1 = fmaxf(mx1, s);
        }
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      // A row that sees no key of this tile: p = 0 and alpha exactly 1.
      const bool live0 = mx0 != NEG_INF, live1 = mx1 != NEG_INF;
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // exp(x - m) as 2^(x log2 e - m log2 e): one fma and the card's ex2.
      const float ml0 = __fmul_rn(mn0, LOG2E), ml1 = __fmul_rn(mn1, LOG2E);
      const float al0 = live0 ? ex2(__fmaf_rn(m0, LOG2E, -ml0)) : 1.f;
      const float al1 = live1 ? ex2(__fmaf_rn(m1, LOG2E, -ml1)) : 1.f;
      float sum0 = 0.f, sum1 = 0.f;
      unsigned pa[KT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lv = e < 2 ? live0 : live1;
          pv[e] = lv ? ex2(__fmaf_rn(sc[n][e], LOG2E, -(e < 2 ? ml0 : ml1))) : 0.f;
        }
        sum0 = __fadd_rn(__fadd_rn(sum0, pv[0]), pv[1]);
        sum1 = __fadd_rn(__fadd_rn(sum1, pv[2]), pv[3]);
        if constexpr (INT8) {  // l above took the unscaled p
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[e] = __fmul_rn(pv[e], vst[n * 8 + 2 * tq + (e & 1)]);
        }
        pa[n / 2][(n & 1) * 2] = pack_bf16(pv[0], pv[1]);
        pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
      }
      l0 = __fmaf_rn(l0, al0, quad_sum(sum0));
      l1 = __fmaf_rn(l1, al1, quad_sum(sum1));
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        acc[dn][0] = __fmul_rn(acc[dn][0], al0);
        acc[dn][1] = __fmul_rn(acc[dn][1], al0);
        acc[dn][2] = __fmul_rn(acc[dn][2], al1);
        acc[dn][3] = __fmul_rn(acc[dn][3], al1);
      }
#pragma unroll
      for (int j = 0; j < KT; ++j) {
#pragma unroll
        for (int dn2 = 0; dn2 < D / 16; ++dn2) {
          unsigned bb[4];
          ldsm_x4_t(bb, Vt + (size_t)(j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * QS +
                            dn2 * 16 + (lane >> 4) * 8);
          mma16816(acc[2 * dn2], pa[j], bb[0], bb[1]);
          mma16816(acc[2 * dn2 + 1], pa[j], bb[2], bb[3]);
        }
      }
    }
    __syncthreads();
  }

  // Row lr's output offset; two adjacent columns stored as bf16, or as f32
  // for a shard; a shard's row log-sum-exp (lse [B, H, S]).
  const auto out_row = [&](int lr) {
    const int r = r0 + lr, s = r / group, gi = r % group;
    return (((size_t)b * S + s) * H + h * group + gi) * D;
  };
  const auto store = [&](size_t off, float x0, float x1) {
    if constexpr (SHARD)
      *reinterpret_cast<float2*>(static_cast<float*>(out) + off) = make_float2(x0, x1);
    else
      *reinterpret_cast<unsigned*>(static_cast<__nv_bfloat16*>(out) + off) = pack_bf16(x0, x1);
  };
  const auto store_lse = [&](int lr, float lse) {
    const int r = r0 + lr, s = r / group, gi = r % group;
    shard.lse[((size_t)b * H + h * group + gi) * S + s] = lse;
  };
  if (nz <= 1) {  // kernel E, or D with one split: the rows are final
    const bool broken = nz == 1 && nsp > 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int lr = i ? lr1 : lr0;
      if (r0 + lr >= nrows) continue;
      const float l = i ? l1 : l0;
      const size_t o = out_row(lr);
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        float x0 = 0.f, x1 = 0.f;
        if (broken) {
          x0 = x1 = NAN;
        } else if (l > 0.f) {
          x0 = __fdiv_rn(acc[dn][2 * i], l);
          x1 = __fdiv_rn(acc[dn][2 * i + 1], l);
        }
        store(o + dn * 8 + 2 * tq, x0, x1);
      }
      if (SHARD && tq == 0)
        store_lse(lr, broken ? NAN : l > 0.f ? __fadd_rn(i ? m1 : m0, logf(l)) : NEG_INF);
    }
    return;
  }

  // Kernel D over nz > 1 splits: partials, ticket, and the last block combines.
  const int bidx = blockIdx.x * gridDim.y + blockIdx.y;
  const size_t nblk = (size_t)gridDim.x * gridDim.y;
  float* ws_ml = ws;                                  // [nblk, nz, ROWS] (m, l)
  float* ws_acc = ws + 2 * nblk * (size_t)nz * ROWS;  // [nblk, nz, ROWS, D]
  if (z < nsp) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int lr = i ? lr1 : lr0;
      if (r0 + lr >= nrows) continue;
      const size_t slot = ((size_t)bidx * nz + z) * ROWS + lr;
      if (tq == 0) *reinterpret_cast<float2*>(ws_ml + 2 * slot) = make_float2(i ? m1 : m0, i ? l1 : l0);
#pragma unroll
      for (int dn = 0; dn < DT; ++dn)
        *reinterpret_cast<float2*>(ws_acc + slot * D + dn * 8 + 2 * tq) =
            make_float2(acc[dn][2 * i], acc[dn][2 * i + 1]);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(&counters[bidx], 1u) == (unsigned)nz - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const int nuse = min(nsp, nz);
  // Each warp combines its rows: the splits' (m, l) are read across the
  // lanes, 32 at a time (one round trip), their weights w = exp(m - M) (-1
  // for a split in which the row saw nothing) go to shared memory (the
  // stage buffers, free now), and l and acc are summed in ascending split
  // order, the same arithmetic on every lane.
  float* wsh = reinterpret_cast<float*>(stages) + (size_t)warp * nz;
  for (int lr = warp; lr < ROWS && r0 + lr < nrows; lr += WARPS) {
    const size_t o = out_row(lr);
    const float* ml = ws_ml + 2 * ((size_t)bidx * nz * ROWS + lr);  // split z at + 2 z ROWS
    const float* ac = ws_acc + ((size_t)bidx * nz * ROWS + lr) * D;  // split z at + z ROWS D
    float M = NEG_INF;
    for (int z0 = 0; z0 < nuse; z0 += 32) {
      const int zz = z0 + lane;
      M = fmaxf(M, zz < nuse ? __ldcg(ml + 2 * zz * ROWS) : NEG_INF);
    }
    M = warp_max(M);
    float Lsum = 0.f;
    for (int z0 = 0; z0 < nuse; z0 += 32) {
      const int zz = z0 + lane;
      float w = -1.f, l = 0.f;
      if (zz < nuse) {
        const float2 mz = __ldcg(reinterpret_cast<const float2*>(ml + 2 * zz * ROWS));
        if (mz.x != NEG_INF) w = expf(__fsub_rn(mz.x, M)), l = mz.y;
        wsh[zz] = w;
      }
      const int n = min(32, nuse - z0);
      for (int j = 0; j < n; ++j) {
        const float wj = __shfl_sync(0xffffffffu, w, j), lj = __shfl_sync(0xffffffffu, l, j);
        if (wj >= 0.f) Lsum = __fmaf_rn(wj, lj, Lsum);
      }
    }
    __syncwarp();
    for (int c = lane * 2; c < D; c += 64) {
      float o0 = 0.f, o1 = 0.f;
#pragma unroll 8
      for (int zz = 0; zz < nuse; ++zz) {
        const float w = wsh[zz];
        const float2 a = __ldcg(reinterpret_cast<const float2*>(ac + (size_t)zz * ROWS * D + c));
        if (w >= 0.f) {
          o0 = __fmaf_rn(w, a.x, o0);
          o1 = __fmaf_rn(w, a.y, o1);
        }
      }
      float x0 = 0.f, x1 = 0.f;
      if (nsp > nz) {
        x0 = x1 = NAN;
      } else if (Lsum > 0.f) {
        x0 = __fdiv_rn(o0, Lsum);
        x1 = __fdiv_rn(o1, Lsum);
      }
      store(o + c, x0, x1);
    }
    if (SHARD && lane == 0)
      store_lse(lr, nsp > nz ? NAN : Lsum > 0.f ? __fadd_rn(M, logf(Lsum)) : NEG_INF);
    __syncwarp();  // the next row writes wsh
  }
  if (tid == 0) counters[bidx] = 0u;  // ready for the next launch on the stream
}

// The launch of attend_kernel<D, T, MAP, TREE> on grid (B * KVH, row
// blocks, max(nz, 1)).
template <int D, class T, int MAP, bool TREE>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* pos, void* out, float* ws, unsigned* counters, int B, int S, int H,
           int KVH, int Tk, long long stride_kb, long long stride_kh, long long stride_sb,
           long long stride_sh, Options opt, int nz, Pages pages, Tree tree, Shard shard,
           cudaStream_t st) {
  constexpr size_t smem = Layout<D, T>::total;
  constexpr size_t stat = ROWS * sizeof(int) + 3 * sizeof(int) + 2 * BK<D> * sizeof(int);
  // The combine keeps each warp's split weights in the stage buffers.
  if (nz > 1 && (size_t)WARPS * nz * sizeof(float) > 2 * Layout<D, T>::stage_bytes)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t shared_ok =
      allow_shared(attend_kernel<D, T, MAP, TREE>, smem, stat);
  if (shared_ok != cudaSuccess) return (int)shared_ok;
  const int nrows = S * (H / KVH);
  dim3 grid(B * KVH, (nrows + ROWS - 1) / ROWS, nz > 1 ? nz : 1);
  attend_kernel<D, T, MAP, TREE><<<grid, WARPS * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs), static_cast<const int*>(pos),
      out, ws, counters, S, H, KVH, Tk, stride_kb, stride_kh, stride_sb, stride_sh, opt, nz,
      pages, tree, shard);
  return (int)cudaGetLastError();
}

// The planes of kernels D and E (ring picked by opt.ring) or F's page pool
// (pages.table set), by head dim; TREE: D's and F's tree variant; shard:
// the operands of MAP_SHARD.
template <class T, int MAP, bool TREE = false>
int launch_map(const void* q, const void* k, const void* v, const void* ks, const void* vs,
               const void* pos, void* out, float* ws, unsigned* counters, int B, int S, int H,
               int KVH, int Tk, int D, long long stride_kb, long long stride_kh,
               long long stride_sb, long long stride_sh, Options opt, int nz, Pages pages,
               cudaStream_t st, Tree tree = Tree{nullptr, nullptr},
               Shard shard = Shard{0, nullptr}) {
  if (D == 128)
    return launch<128, T, MAP, TREE>(q, k, v, ks, vs, pos, out, ws, counters, B, S, H, KVH, Tk,
                                     stride_kb, stride_kh, stride_sb, stride_sh, opt, nz, pages,
                                     tree, shard, st);
  if (D == 64)
    return launch<64, T, MAP, TREE>(q, k, v, ks, vs, pos, out, ws, counters, B, S, H, KVH, Tk,
                                    stride_kb, stride_kh, stride_sb, stride_sh, opt, nz, pages,
                                    tree, shard, st);
  if (D == 256)
    return launch<256, T, MAP, TREE>(q, k, v, ks, vs, pos, out, ws, counters, B, S, H, KVH, Tk,
                                     stride_kb, stride_kh, stride_sb, stride_sh, opt, nz, pages,
                                     tree, shard, st);
  if (D == 96)  // Phi-3 (3072 / 32)
    return launch<96, T, MAP, TREE>(q, k, v, ks, vs, pos, out, ws, counters, B, S, H, KVH, Tk,
                                    stride_kb, stride_kh, stride_sb, stride_sh, opt, nz, pages,
                                    tree, shard, st);
  return (int)cudaErrorInvalidValue;
}

// Kernels D and E over [B, KVH, T, D] planes. Refuses a ring without a
// window or shorter than 64 slots (a tile), and an unknown head dim.
template <class T>
int launch_any(const void* q, const void* k, const void* v, const void* ks, const void* vs,
               const void* pos, void* out, float* ws, unsigned* counters, int B, int S, int H,
               int KVH, int Tk, int D, long long stride_kb, long long stride_kh,
               long long stride_sb, long long stride_sh, Options opt, int nz,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % KVH) return (int)cudaErrorInvalidValue;
  if (opt.ring > 0 && (opt.window <= 0 || opt.ring < 64)) return (int)cudaErrorInvalidValue;
  if (nz > 1 && (ws == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  const Pages none{nullptr, 0, 0};
  if (opt.ring > 0)
    return launch_map<T, MAP_RING>(q, k, v, ks, vs, pos, out, ws, counters, B, S, H, KVH, Tk, D,
                               stride_kb, stride_kh, stride_sb, stride_sh, opt, nz, none, st);
  return launch_map<T, MAP_PLANE>(q, k, v, ks, vs, pos, out, ws, counters, B, S, H, KVH, Tk, D,
                              stride_kb, stride_kh, stride_sb, stride_sh, opt, nz, none, st);
}

// Kernel F over [N, KVH, P, D] pools (unit-stride [P, D] pages, head stride
// P * D, page stride stride_page; int8 scale pools [N, KVH, P] with head
// stride P and page stride stride_spage) through table [B, M]. Refuses a
// ring, a page size that is not a power of two, and an unknown head dim.
template <class T>
int launch_paged(const void* q, const void* k_pool, const void* v_pool, const void* ks_pool,
                 const void* vs_pool, const void* table, const void* pos, void* out, float* ws,
                 unsigned* counters, int B, int S, int H, int KVH, int M, int P, int D,
                 long long stride_page, long long stride_spage, Options opt, int nz,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % KVH || opt.ring != 0 || P < 1 || (P & (P - 1)) || M < 1)
    return (int)cudaErrorInvalidValue;
  if (nz < 1 || (nz > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Pages pages{static_cast<const int*>(table), M, __builtin_ctz((unsigned)P)};
  return launch_map<T, MAP_PAGED>(q, k_pool, v_pool, ks_pool, vs_pool, pos, out, ws, counters, B, S,
                              H, KVH, M * P, D, stride_page, (long long)P * D, stride_spage, P,
                              opt, nz, pages, st);
}

// D's tree variant over [B, KVH, T, D] planes: tree.bits [S, ceil(S / 32)]
// and tree.start [B] (attend_kernel's TREE). Refuses a window, a ring and
// an unknown head dim.
template <class T>
int launch_tree(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                void* out, float* ws, unsigned* counters, int B, int S, int H, int KVH, int Tk,
                int D, long long stride_kb, long long stride_kh, long long stride_sb,
                long long stride_sh, Options opt, int nz, Tree tree, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % KVH || S < 1 || opt.window != 0 || opt.ring != 0 || nz < 1 ||
      tree.bits == nullptr || tree.start == nullptr)
    return (int)cudaErrorInvalidValue;
  if (nz > 1 && (ws == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  const Pages none{nullptr, 0, 0};
  return launch_map<T, MAP_PLANE, true>(q, k, v, ks, vs, nullptr, out, ws, counters, B, S, H,
                                        KVH, Tk, D, stride_kb, stride_kh, stride_sb, stride_sh,
                                        opt, nz, none, st, tree);
}

// F's tree variant over [N, KVH, P, D] pools through table [B, M]: the
// arguments of launch_paged, with tree.bits [S, ceil(S / 32)] and
// tree.start [B] (slots, through the table) for the positions. Refuses what
// launch_paged and launch_tree refuse.
template <class T>
int launch_paged_tree(const void* q, const void* k_pool, const void* v_pool, const void* ks_pool,
                      const void* vs_pool, const void* table, void* out, float* ws,
                      unsigned* counters, int B, int S, int H, int KVH, int M, int P, int D,
                      long long stride_page, long long stride_spage, Options opt, int nz,
                      Tree tree, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % KVH || opt.ring != 0 || opt.window != 0 || P < 1 || (P & (P - 1)) || M < 1 || S < 1 ||
      tree.bits == nullptr || tree.start == nullptr)
    return (int)cudaErrorInvalidValue;
  if (nz < 1 || (nz > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Pages pages{static_cast<const int*>(table), M, __builtin_ctz((unsigned)P)};
  return launch_map<T, MAP_PAGED, true>(q, k_pool, v_pool, ks_pool, vs_pool, nullptr, out, ws,
                                        counters, B, S, H, KVH, M * P, D, stride_page,
                                        (long long)P * D, stride_spage, P, opt, nz, pages, st,
                                        tree);
}

// D's and E's shard variant (MAP_SHARD) over [B, KVH, T, D] planes that
// hold positions [t0, t0 + T): out f32 [B, S, H, D] and lse f32 [B, H, S].
// nz = 0: E's walk (every key in one block); nz >= 1: D's split over T.
// The chain mask with opt's scale, softcap and window (compared with the
// keys' absolute positions t0 + slot; no ring); TREE: D's tree variant
// over the slice, tree.start[b] the chunk's first absolute position, no
// window. Refuses t0 < 0, a missing lse, a ring and an unknown head dim.
template <class T, bool TREE = false>
int launch_shard(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                 const void* pos, void* out, float* lse, float* ws, unsigned* counters, int B,
                 int S, int H, int KVH, int Tk, int D, long long stride_kb, long long stride_kh,
                 long long stride_sb, long long stride_sh, Options opt, int t0, int nz,
                 void* stream, Tree tree = Tree{nullptr, nullptr}) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % KVH || t0 < 0 || lse == nullptr || nz < 0 || opt.ring != 0 || opt.window < 0)
    return (int)cudaErrorInvalidValue;
  if (TREE && (S < 1 || opt.window != 0 || nz < 1 || tree.bits == nullptr ||
               tree.start == nullptr))
    return (int)cudaErrorInvalidValue;
  if (nz > 1 && (ws == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  const Pages none{nullptr, 0, 0};
  return launch_map<T, MAP_SHARD, TREE>(q, k, v, ks, vs, pos, out, ws, counters, B, S, H, KVH,
                                        Tk, D, stride_kb, stride_kh, stride_sb, stride_sh, opt,
                                        nz, none, st, tree, Shard{t0, lse});
}

}  // namespace
}  // namespace mma
