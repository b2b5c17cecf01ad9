// Decode main loop of kernels A (quant_matmul_int4.cu) and B
// (quant_matmul_int8.cu): every call of M < 64 rows (decode and verify
// steps, M = 1 to 63), on tensor cores, one launch a call:
//
//   y[M, N] = (x[M, K] @ w[K, N]) * scale[N]
//
// with bf16 x, int4 (v2 split-K halves: byte [i, n] holds w[i, n] + 8 in its
// low nibble and w[i + K/2, n] in its high nibble) or int8 weights, f32
// sums, the scale in f32 and one rounding to bf16. It reads the bytes the
// prefill path (qmm_mma.cuh) reads, in their layout: a layer's view of the
// stacked [L, K/2, N] or [L, K, N] buffer, no copy, nothing repacked.
//
// Replaces: llm_inference_lab_tpu/ops/pallas/quant_matmul.py:194,210
// quant_matmul_pallas at decode M (_kernel_int4 :76, _kernel_int8 :58),
// which runs all Mp = round_up(M, 16) rows in one block on the MXU and
// streams the weights once (:143-148).
//
// What bounds it on the H100: the weight bytes (K N / 2 at int4, K N at
// int8) read once at 3.35 TB/s, from 0.63 us (the 1B's o projection at
// int4) to 39 us (Mistral-7B's gate_up at int8); x, the scale and the
// output are under 2% of them at M = 40. Below a few MB a call's floor is
// the launch and the DRAM latency of its first tiles (a few us), not the
// bytes. The products, 2 M K N, are far below the tensor cores' rate at
// every M here, but not below the CUDA cores' f32 rate at M = 40.
//
// Design, point by point:
//  * Every row of x in one block: a block owns BN = 256 output columns and
//    a range of K, and all M rows (8 NT of them, NT = ceil(M / 8) a template
//    argument); nothing in the grid runs over M, so every weight byte is
//    read once a call whatever M. 256 columns, not 128: each block reads
//    its rows of x from L2, M K 2 bytes a column block, which at M = 40 is
//    0.63x the int4 weight bytes at 256 columns (4 M / BN) but 1.25x at 128,
//    as much L2 traffic again as the weights' own; int8 halves both.
//  * Swap-AB on mma.sync.m16n8k16 (bf16 in, f32 sums): the weights are the
//    16-row A operand (16 output columns by 16 k), x^T the 8-column B
//    operand (16 k by 8 tokens), one instruction per 8-token tile, so a
//    token's arithmetic is the same instruction on the same operands
//    whatever the other tiles hold. 16 warps: warp w owns 32 of the
//    block's columns (two 16-column A tiles) and one half of every k-tile
//    (rows 32 (w / 8) .. + 31 of its 64); at the end the second half's
//    sums reach the first half's threads through shared memory and are
//    added in that fixed order. The k order inside an instruction is the
//    block's own: a thread's register pairs are (k, k + 1) and (k + 2,
//    k + 3) of k = k0 + 4 tq, so its two x registers are one 8-byte load
//    from x's natural layout and its weights four 4-byte loads of
//    consecutive rows. The weights become bf16 in registers, exactly: an
//    int4 nibble u + 8 (0..15) as the bf16 bits 0x43uu (128 + u) minus
//    136; an int8 byte through the f32 2^23 + 128 + b, as qmm_mma.cuh's
//    conversions. At int4 the low nibbles of a k-tile's packed rows are
//    k-values i.., the high nibbles K/2 + i..: one load feeds two
//    instructions, against x's two slabs.
//  * Bytes in flight: a cp.async ring of STAGES = 4 k-tiles (64 weight
//    rows by 256 columns, 16 KB, and the x tile), filled 3 k-tiles ahead:
//    48 KB of weights in flight a block, one block an SM (the plan keeps
//    a grid near 132 blocks). Both tiles are swizzled (32-byte granules XOR
//    the row), so the fragment loads hit 32 distinct banks. The weights
//    are copied without an L2 evict-first hint: with one (cp.async
//    .L2::cache_hint under a createpolicy policy) this kernel stopped with
//    an illegal instruction on the H100, though the same copy ran alone.
//  * One launch: K is split over grid.y by a plan that depends on (K, N,
//    bits) alone (ops/quant_matmul.py decode_plan: about 132 blocks, at
//    least 96, whole k-tiles, k-tile z nk / ks to (z + 1) nk / ks).
//    Unsplit, a block writes scale * sum as bf16 itself. Split, each block
//    writes its f32 sums to ws [ks, M, N], takes a ticket on its column
//    tile, and the last block to take one adds the splits in ascending
//    split order (its own read back at its place, not first), applies the
//    scale, writes bf16 and resets the ticket for the next launch on the
//    stream: kernel D's combine (attn_mma.cuh), with D's ticket counters.
//  * A row's bits are independent of M: every output element is the f32
//    chain of the same mma.sync instructions over the k-tiles in ascending
//    order (at int4 the low then the high nibbles of each 16 packed rows),
//    the two halves' sums added in one order, the K split and its combine
//    fixed by (K, N, bits). At M = 1, 2, 5, 8, 16, 40 and 63 a row has the
//    same bits (chip_smoke.py's row_stability asserts it). The prefill
//    path sums in another order (64-value k-tiles on wgmma), so a row may
//    differ between the two paths.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_mma.cuh"

namespace qmm {
namespace {

namespace dec {
constexpr int BN = 256;      // output columns a block
constexpr int KT = 64;       // weight rows a k-tile (packed rows at int4)
constexpr int WARPS = 16;    // 8 column slices of 32 x 2 halves of each k-tile
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 4;
constexpr int W_BYTES = KT * BN;  // raw weight bytes a stage: 16 KB

// x bytes a token a k-tile: int4 two slabs (k-values i.. and K/2 + i..) of
// KT values, int8 one of KT values.
template <int BITS>
__host__ __device__ constexpr int xrow() { return BITS == 4 ? 4 * KT : 2 * KT; }

template <int BITS, int NT>
struct Layout {
  static constexpr int x_bytes = 8 * NT * xrow<BITS>();
  static constexpr int stage_bytes = W_BYTES + x_bytes;
  static constexpr size_t total = (size_t)STAGES * stage_bytes + 128;
};

// Byte offset of byte b of 32-byte granule gr of weight row r: granules
// XOR (r / 4) % 4, so the rows 4 tq + j that one load instruction reads
// (tq = 0..3) sit in four distinct 32-byte bank groups.
__device__ __forceinline__ int w_at(int r, int gr, int b) {
  return r * BN + ((gr ^ ((r >> 2) & 3)) << 5) + b;
}

// Byte offset of byte b of granule gr of token t's x row (256 bytes at
// int4, 128 at int8): granules XOR t % 4, so the 4 tokens of a half warp's
// 8-byte loads sit in four distinct bank groups.
template <int BITS>
__device__ __forceinline__ int x_at(int t, int gr, int b) {
  return t * xrow<BITS>() + ((gr ^ (t & 3)) << 5) + b;
}

// c += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), f32 sums.
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte B of packed rows r (v0) and r + 1 (v1) -> the bf16x2 words (low
// half row r) of their low nibbles, u - 8, and of their high nibbles
// (two's complement, biased by ^ 8): 0x43uu is 128 + u, minus 136, exact.
template <int B>
__device__ __forceinline__ void pair_int4(unsigned v0, unsigned v1, unsigned& lo, unsigned& hi) {
  constexpr unsigned sel = B | (B << 4) | ((B + 4) << 8) | ((B + 4) << 12);
  const unsigned t = __byte_perm(v0, v1, sel);  // bytes v0.B, v0.B, v1.B, v1.B
  unsigned a = (t & 0x000F000Fu) | 0x43004300u;
  unsigned b = ((t >> 4) & 0x000F000Fu) ^ 0x43084308u;
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  __nv_bfloat162 fa = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a), bias);
  __nv_bfloat162 fb = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&b), bias);
  lo = *reinterpret_cast<unsigned*>(&fa);
  hi = *reinterpret_cast<unsigned*>(&fb);
}

// Byte B of rows r (u0) and r + 1 (u1), each word already ^ 0x80808080 (b +
// 128) -> one bf16x2 word (low half row r): 2^23 + 128 + b minus 2^23 +
// 128 in f32, exact, then bf16, exact.
template <int B>
__device__ __forceinline__ unsigned pair_int8(unsigned u0, unsigned u1) {
  constexpr float base = 8388736.f;  // 2^23 + 128
  const float f0 = __int_as_float(__byte_perm(u0, 0x4B000000u, 0x7650 | B)) - base;
  const float f1 = __int_as_float(__byte_perm(u1, 0x4B000000u, 0x7650 | B)) - base;
  __nv_bfloat162 p = __floats2bfloat162_rn(f0, f1);
  return *reinterpret_cast<unsigned*>(&p);
}

// x bf16 [M, K]; w int8 [K/2, N] (BITS 4) or [K, N] (BITS 8); scale f32
// [N]; out bf16 [M, N]. Grid (N / BN, ks): block (c, z) owns columns
// [c BN, c BN + BN) and k-tiles [z nk / ks, (z + 1) nk / ks). ks > 1: ws
// f32 [ks, M, N] and counters[c] (zero on entry, zero again on exit).
template <int BITS, int NT>
__global__ void __launch_bounds__(THREADS, 1)
decode_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
              float* __restrict__ ws, unsigned* __restrict__ counters, int M, int K, int N,
              int ks) {
  using L = Layout<BITS, NT>;
  constexpr int XR = xrow<BITS>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (((smem_u32(smem_raw) + 127u) & ~127u) - smem_u32(smem_raw));
  __shared__ int last_s;

  const int tid = threadIdx.x, lane = tid & 31;
  const int slice = (tid >> 5) & 7, kh = tid >> 8;  // columns 32 slice.., k-tile half kh
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * BN, z = blockIdx.y;
  const int nk = (BITS == 4 ? K / 2 : K) / KT;
  const int kt0 = (int)((long long)z * nk / ks), kt1 = (int)((long long)(z + 1) * nk / ks);
  const int n = kt1 - kt0;

  // Stage st <- k-tile kt: KT weight rows of the block's columns, and the
  // x values they multiply for all 8 NT tokens (tokens past M zeros).
  const auto load = [&](int kt, int st) {
    unsigned char* wsm = smem + st * L::stage_bytes;
    unsigned char* xsm = wsm + W_BYTES;
#pragma unroll
    for (int u = 0; u < KT * BN / 16 / THREADS; ++u) {
      const int e = tid + u * THREADS, r = e >> 4, c = e & 15;
      cp16(wsm + w_at(r, c >> 1, (c & 1) << 4), w + (size_t)(kt * KT + r) * N + n0 + c * 16, 16);
    }
    for (int e = tid; e < 8 * NT * (XR / 16); e += THREADS) {
      const int t = e / (XR / 16), c = e % (XR / 16), gr = c >> 1;
      const int col = (BITS == 4 ? (gr >> 2) * (K / 2) + (gr & 3) * 16 : gr * 16) + kt * KT +
                      (c & 1) * 8;
      const bool live = t < M;
      cp16(xsm + x_at<BITS>(t, gr, (c & 1) << 4), x + (live ? (size_t)t * K + col : 0),
           live ? 16 : 0);
    }
  };

  float acc[NT][2][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][m][i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(kt0 + s, s);
    cp_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_wait<STAGES - 2>();  // this thread's copies of k-tile i have landed
    __syncthreads();        // everyone's, and the slot of k-tile i - 1 is free
    if (i + STAGES - 1 < n) load(kt0 + i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_commit();
    const unsigned char* wsm = smem + (i % STAGES) * L::stage_bytes;
    const unsigned char* xsm = wsm + W_BYTES;
    // This half's two steps of 16 weight rows, s = 2 kh, 2 kh + 1; thread
    // (g, tq) reads rows 16 s + 4 tq + j, j = 0..3, at columns 32 slice +
    // 4 g .. + 3. A tile m: A row g is column 4 g + 2 m, row g + 8 column
    // 4 g + 2 m + 1; register pairs (rows 4 tq, 4 tq + 1) and (4 tq + 2,
    // 4 tq + 3), against x's 8-byte load at k 16 s + 4 tq of token 8 t + g.
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2) {
      const int s = 2 * kh + s2;
      unsigned v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = *reinterpret_cast<const unsigned*>(wsm + w_at(16 * s + 4 * tq + j, slice, 4 * g));
      if constexpr (BITS == 4) {
        unsigned lo[2][4], hi[2][4];
        pair_int4<0>(v[0], v[1], lo[0][0], hi[0][0]);
        pair_int4<1>(v[0], v[1], lo[0][1], hi[0][1]);
        pair_int4<0>(v[2], v[3], lo[0][2], hi[0][2]);
        pair_int4<1>(v[2], v[3], lo[0][3], hi[0][3]);
        pair_int4<2>(v[0], v[1], lo[1][0], hi[1][0]);
        pair_int4<3>(v[0], v[1], lo[1][1], hi[1][1]);
        pair_int4<2>(v[2], v[3], lo[1][2], hi[1][2]);
        pair_int4<3>(v[2], v[3], lo[1][3], hi[1][3]);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const uint2 xl = *reinterpret_cast<const uint2*>(xsm + x_at<4>(8 * t + g, s, 8 * tq));
          const uint2 xh =
              *reinterpret_cast<const uint2*>(xsm + x_at<4>(8 * t + g, 4 + s, 8 * tq));
          mma16816(acc[t][0], lo[0], xl.x, xl.y);
          mma16816(acc[t][1], lo[1], xl.x, xl.y);
          mma16816(acc[t][0], hi[0], xh.x, xh.y);
          mma16816(acc[t][1], hi[1], xh.x, xh.y);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] ^= 0x80808080u;
        unsigned a[2][4];
        a[0][0] = pair_int8<0>(v[0], v[1]);
        a[0][1] = pair_int8<1>(v[0], v[1]);
        a[0][2] = pair_int8<0>(v[2], v[3]);
        a[0][3] = pair_int8<1>(v[2], v[3]);
        a[1][0] = pair_int8<2>(v[0], v[1]);
        a[1][1] = pair_int8<3>(v[0], v[1]);
        a[1][2] = pair_int8<2>(v[2], v[3]);
        a[1][3] = pair_int8<3>(v[2], v[3]);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const uint2 xk = *reinterpret_cast<const uint2*>(xsm + x_at<8>(8 * t + g, s, 8 * tq));
          mma16816(acc[t][0], a[0], xk.x, xk.y);
          mma16816(acc[t][1], a[1], xk.x, xk.y);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // every warp is done with the ring: it holds the exchange now

  // The second half's sums go through shared memory to the first half's
  // threads, which add them to their own (first half, then second: a fixed
  // order) and write. acc[t][m] holds columns 4 g + 2 m (elements 0, 1) and
  // 4 g + 2 m + 1 (2, 3) of tokens 8 t + 2 tq (0, 2) and + 1 (1, 3).
  float* xch = reinterpret_cast<float*>(smem);
  if (kh == 1) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) xch[((t * 2 + m) * 4 + i) * 256 + (tid & 255)] = acc[t][m][i];
  }
  __syncthreads();
  if (kh == 0) {
    const int col = n0 + slice * 32 + 4 * g;
    const float4 sc = *reinterpret_cast<const float4*>(scale + col);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[t][m][i] += xch[((t * 2 + m) * 4 + i) * 256 + tid];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 8 * t + 2 * tq + h;
        if (row >= M) continue;
        const float4 v =
            make_float4(acc[t][0][h], acc[t][0][2 + h], acc[t][1][h], acc[t][1][2 + h]);
        if (ks == 1) {
          __nv_bfloat162 p0 = __floats2bfloat162_rn(v.x * sc.x, v.y * sc.y);
          __nv_bfloat162 p1 = __floats2bfloat162_rn(v.z * sc.z, v.w * sc.w);
          uint2 o;
          o.x = *reinterpret_cast<unsigned*>(&p0);
          o.y = *reinterpret_cast<unsigned*>(&p1);
          *reinterpret_cast<uint2*>(out + (size_t)row * N + col) = o;
        } else {
          *reinterpret_cast<float4*>(ws + ((size_t)z * M + row) * N + col) = v;
        }
      }
    }
  }
  if (ks == 1) return;

  // Split: a ticket on the column tile; the last block adds the splits.
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(&counters[blockIdx.x], 1u) == (unsigned)ks - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // 64 threads a token, 4 columns each; tokens tid / 64, + 8, ...
  const int c4 = n0 + 4 * (tid & 63);
  const float4 s4 = *reinterpret_cast<const float4*>(scale + c4);
  const size_t split = (size_t)M * N;
  for (int row = tid >> 6; row < M; row += THREADS / 64) {
    const float* p = ws + (size_t)row * N + c4;
    float4 a = __ldcg(reinterpret_cast<const float4*>(p));
#pragma unroll 8
    for (int zz = 1; zz < ks; ++zz) {
      const float4 b = __ldcg(reinterpret_cast<const float4*>(p + zz * split));
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    __nv_bfloat162 p0 = __floats2bfloat162_rn(a.x * s4.x, a.y * s4.y);
    __nv_bfloat162 p1 = __floats2bfloat162_rn(a.z * s4.z, a.w * s4.w);
    uint2 o;
    o.x = *reinterpret_cast<unsigned*>(&p0);
    o.y = *reinterpret_cast<unsigned*>(&p1);
    *reinterpret_cast<uint2*>(out + (size_t)row * N + c4) = o;
  }
  if (tid == 0) counters[blockIdx.x] = 0u;  // ready for the next launch on the stream
}

template <int BITS, int NT>
int launch_nt(const void* x, const void* w, const void* scale, void* ws, void* counters,
              void* out, int M, int K, int N, int ks, cudaStream_t st) {
  constexpr size_t smem = Layout<BITS, NT>::total;
  static const cudaError_t shared_ok = cudaFuncSetAttribute(
      decode_kernel<BITS, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (shared_ok != cudaSuccess) return (int)shared_ok;
  decode_kernel<BITS, NT><<<dim3(N / BN, ks), THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), static_cast<unsigned*>(counters), M, K, N, ks);
  return (int)cudaGetLastError();
}
}  // namespace dec

// The C entries' body for M < 64 rows. Refuses M outside 1..64, N % 256,
// a K that is not whole k-tiles, a split outside 1..k-tiles, and a split
// without its workspace or counters.
template <int BITS>
int launch_decode(const void* x, const void* w, const void* scale, void* ws, void* counters,
                  void* out, int M, int K, int N, int ks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = BITS == 4 ? K / 2 : K;
  if (M < 1 || M > 64 || N % dec::BN || K % 64 || rows % dec::KT || ks < 1 ||
      ks > rows / dec::KT || (ks > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  switch ((M + 7) / 8) {
    case 1: return dec::launch_nt<BITS, 1>(x, w, scale, ws, counters, out, M, K, N, ks, st);
    case 2: return dec::launch_nt<BITS, 2>(x, w, scale, ws, counters, out, M, K, N, ks, st);
    case 3: return dec::launch_nt<BITS, 3>(x, w, scale, ws, counters, out, M, K, N, ks, st);
    case 4: return dec::launch_nt<BITS, 4>(x, w, scale, ws, counters, out, M, K, N, ks, st);
    case 5: return dec::launch_nt<BITS, 5>(x, w, scale, ws, counters, out, M, K, N, ks, st);
    case 6: return dec::launch_nt<BITS, 6>(x, w, scale, ws, counters, out, M, K, N, ks, st);
    case 7: return dec::launch_nt<BITS, 7>(x, w, scale, ws, counters, out, M, K, N, ks, st);
    default: return dec::launch_nt<BITS, 8>(x, w, scale, ws, counters, out, M, K, N, ks, st);
  }
}

}  // namespace
}  // namespace qmm
