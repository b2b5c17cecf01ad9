// Tensor-core main loop of kernels A (quant_matmul_int4.cu) and B
// (quant_matmul_int8.cu) for M >= 64 rows (prefill, admission waves):
//
//   y[M, N] = (x[M, K] @ w[K, N]) * scale[N]
//
// with bf16 x, int4 (v2 split-K halves) or int8 weights, f32 accumulation,
// the scale in f32 and one rounding to bf16, read from the same bytes as
// the decode body (csrc/qmm_decode.cuh), which takes M < 64.
//
// Replaces, for prefill shapes: llm_inference_lab_tpu/ops/pallas/
// quant_matmul.py quant_matmul_pallas (_kernel_int4, _kernel_int8), whose
// dispatcher sends M > 32 to quant_matmul_xla (:299-306): the same function.
//
// What bounds it on the H100: at M >= 64 rows the operations, 2 M K N at
// the bf16 tensor-core rate (989 TFLOP/s dense), above the weight bytes
// (K N / 2 or K N) once M passes a few hundred. So the weights are
// converted to bf16 in shared memory, one k-tile at a time (never in
// device memory, as the library call's dequantization does), and the
// product runs on Hopper's warpgroup MMA (wgmma, bf16 in, f32 accumulate).
//
// Design (simple first; a warp-specialized producer with TMA is later work):
//  * A block owns 128 x 128 outputs: two warpgroups, each 64 rows by one
//    wgmma.m64n128k16 per 16 k-values. It walks K in k-tiles of 64 values.
//    int4: a k-tile is 32 packed weight rows i0..i0+31, whose low nibbles
//    are k-values i0.. and high nibbles k-values K/2 + i0..; its x tile is
//    the two slabs x[:, i0:i0+32] and x[:, K/2+i0:K/2+i0+32]. int8: 64
//    weight rows and x[:, k0:k0+64].
//  * A cp.async ring (4 slots for int4, 3 for int8: two blocks an SM)
//    brings the x tile, laid out as wgmma's K-major operand with the
//    128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)), and the raw
//    weight bytes. Each k-tile's weights are converted into one of two bf16
//    tiles in wgmma's MN-major layout (the same swizzle, 64 columns an 8 KB
//    block) while the tensor cores still run the previous k-tile. The
//    conversion is exact: an int4 nibble + 8 (0..15) becomes the bf16
//    128 + u by a byte permute and 136 is subtracted in bf16; an int8 byte
//    + 128 becomes the f32 2^23 + u, minus 2^23 + 128, then bf16.
//  * Epilogue: the f32 sum times the f32 scale, one bf16 store. No
//    workspace unless the K split is on. OutT float (kernel A's f32
//    instantiation, the EmbedQuant4 tied head at N = V: JAX rounds those
//    logits to bf16 through dense, the port keeps them f32; and A's and
//    B's row-parallel partial sums under the model axis) stores the same
//    product unrounded; the loop is the same, so a bf16 output keeps its
//    bits.
//  * Bits: every output is the tensor cores' f32 chain over the k-tiles in
//    ascending order, 16 k-values a wgmma, and its value for one element
//    depends only on that element's row of x and column of w (a block 256
//    columns wide gave the same bits on the card). So the grid and M never
//    enter a row's arithmetic: a row has the same bits at every M of this
//    path. The only other input is the K split (ksplit blocks along
//    grid.z, each a contiguous range of k-tiles, summed in ascending order
//    by a second pass), which the wrapper picks from (K, N) and the weight
//    type alone (ops/quant_matmul.py mma_plan).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage: each kernel library has its own CUDA runtime (see
// attn_mma.cuh).
namespace qmm {
namespace {

constexpr int BM = 128;  // rows a block: one 64-row wgmma tile a warpgroup
constexpr int BN = 128;  // output columns a block
constexpr int BKV = 64;  // k-values a k-tile
constexpr int THREADS = 256;  // two warpgroups

// Dynamic shared memory: a cp.async ring of STAGES (x tile, raw weight
// bytes) and two bf16 weight tiles, from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 8 rows of 128 bytes).
template <int BITS>
struct Layout {
  static constexpr int STAGES = BITS == 4 ? 4 : 3;  // two blocks an SM either way
  static constexpr int WROWS = BITS == 4 ? BKV / 2 : BKV;  // weight byte rows a k-tile
  static constexpr int x_bytes = BM * BKV * 2;              // [128 rows][128 bytes]
  static constexpr int w_bytes = WROWS * BN;
  static constexpr int stage_bytes = x_bytes + w_bytes;     // a multiple of 1024
  static constexpr int wt_bytes = BKV * BN * 2;  // two [64 k][64 n] blocks of 8 KB
  static constexpr size_t total = (size_t)STAGES * stage_bytes + 2 * wt_bytes + 1024;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// d += a (64 x 16 bf16, K-major in shared memory) * b (16 x 128 bf16,
// MN-major in shared memory), f32 accumulate, over one warpgroup.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to the tensor cores' async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma shared-memory descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (all in 16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// 16 bytes global -> shared; n = 0 reads nothing and writes zeros.
__device__ __forceinline__ void cp16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The output's one rounding, shared by both bodies: f32 values of one row
// at adjacent columns stored as bf16, or as they are for OutT float.
__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, float a, float b, float c, float d) {
  __nv_bfloat162 p0 = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 p1 = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<unsigned*>(&p0);
  v.y = *reinterpret_cast<unsigned*>(&p1);
  *reinterpret_cast<uint2*>(o) = v;
}
__device__ __forceinline__ void store4(float* o, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(o) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store1(__nv_bfloat16* o, float a) { *o = __float2bfloat16(a); }
__device__ __forceinline__ void store1(float* o, float a) { *o = a; }

// Byte offset of 16-byte chunk c of row r in a tile of ROW_BYTES rows: the
// chunk index XOR r % 8, the 128-byte swizzle wgmma's descriptors name
// (with the tile 1024-byte aligned).
template <int ROW_BYTES>
__device__ __forceinline__ int swz(int r, int c) {
  return r * ROW_BYTES + ((c ^ (r & 7)) << 4);
}

// Four biased nibbles u (bytes of v, 0..15) -> two bf16x2 words u - 8:
// bf16 bits 0x43uu are 128 + u, exact; minus 136 in bf16, exact.
__device__ __forceinline__ void nibbles_to_bf16(unsigned v, unsigned& lo, unsigned& hi) {
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  unsigned a = __byte_perm(v, 0x43u, 0x4140), b = __byte_perm(v, 0x43u, 0x4342);
  __nv_bfloat162 fa = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a), bias);
  __nv_bfloat162 fb = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&b), bias);
  lo = *reinterpret_cast<unsigned*>(&fa);
  hi = *reinterpret_cast<unsigned*>(&fb);
}

// Four int8 bytes of v -> two bf16x2 words: byte ^ 0x80 = b + 128 in the
// mantissa of 2^23, minus 2^23 + 128 in f32 (exact), then bf16 (exact).
__device__ __forceinline__ void bytes_to_bf16(unsigned v, unsigned& lo, unsigned& hi) {
  const unsigned u = v ^ 0x80808080u;
  const float base = 8388736.f;  // 2^23 + 128
  const float f0 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - base;
  const float f1 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - base;
  const float f2 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - base;
  const float f3 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - base;
  __nv_bfloat162 a = __floats2bfloat162_rn(f0, f1), b = __floats2bfloat162_rn(f2, f3);
  lo = *reinterpret_cast<unsigned*>(&a);
  hi = *reinterpret_cast<unsigned*>(&b);
}

// x bf16 [M, K]; w int8 [K/2, N] (BITS 4) or [K, N] (BITS 8); scale f32
// [N]; out OutT (bf16, or f32 for A's head instantiation) [M, N]. Grid
// (ceil(M / BM), ceil(N / BN), ksplit); with N % 128 == 64 the
// last column tile loads zeros for its 64 columns past N and stores nothing
// there (an element's value depends only on its row and column, so the
// live columns keep their bits). Block z takes k-tiles
// [z * nkz, (z + 1) * nkz). ksplit = 1: out bf16 [M, N] = sum * scale;
// ksplit > 1: ws f32 [ksplit, M, N] partial sums (finish_kernel adds them).
template <int BITS, typename OutT>
__global__ void __launch_bounds__(THREADS, 2)
mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ scale, OutT* __restrict__ out,
           float* __restrict__ ws, int M, int K, int N, int nkz) {
  using L = Layout<BITS>;
  constexpr int CPR = BN / 16;  // 16-byte chunks a raw weight row
  constexpr int S = L::STAGES;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) - smem_u32(smem_raw));
  unsigned char* wts = smem + S * L::stage_bytes;  // 2 x bf16 [2 halves][64 k][64 n], swizzled

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;  // warpgroup: rows [64 wg, 64 wg + 64) of the block
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, z = blockIdx.z;
  const int kt0 = z * nkz;

  // Stage st <- k-tile kt: the x tile (rows past M zeros) and the raw
  // weight bytes.
  const auto load = [&](int kt, int st) {
    unsigned char* xs = smem + st * L::stage_bytes;
    unsigned char* wr = xs + L::x_bytes;
    for (int e = tid; e < BM * 8; e += THREADS) {
      const int r = e >> 3, c = e & 7;
      int col;
      if constexpr (BITS == 4) col = (c < 4 ? kt * 32 : K / 2 + kt * 32 - 32) + c * 8;
      else col = kt * BKV + c * 8;
      const bool live = m0 + r < M;
      const __nv_bfloat16* src = x + (live ? (size_t)(m0 + r) * K + col : 0);
      cp16(xs + swz<128>(r, c), src, live ? 16 : 0);
    }
    for (int e = tid; e < L::WROWS * CPR; e += THREADS) {
      const int r = e / CPR, c = e % CPR;
      const bool live = n0 + c * 16 < N;  // N % 64 == 0: a 16-column chunk is all in or out
      cp16(wr + r * BN + c * 16, w + (live ? (size_t)(kt * L::WROWS + r) * N + n0 + c * 16 : 0),
           live ? 16 : 0);
    }
  };

  // Byte offset of the 8 n-values [8 c, 8 c + 8) of k-row k in wt: the
  // wgmma MN-major layout with the 128-byte swizzle, columns 0..63 in the
  // first 8 KB half and 64..127 in the second.
  const auto wt_at = [](int k, int c) { return (c >> 3) * 8192 + swz<128>(k, c & 7); };

  // The raw weights of stage st -> the bf16 tile wt.
  const auto convert = [&](int st, unsigned char* wt) {
    const unsigned char* wr = smem + st * L::stage_bytes + L::x_bytes;
    for (int e = tid; e < L::WROWS * CPR; e += THREADS) {
      const int r = e / CPR, c = e % CPR;
      const uint4 raw = *reinterpret_cast<const uint4*>(wr + r * BN + c * 16);
      const unsigned v[4] = {raw.x, raw.y, raw.z, raw.w};
      uint4 a0, a1;  // k-row r (low nibbles, or the int8 row): n 16c..16c+15
      unsigned* pa = reinterpret_cast<unsigned*>(&a0);
      unsigned* pb = reinterpret_cast<unsigned*>(&a1);
      if constexpr (BITS == 4) {
        uint4 h0, h1;  // k-row r + 32: the high nibbles
        unsigned* ph = reinterpret_cast<unsigned*>(&h0);
        unsigned* pj = reinterpret_cast<unsigned*>(&h1);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          unsigned* lo = u < 2 ? pa + 2 * u : pb + 2 * (u - 2);
          unsigned* hi = u < 2 ? ph + 2 * u : pj + 2 * (u - 2);
          nibbles_to_bf16(v[u] & 0x0F0F0F0Fu, lo[0], lo[1]);
          nibbles_to_bf16(((v[u] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, hi[0], hi[1]);
        }
        *reinterpret_cast<uint4*>(wt + wt_at(r + 32, 2 * c)) = h0;
        *reinterpret_cast<uint4*>(wt + wt_at(r + 32, 2 * c + 1)) = h1;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          unsigned* lo = u < 2 ? pa + 2 * u : pb + 2 * (u - 2);
          bytes_to_bf16(v[u], lo[0], lo[1]);
        }
      }
      *reinterpret_cast<uint4*>(wt + wt_at(r, 2 * c)) = a0;
      *reinterpret_cast<uint4*>(wt + wt_at(r, 2 * c + 1)) = a1;
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nkz) load(kt0 + s, s);
    cp_commit();
  }
  // k-tile t: its weights are converted into wt[t % 2] while the tensor
  // cores still run k-tile t - 1 (on wt[(t - 1) % 2]); then, once every
  // warpgroup's k-tile t - 1 is done, k-tile t's products are issued and
  // the ring slot k-tile t - 1 held is refilled.
  for (int t = 0; t < nkz; ++t) {
    unsigned char* wt = wts + (t & 1) * L::wt_bytes;
    cp_wait<S - 2>();  // this thread's copies of k-tile t have landed
    __syncthreads();   // everyone's (and wt[t % 2], last read by k-tile t - 2, is free)
    convert(t % S, wt);
    wgmma_wait0();        // this warpgroup's k-tile t - 1
    fence_proxy_async();  // the x tile and wt, to the tensor cores
    __syncthreads();      // both warpgroups: k-tile t - 1 done, wt written
    // A: this warpgroup's 64 x rows (K-major, 1024 bytes an 8-row group),
    // 32 bytes a k16 step; B: wt (MN-major, 1024 bytes an 8-deep k group,
    // 8 KB to the second 64 columns), 2048 bytes a k16 step.
    const unsigned xs_s = smem_u32(smem + (t % S) * L::stage_bytes) + wg * 64 * 128;
    const unsigned wt_s = smem_u32(wt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_m64n128k16(acc, sw128_desc(xs_s + kk * 32, 16, 1024),
                       sw128_desc(wt_s + kk * 2048, 8192, 1024));
    wgmma_commit();
    if (t + S - 1 < nkz) load(kt0 + t + S - 1, (t + S - 1) % S);  // the slot of k-tile t - 1
    cp_commit();
  }
  wgmma_wait0();

  // The accumulator: warp w of the warpgroup holds rows 16 (w % 4) + g and
  // + 8, columns 8 j + 2 tq and + 1 in acc[4 j .. 4 j + 3].
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + wg * 64 + (warp % 4) * 16 + g + 8 * h;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * tq;
      if (col >= N) continue;  // the tail tile's columns past N (zero weights)
      const float s0 = acc[4 * j + 2 * h], s1 = acc[4 * j + 2 * h + 1];
      if (ws != nullptr) {
        *reinterpret_cast<float2*>(ws + ((size_t)z * M + row) * N + col) = make_float2(s0, s1);
      } else {
        const float2 sc = *reinterpret_cast<const float2*>(scale + col);
        store2(out + (size_t)row * N + col, s0 * sc.x, s1 * sc.y);
      }
    }
  }
}

// out = (0 + the K splits' partial sums in ascending order) * scale, bf16
// (or f32 for OutT float): the second pass of this path's K split (the
// decode body combines its splits inside its own launch).
template <typename OutT>
__global__ void finish_kernel(const float* __restrict__ ws, const float* __restrict__ scale,
                              OutT* __restrict__ out, int M, int N, int ksplit) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (idx >= total) return;
  float s = 0.f;
  for (int k = 0; k < ksplit; ++k) s += ws[(size_t)k * total + idx];
  store1(out + idx, s * scale[idx % N]);
}

// The C entries' body. Refuses M < 1, N % 64, K % 64, a split that does
// not divide the k-tiles, and a missing workspace. out is OutT [M, N].
template <int BITS, typename OutT = __nv_bfloat16>
int launch(const void* x, const void* w, const void* scale, void* ws, void* out, int M, int K,
           int N, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nk = K / BKV;  // k-tiles: 32 packed rows (int4) or 64 rows (int8) each
  if (M < 1 || N < 64 || N % 64 || K % BKV || ksplit < 1 || nk % ksplit || (ksplit > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = Layout<BITS>::total;
  static const cudaError_t shared_ok = cudaFuncSetAttribute(
      mma_kernel<BITS, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (shared_ok != cudaSuccess) return (int)shared_ok;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, ksplit);
  mma_kernel<BITS, OutT><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<OutT*>(out),
      ksplit > 1 ? static_cast<float*>(ws) : nullptr, M, K, N, nk / ksplit);
  if (ksplit > 1) {
    const size_t total = (size_t)M * N;
    finish_kernel<OutT><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(ws), static_cast<const float*>(scale),
        static_cast<OutT*>(out), M, N, ksplit);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace qmm
