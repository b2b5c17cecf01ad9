// Kernel G: the int8 tied head's f32 logits, read from the table in place,
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel: llm_inference_lab_tpu/ops/quant.py:222
// EmbedQuant.head_logits, an XLA dot_general of x with the int8 table
// (preferred_element_type=f32) that XLA fuses on the TPU without a bf16
// copy of the table. The port cast the table to bf16 on every call (788 MB
// for the 3B's head, twice a K=1 step) and multiplied with cuBLAS.
//
// Computes  logits[m, v] = (sum_d f32(x[m, d]) * f32(q[v, d])) * scale[v]
// with x bf16 [M, D], q the int8 embedding table [V, D] (row-major: the
// rows the lookup gathers), scale f32 [V], logits f32 [M, V]. Each product
// is exact in f32 (|q| <= 127 is exact in bf16).
//
// What bounds it on the H100: at decode M (1 to 16) the table's V D bytes,
// read once at 3.35 TB/s (394 MB for the 3B: 0.118 ms; 263 MB for the 1B:
// 0.079 ms); x, the scales and the logits (4 M V bytes) are a few percent
// of them. At M = 328 (an 8-slot tree verify) the 2 M V D products, on
// mma.sync at a few hundred TFLOP/s, outweigh the bytes.
//
// Design, point by point:
//  * The [V, D] row-major table is mma.sync.m16n8k16's row-major A operand
//    as it lies: 16 vocabulary rows by 16 k, k contiguous in each row. x^T
//    is the column-major B operand (8 tokens by 16 k, k contiguous in each
//    token's row of x). The f32 accumulator is 16 vocabulary rows by 8
//    tokens. No transpose and no second layout of the table.
//  * A block owns BV = 64 vocabulary rows (V / 64 = 2004 blocks for the
//    128,256-token vocabulary fill the card), each of its 4 warps 16 of
//    them, and the whole of D: D is not split, so a row's sum does not
//    need a second pass or a ticket. The last block's rows past V load
//    zeros and store nothing.
//  * The table streams through a cp.async ring of STAGES = 4 chunks of KC
//    = 128 columns (64 rows by 128 bytes, rows padded to 144 bytes so that
//    the 8 rows of one fragment load sit in distinct banks), 3 chunks in
//    flight a block. Each warp converts its 16 rows of a chunk to bf16 in
//    registers once (exact: 2^23 + 128 + b in f32, minus 2^23 + 128), then
//    runs every token tile of the call against them.
//  * Two bodies, by M (the wrapper's WIDE_MIN_M; ops/tied_head.py):
//    - the decode body (tied_head_f32, 4 warps a block, 128 threads): every
//      token of a call in one pass, up to 512 (64 tiles of 8), the table
//      read once from device memory whatever M; the tiles' accumulators
//      persist between chunks in shared memory (16 bytes a lane a tile),
//      unrounded. Small blocks, many of them resident on an SM, keep the
//      table's stream in flight at M = 1 to 16, where the bytes bound it.
//    - the wide body (tied_head_wide_f32, 8 warps a block, 256 threads):
//      a tiled product, block tile 128 vocabulary rows by 128 tokens, both
//      operands staged per 64-column chunk in a 3-stage cp.async ring
//      (rows padded to 80 and 176 bytes: conflict-free fragment loads),
//      warp tile 32 rows by 64 tokens (16 mma.sync a k-step on 8 + 16
//      fragment registers), the sums in registers. At M = 104 or 328 the
//      products outweigh the bytes; the decode body, whose 4 warps run
//      every tile against their rows, waits on its shared-memory round
//      trips there. The token tiles of one vocabulary tile are neighbours
//      in the grid, so the table's re-reads come from L2.
//  * The decode body reads x's fragments from global memory (L1 and L2: x
//    is M D 2 bytes, 12 KB at the 3B's M = 2), 8 bytes a lane a k-step.
//  * A row's bits are independent of M and of the body: every logit is
//    the f32 chain of the same mma.sync instructions over the k-steps in
//    ascending order (k-step j covers k = 16 j .. 16 j + 15, in a lane
//    order fixed by the fragment layout), one f32 product with the scale,
//    whatever the other tokens of the call. chip_smoke.py asserts it at M
//    = 1 to 328.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage: each kernel library has its own CUDA runtime (see
// attn_mma.cuh).
namespace {

constexpr int BV = 64;                    // vocabulary rows a block
constexpr int WARPS = BV / 16;            // a warp each 16 rows
constexpr int THREADS = 32 * WARPS;
constexpr int KC = 128;                   // table columns a chunk: 8 k-steps
constexpr int KSTEPS = KC / 16;
constexpr int ROWB = KC + 16;             // a staged row's bytes, padded
constexpr int STAGES = 4;
constexpr int STAGE_BYTES = BV * ROWB;    // 9 KB
constexpr int MAX_NT = 64;                // the decode body's token tiles of 8 a pass
constexpr size_t RING_BYTES = (size_t)STAGES * STAGE_BYTES;
constexpr size_t MAX_SMEM = RING_BYTES + (size_t)WARPS * MAX_NT * 32 * 16;
// The wide body's tile: TV vocabulary rows by TT tokens, TKC columns a chunk.
constexpr int TV = 128, TT = 128, TKC = 64;
constexpr int TKSTEPS = TKC / 16;
constexpr int TQ_ROWB = TKC + 16;          // a staged table row's bytes (80)
constexpr int TX_ROWB = 2 * TKC + 48;      // a staged token row's bytes (176)
constexpr int TQ_BYTES = TV * TQ_ROWB;     // 10 KB
constexpr int TSTAGE_BYTES = TQ_BYTES + TT * TX_ROWB;  // 32 KB
constexpr int TSTAGES = 3;
constexpr int TTHREADS = 256;              // 8 warps: 4 along the rows x 2 along the tokens
constexpr size_t TSMEM = (size_t)TSTAGES * TSTAGE_BYTES;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
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

// c += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), f32 sums.
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes B0 and B1 of a word already ^ 0x80808080 (b + 128 each) -> one
// bf16x2 word (byte B0 in the low half): 2^23 + 128 + b minus 2^23 + 128
// in f32, exact, then bf16, exact.
template <int B0, int B1>
__device__ __forceinline__ unsigned bytes_bf16x2(unsigned u) {
  constexpr float base = 8388736.f;  // 2^23 + 128
  const float f0 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | B0)) - base;
  const float f1 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | B1)) - base;
  __nv_bfloat162 p = __floats2bfloat162_rn(f0, f1);
  return *reinterpret_cast<unsigned*>(&p);
}

// Stage st <- chunk c of the block's rows [v0, v0 + BV): columns [c KC, c
// KC + KC) (the last chunk of a D that is not a multiple of KC fewer: whole
// k-steps), rows past V zero. Every thread of the block takes its share.
template <int NTHREADS>
__device__ __forceinline__ void load_chunk(unsigned char* smem, const int8_t* __restrict__ q,
                                           int v0, int V, int D, int c, int st) {
  unsigned char* dst = smem + st * STAGE_BYTES;
  const int k0 = c * KC, pieces = min(KC, D - k0) / 16;
  for (int e = threadIdx.x; e < BV * KSTEPS; e += NTHREADS) {
    const int r = e / KSTEPS, p = e % KSTEPS;
    if (p >= pieces) continue;
    const bool live = v0 + r < V;
    cp16(dst + r * ROWB + p * 16, q + (live ? (size_t)(v0 + r) * D + k0 + p * 16 : 0),
         live ? 16 : 0);
  }
}

// The A fragments of a staged chunk's 16 rows (tile: their first row), ks
// k-steps of it, converted to bf16. Lane (g, tq): rows g and g + 8; the 16
// k of a k-step in the fragments' order: the lane's register pairs (k 2 tq,
// 2 tq + 1) and (2 tq + 8, 2 tq + 9) hold the table's and x's k = 4 tq ..
// 4 tq + 3 (a permutation of the step's 16 k, the same for A and B), so a
// lane reads 4 table bytes a row and 8 bytes of x a token.
__device__ __forceinline__ void a_fragments(unsigned (&a)[KSTEPS][4], const unsigned char* tile,
                                            int ks, int g, int tq) {
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    if (s < ks) {
      const unsigned lo =
          *reinterpret_cast<const unsigned*>(tile + g * ROWB + 16 * s + 4 * tq) ^ 0x80808080u;
      const unsigned hi =
          *reinterpret_cast<const unsigned*>(tile + (g + 8) * ROWB + 16 * s + 4 * tq) ^
          0x80808080u;
      a[s][0] = bytes_bf16x2<0, 1>(lo);
      a[s][1] = bytes_bf16x2<0, 1>(hi);
      a[s][2] = bytes_bf16x2<2, 3>(lo);
      a[s][3] = bytes_bf16x2<2, 3>(hi);
    }
  }
}

// acc += the chunk's ks k-steps of rows (a) times token tok's x (xk: x at
// the chunk's first column and the lane's 4 tq; a token past M reads zeros).
__device__ __forceinline__ void tile_mma(float (&acc)[4], const unsigned (&a)[KSTEPS][4],
                                         const __nv_bfloat16* __restrict__ xk, int tok, int M,
                                         int D, int ks) {
  const bool live = tok < M;
  const __nv_bfloat16* xr = xk + (size_t)(live ? tok : 0) * D;
  uint2 xf[KSTEPS];
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s)
    xf[s] = (s < ks && live) ? __ldg(reinterpret_cast<const uint2*>(xr + 16 * s))
                             : make_uint2(0u, 0u);
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s)
    if (s < ks) mma16816(acc, a[s], xf[s].x, xf[s].y);
}

// The logits of one tile's sums: acc[0], acc[1] are row va at tokens ta,
// ta + 1; acc[2], acc[3] row vb = va + 8.
__device__ __forceinline__ void store_tile(float* __restrict__ out, const float (&acc)[4], int ta,
                                           int va, float sa, float sb, int M, int V) {
  const int vb = va + 8;
  if (ta < M) {
    if (va < V) out[(size_t)ta * V + va] = acc[0] * sa;
    if (vb < V) out[(size_t)ta * V + vb] = acc[2] * sb;
  }
  if (ta + 1 < M) {
    if (va < V) out[(size_t)(ta + 1) * V + va] = acc[1] * sa;
    if (vb < V) out[(size_t)(ta + 1) * V + vb] = acc[3] * sb;
  }
}

// The decode body. Grid ceil(V / BV); block c owns vocabulary rows [c BV,
// c BV + BV); warp w its rows 16 w .. 16 w + 15, every token tile of a pass.
__global__ void __launch_bounds__(THREADS)
tied_head_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, float* __restrict__ out, int M, int V,
                 int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* acc_s = reinterpret_cast<float4*>(smem + RING_BYTES);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int v0 = blockIdx.x * BV;
  const int nc = (D + KC - 1) / KC;
  const int va = v0 + 16 * w + g, vb = va + 8;
  const float sa = va < V ? scale[va] : 0.f, sb = vb < V ? scale[vb] : 0.f;

  for (int m0 = 0; m0 < M; m0 += 8 * MAX_NT) {
    const int nt = min(MAX_NT, (M - m0 + 7) / 8);
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nc) load_chunk<THREADS>(smem, q, v0, V, D, s, s);
      cp_commit();
    }
    for (int c = 0; c < nc; ++c) {
      cp_wait<STAGES - 2>();  // this thread's copies of chunk c have landed
      __syncthreads();        // everyone's, and the slot of chunk c - 1 is free
      if (c + STAGES - 1 < nc)
        load_chunk<THREADS>(smem, q, v0, V, D, c + STAGES - 1, (c + STAGES - 1) % STAGES);
      cp_commit();
      const int ks = min(KC, D - c * KC) / 16;
      unsigned a[KSTEPS][4];
      a_fragments(a, smem + (c % STAGES) * STAGE_BYTES + 16 * w * ROWB, ks, g, tq);
      const __nv_bfloat16* xk = x + (size_t)c * KC + 4 * tq;
      for (int t = 0; t < nt; ++t) {
        float4* slot = acc_s + (size_t)(w * nt + t) * 32 + lane;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        if (c > 0) {
          const float4 p = *slot;
          acc[0] = p.x;
          acc[1] = p.y;
          acc[2] = p.z;
          acc[3] = p.w;
        }
        tile_mma(acc, a, xk, m0 + 8 * t + g, M, D, ks);
        if (c + 1 < nc)
          *slot = make_float4(acc[0], acc[1], acc[2], acc[3]);
        else
          store_tile(out, acc, m0 + 8 * t + 2 * tq, va, sa, sb, M, V);
      }
    }
    cp_wait<0>();
    __syncthreads();  // the ring is free before the next pass fills it
  }
}

// Stage st of the wide body <- chunk c of its tile: the table's rows [v0,
// v0 + TV) and x's tokens [t0, t0 + TT), columns [c TKC, c TKC + TKC)
// (whole k-steps), rows past V and tokens past M zero.
__device__ __forceinline__ void load_tile(unsigned char* smem, const int8_t* __restrict__ q,
                                          const __nv_bfloat16* __restrict__ x, int v0, int t0,
                                          int V, int M, int D, int c, int st) {
  unsigned char* dst = smem + st * TSTAGE_BYTES;
  const int k0 = c * TKC, pieces = min(TKC, D - k0) / 16;
  for (int e = threadIdx.x; e < TV * TKSTEPS; e += TTHREADS) {
    const int r = e / TKSTEPS, p = e % TKSTEPS;
    if (p >= pieces) continue;
    const bool live = v0 + r < V;
    cp16(dst + r * TQ_ROWB + p * 16, q + (live ? (size_t)(v0 + r) * D + k0 + p * 16 : 0),
         live ? 16 : 0);
  }
  for (int e = threadIdx.x; e < TT * 2 * TKSTEPS; e += TTHREADS) {
    const int t = e / (2 * TKSTEPS), p = e % (2 * TKSTEPS);
    if (p >= 2 * pieces) continue;
    const bool live = t0 + t < M;
    cp16(dst + TQ_BYTES + t * TX_ROWB + p * 16,
         x + (live ? (size_t)(t0 + t) * D + k0 + p * 8 : 0), live ? 16 : 0);
  }
}

// The wide body. Grid (ceil(M / TT), ceil(V / TV)): block (i, j) the
// tokens [TT i, TT i + TT) against the rows [TV j, TV j + TV). Warp w: rows
// 32 (w % 4) + 16 r + (g, g + 8) for r < 2 and tokens 64 (w / 4) + 8 t +
// (g; 2 tq, 2 tq + 1 in the sums) for t < 8. The fragments' k order is the
// decode body's (a_fragments), so a logit's mma chain is the same.
__global__ void __launch_bounds__(TTHREADS, 2)
tied_head_wide_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                      const float* __restrict__ scale, float* __restrict__ out, int M, int V,
                      int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int wv = w & 3, wt = w >> 2;
  const int g = lane >> 2, tq = lane & 3;
  const int t0 = blockIdx.x * TT, v0 = blockIdx.y * TV;
  const int nc = (D + TKC - 1) / TKC;
  float acc[2][8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int t = 0; t < 8; ++t) acc[r][t][0] = acc[r][t][1] = acc[r][t][2] = acc[r][t][3] = 0.f;
#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    if (s < nc) load_tile(smem, q, x, v0, t0, V, M, D, s, s);
    cp_commit();
  }
  for (int c = 0; c < nc; ++c) {
    cp_wait<TSTAGES - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();         // everyone's, and the slot of chunk c - 1 is free
    if (c + TSTAGES - 1 < nc)
      load_tile(smem, q, x, v0, t0, V, M, D, c + TSTAGES - 1, (c + TSTAGES - 1) % TSTAGES);
    cp_commit();
    const unsigned char* qs = smem + (c % TSTAGES) * TSTAGE_BYTES + 32 * wv * TQ_ROWB;
    const unsigned char* xs =
        smem + (c % TSTAGES) * TSTAGE_BYTES + TQ_BYTES + 64 * wt * TX_ROWB;
    const int ks = min(TKC, D - c * TKC) / 16;
#pragma unroll
    for (int s = 0; s < TKSTEPS; ++s) {
      if (s >= ks) break;
      unsigned a[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const unsigned char* row = qs + (16 * r + g) * TQ_ROWB + 16 * s + 4 * tq;
        const unsigned lo = *reinterpret_cast<const unsigned*>(row) ^ 0x80808080u;
        const unsigned hi = *reinterpret_cast<const unsigned*>(row + 8 * TQ_ROWB) ^ 0x80808080u;
        a[r][0] = bytes_bf16x2<0, 1>(lo);
        a[r][1] = bytes_bf16x2<0, 1>(hi);
        a[r][2] = bytes_bf16x2<2, 3>(lo);
        a[r][3] = bytes_bf16x2<2, 3>(hi);
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const uint2 b =
            *reinterpret_cast<const uint2*>(xs + (8 * t + g) * TX_ROWB + 32 * s + 8 * tq);
        mma16816(acc[0][t], a[0], b.x, b.y);
        mma16816(acc[1][t], a[1], b.x, b.y);
      }
    }
  }
  cp_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int va = v0 + 32 * wv + 16 * r + g, vb = va + 8;
    const float sa = va < V ? scale[va] : 0.f, sb = vb < V ? scale[vb] : 0.f;
#pragma unroll
    for (int t = 0; t < 8; ++t)
      store_tile(out, acc[r][t], t0 + 64 * wt + 8 * t + 2 * tq, va, sa, sb, M, V);
  }
}

}  // namespace

// x bf16 [M, D], 16-byte aligned rows; q int8 [V, D], contiguous and 16-byte
// aligned; scale f32 [V]; out f32 [M, V]. Requires M >= 1, V >= 1 and D a
// positive multiple of 16 (checked here and by the Python wrapper). The
// decode body (the wrapper's route below WIDE_MIN_M rows).
extern "C" int tied_head_f32(const void* x, const void* q, const void* scale, void* out, int M,
                             int V, int D, void* stream) {
  if (M < 1 || V < 1 || D < 16 || D % 16) return (int)cudaErrorInvalidValue;
  static const cudaError_t shared_ok = cudaFuncSetAttribute(
      tied_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (shared_ok != cudaSuccess) return (int)shared_ok;
  const int nt = min(MAX_NT, (M + 7) / 8);
  const size_t smem = RING_BYTES + (size_t)WARPS * nt * 32 * 16;
  tied_head_kernel<<<(V + BV - 1) / BV, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(out), M, V, D);
  return (int)cudaGetLastError();
}

// The same arguments and result through the wide body (the wrapper's
// route from WIDE_MIN_M rows).
extern "C" int tied_head_wide_f32(const void* x, const void* q, const void* scale, void* out,
                                  int M, int V, int D, void* stream) {
  if (M < 1 || V < 1 || D < 16 || D % 16) return (int)cudaErrorInvalidValue;
  static const cudaError_t shared_ok = cudaFuncSetAttribute(
      tied_head_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TSMEM);
  if (shared_ok != cudaSuccess) return (int)shared_ok;
  const dim3 grid((M + TT - 1) / TT, (V + TV - 1) / TV);
  tied_head_wide_kernel<<<grid, TTHREADS, TSMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(out), M, V, D);
  return (int)cudaGetLastError();
}
