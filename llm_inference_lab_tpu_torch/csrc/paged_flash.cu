// Online-softmax GQA decode attention over a paged bf16 KV pool, for Hopper
// (kernel F).
//
// Replaces: llm_inference_lab_tpu/ops/pallas/paged_flash.py
//           paged_flash_attention (_body, live-page clamp), bf16 chain-decode
//           variant: mask kv_pos <= p, scale D**-0.5. The window, softcap,
//           scale-override and int8-pool variants are not ported yet.
//
// The function of flash_decode.cu, with key j of sequence b read from page
// table[b, j / P], row j % P, of the layer's pool:
//
// q bf16 [B, S, H, D]; k, v pools bf16 [N, KVH, P, D] (one layer's view of
// the stacked [L, N, KVH, P, D] pool: unit-stride [P, D] pages, head stride
// P * D, page stride given); table int32 [B, M]; positions int32 [B, S];
// out bf16 [B, S, H, D].
//
// What bounds it on the H100: the bytes of the live pages (keys up to
// max(p) + 1 of each sequence, plus q and out) at 3.35 TB/s. At the serving
// step's shapes that is a few hundred KB, so, like kernel D, it waits on
// launch and load latency with B * KVH blocks.
//
// Design: the block body of attn_tile.cuh, exactly as flash_decode.cu runs
// it (4 warps, 64 rows, grid (B * KVH, row blocks)), with the page lookup as
// the only difference. So F gives the same bits as D on the same keys, and
// a paged batch decodes exactly like a contiguous one.
//  * Live range: a block walks keys only up to the largest position among
//    its rows, and the body never reads a key past it. That is the port's
//    form of the Pallas live-page clamp: dead pages, unused table entries
//    and the dummy page 0 are never read for a live row.
//  * The page is looked up per key, not per tile, so P = 16, 32 and 64 all
//    work with 32-key tiles. Keys stop at M * P, so no table read is out of
//    range whatever the positions.

#include "attn_tile.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int ROWS = WARPS * attn::RPW;  // query rows per block, as in flash_decode.cu

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
paged_flash_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                   const __nv_bfloat16* __restrict__ vp, const int* __restrict__ table,
                   const int* __restrict__ pos, __nv_bfloat16* __restrict__ out, int S, int H,
                   int KVH, int M, int P, long long stride_page, float scale) {
  __shared__ __align__(16) __nv_bfloat16 qs[ROWS * D];
  __shared__ __align__(16) attn::Tile<D> tile;
  __shared__ int kmax_s;
  const int b = blockIdx.x / KVH, h = blockIdx.x % KVH;
  const size_t head = (size_t)h * P * D;
  const attn::PagedKeys<D> keys{kp + head, vp + head, table + (size_t)b * M, P, stride_page};
  attn::attend_rows<D>(q, pos, out, keys, b, h, S, H, KVH, blockIdx.y * ROWS, M * P, scale, qs,
                       tile, kmax_s);
}

}  // namespace

// Requires D in {64, 128}, H % KVH == 0, contiguous q / out / positions /
// table, unit-stride [P, D] pages with head stride P * D in both pools, and
// page ids in [0, N) (checked in Python, the ids by the allocator).
extern "C" int paged_flash_bf16(const void* q, const void* k_pool, const void* v_pool,
                                const void* table, const void* pos, void* out, int B, int S,
                                int H, int KVH, int M, int P, int D, long long stride_page,
                                float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nrows = S * (H / KVH);
  dim3 grid(B * KVH, (nrows + ROWS - 1) / ROWS);
  dim3 block(WARPS * 32);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_pool);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_pool);
  const auto* tp = static_cast<const int*>(table);
  const auto* pp = static_cast<const int*>(pos);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 128) {
    paged_flash_kernel<128><<<grid, block, 0, st>>>(qp, kp, vp, tp, pp, op, S, H, KVH, M, P,
                                                    stride_page, scale);
  } else if (D == 64) {
    paged_flash_kernel<64><<<grid, block, 0, st>>>(qp, kp, vp, tp, pp, op, S, H, KVH, M, P,
                                                   stride_page, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
