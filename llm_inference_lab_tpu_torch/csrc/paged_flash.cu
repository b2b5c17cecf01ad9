// Online-softmax GQA decode attention over a paged bf16 or int8 KV pool,
// for Hopper (kernel F).
//
// Replaces: llm_inference_lab_tpu/ops/pallas/paged_flash.py
//           paged_flash_attention (_body, live-page clamp and window page
//           sweep), chain-decode variants: mask kv_pos <= p, bf16 pools
//           (_kernel) and int8 pools with per-row scale pools
//           (_kernel_quant), with the options scale, softcap and window.
//
// The function of flash_decode.cu, with key j of sequence b read from page
// table[b, j / P], row j % P, of the layer's pool:
//
// q bf16 [B, S, H, D]; k, v pools bf16 or int8 [N, KVH, P, D] (one layer's
// view of the stacked [L, N, KVH, P, D] pool: unit-stride [P, D] pages, head
// stride P * D, page stride given); for int8, k and v scale pools f32
// [N, KVH, P] (unit-stride pages, head stride P, page stride given); table
// int32 [B, M]; positions int32 [B, S]; out bf16 [B, S, H, D].
//
// What bounds it on the H100: the bytes of the live pages (the keys each
// sequence's rows see, plus 8 bytes of scales a key for int8, q and
// out) at 3.35 TB/s. At the serving
// step's shapes that is a few hundred KB, so, like kernel D, it waits on
// launch and load latency with B * KVH blocks.
//
// Design: the block body of attn_tile.cuh, exactly as flash_decode.cu runs
// it (4 warps, 64 rows or 32 at D = 256, grid (B * KVH, row blocks)), with
// the page lookup as the only difference. So F gives the same bits as D on
// the same keys, and a paged batch decodes exactly like a contiguous one.
//  * Live range: a block walks keys only from the lowest first visible key
//    among its rows (the window) up to the largest position among them, and
//    the body never reads a key outside it. That is the port's form of the
//    Pallas live-page clamp and window page sweep: dead pages, pages below
//    the window, unused table entries and the dummy page 0 are never read
//    for a live row.
//  * The page is looked up per key, not per tile, so P = 16, 32 and 64 all
//    work with 32-key tiles. Keys stop at M * P, so no table read is out of
//    range whatever the positions.

#include "attn_tile.cuh"

namespace {

constexpr int WARPS = 4;

template <int D>
constexpr int ROWS = WARPS * attn::RPW<D>;  // query rows per block, as in flash_decode.cu

template <int D, class T>
__global__ void __launch_bounds__(WARPS * 32)
paged_flash_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const float* __restrict__ ksp,
                   const float* __restrict__ vsp, const int* __restrict__ table,
                   const int* __restrict__ pos, __nv_bfloat16* __restrict__ out, int S, int H,
                   int KVH, int M, int P, long long stride_page, long long stride_spage,
                   attn::Options opt) {
  extern __shared__ __align__(16) unsigned char qs_raw[];  // [ROWS<D>, D] bf16
  __shared__ __align__(16) attn::Tile<D, T> tile;
  __shared__ int kmax_s, kmin_s;
  const int b = blockIdx.x / KVH, h = blockIdx.x % KVH;
  const size_t head = (size_t)h * P * D, shead = (size_t)h * P;
  const attn::PagedKeys<D, T> keys{kp + head, vp + head, ksp + shead, vsp + shead,
                                   table + (size_t)b * M, P, stride_page, stride_spage};
  attn::attend_rows<D, T>(q, pos, out, keys, b, h, S, H, KVH, blockIdx.y * ROWS<D>, M * P, opt,
                          reinterpret_cast<__nv_bfloat16*>(qs_raw), tile, kmax_s, kmin_s);
}

template <int D, class T>
int launch_d(const void* q, const void* k_pool, const void* v_pool, const void* ks_pool,
             const void* vs_pool, const void* table, const void* pos, void* out, int B, int S,
             int H, int KVH, int M, int P, long long stride_page, long long stride_spage,
             attn::Options opt, cudaStream_t st) {
  constexpr size_t smem = (size_t)ROWS<D> * D * sizeof(__nv_bfloat16);
  static const cudaError_t shared_ok =
      attn::allow_shared(paged_flash_kernel<D, T>, smem, sizeof(attn::Tile<D, T>) + 2 * sizeof(int));
  if (shared_ok != cudaSuccess) return (int)shared_ok;
  const int nrows = S * (H / KVH);
  dim3 grid(B * KVH, (nrows + ROWS<D> - 1) / ROWS<D>);
  paged_flash_kernel<D, T><<<grid, WARPS * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const float*>(ks_pool),
      static_cast<const float*>(vs_pool), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), S, H, KVH, M, P,
      stride_page, stride_spage, opt);
  return (int)cudaGetLastError();
}

template <class T>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* ks_pool,
           const void* vs_pool, const void* table, const void* pos, void* out, int B, int S,
           int H, int KVH, int M, int P, int D, long long stride_page, long long stride_spage,
           attn::Options opt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_d<128, T>(q, k_pool, v_pool, ks_pool, vs_pool, table, pos, out, B, S, H, KVH,
                            M, P, stride_page, stride_spage, opt, st);
  if (D == 64)
    return launch_d<64, T>(q, k_pool, v_pool, ks_pool, vs_pool, table, pos, out, B, S, H, KVH,
                           M, P, stride_page, stride_spage, opt, st);
  if (D == 256)
    return launch_d<256, T>(q, k_pool, v_pool, ks_pool, vs_pool, table, pos, out, B, S, H, KVH,
                            M, P, stride_page, stride_spage, opt, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Requires D in {64, 128, 256}, H % KVH == 0, contiguous q / out /
// positions / table, unit-stride [P, D] pages with head stride P * D in both
// pools, and page ids in [0, N) (checked in Python, the ids by the
// allocator); the options of flash_decode_bf16.
extern "C" int paged_flash_bf16(const void* q, const void* k_pool, const void* v_pool,
                                const void* table, const void* pos, void* out, int B, int S,
                                int H, int KVH, int M, int P, int D, long long stride_page,
                                float scale, float softcap, int window, void* stream) {
  return launch<__nv_bfloat16>(q, k_pool, v_pool, nullptr, nullptr, table, pos, out, B, S, H,
                               KVH, M, P, D, stride_page, 0, {scale, softcap, window}, stream);
}

// int8 pools: the bf16 entry's arguments plus the k and v scale pools
// [N, KVH, P] f32 and their page stride (checked in Python).
extern "C" int paged_flash_int8(const void* q, const void* k_pool, const void* v_pool,
                                const void* k_scale, const void* v_scale, const void* table,
                                const void* pos, void* out, int B, int S, int H, int KVH, int M,
                                int P, int D, long long stride_page, long long stride_spage,
                                float scale, float softcap, int window, void* stream) {
  return launch<int8_t>(q, k_pool, v_pool, k_scale, v_scale, table, pos, out, B, S, H, KVH, M,
                        P, D, stride_page, stride_spage, {scale, softcap, window}, stream);
}
