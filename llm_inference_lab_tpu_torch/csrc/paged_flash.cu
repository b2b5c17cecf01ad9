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
// sequence's rows see, plus 8 bytes of scales a key for int8, q and out) at
// 3.35 TB/s. At the serving step's shapes that is a few hundred KB, so, like
// kernel D, it waits on launch and load latency.
//
// Design: kernel D's tensor-core body (attn_mma.cuh), the Pallas kernel's
// own arrangement (paged_flash.py _body runs flash_decode's _accum_tile):
// 64-row blocks with the GQA group folded in, 64-key tiles at absolute
// positions (32 at head dim 256) double-buffered with cp.async, p rounded to
// bf16 before P.V, the split over T at fixed 256-key ranges with the ticket
// combine (nsplit from decode_splits with T = M * P). The page table is the
// body's third address map (MAP_PAGED): a tile looks its pages up once each,
// into shared memory, so P is any power of two (a 64-key tile spans four
// pages of 16, or half of a page of 128). So F gives the same bits as D on
// the same keys, and a paged batch decodes exactly like a contiguous one.
//  * Live range: a block loads keys only from the lowest first visible key
//    among its rows (the window) up to the largest position among them,
//    and reads the table only for the pages that hold them. That is the
//    port's form of the Pallas live-page clamp and window page sweep: dead
//    pages, pages below the window, unused table entries and the dummy page
//    0 are never read for a live row. Keys stop at M * P, so no table read
//    is out of range whatever the positions.

#include "attn_mma.cuh"

// Requires D in {64, 96, 128, 256}, H % KVH == 0, P a power of two, contiguous
// q / out / positions / table, unit-stride [P, D] pages with head stride
// P * D in both pools, and page ids in [0, N) (checked in Python, the ids by
// the allocator); the options of flash_decode_bf16 but the ring. nsplit > 1:
// ws holds B * KVH * row blocks * nsplit * 64 * (D + 2) floats, counters
// B * KVH * row blocks zeros (left zero).
extern "C" int paged_flash_bf16(const void* q, const void* k_pool, const void* v_pool,
                                const void* table, const void* pos, void* out, void* ws,
                                void* counters, int B, int S, int H, int KVH, int M, int P, int D,
                                long long stride_page, float scale, float softcap, int window,
                                int nsplit, void* stream) {
  return mma::launch_paged<__nv_bfloat16>(
      q, k_pool, v_pool, nullptr, nullptr, table, pos, out, static_cast<float*>(ws),
      static_cast<unsigned*>(counters), B, S, H, KVH, M, P, D, stride_page, 0,
      {scale, softcap, window, 0}, nsplit, stream);
}

// int8 pools: the bf16 entry's arguments plus the k and v scale pools
// [N, KVH, P] f32 and their page stride (checked in Python).
extern "C" int paged_flash_int8(const void* q, const void* k_pool, const void* v_pool,
                                const void* k_scale, const void* v_scale, const void* table,
                                const void* pos, void* out, void* ws, void* counters, int B, int S,
                                int H, int KVH, int M, int P, int D, long long stride_page,
                                long long stride_spage, float scale, float softcap, int window,
                                int nsplit, void* stream) {
  return mma::launch_paged<int8_t>(q, k_pool, v_pool, k_scale, v_scale, table, pos, out,
                                   static_cast<float*>(ws), static_cast<unsigned*>(counters), B,
                                   S, H, KVH, M, P, D, stride_page, stride_spage,
                                   {scale, softcap, window, 0}, nsplit, stream);
}
