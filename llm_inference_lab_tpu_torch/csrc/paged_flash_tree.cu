// Kernel F's tree variant, for Hopper: the verify chunk of tree speculation
// over a paged bf16 or int8 KV pool (S <= 32 rows).
//
// Replaces: llm_inference_lab_tpu/ops/paged_attention.py paged_attend_xla
//           (:31) with tree_mask, the gather and attend_xla's tree branch,
//           which the JAX package runs for a tree-masked paged call
//           (ops/pallas/paged_flash.py:196-210 send tree_mask there).
//
// The function of flash_decode_tree.cu with key j of sequence b read from
// page table[b, j / P], row j % P, of the layer's pool; start[b] is a slot
// (page ordinal * P + row).
//
// What bounds it on the H100: the bytes of the pages up to each chunk's last
// slot, q and out, at 3.35 TB/s: a few hundred KB at the 8-slot serving
// step, so it waits on launch and load latency, as kernel F does.
//
// Design: kernel F (attn_mma.cuh, MAP_PAGED, TREE = true): D's tree variant
// with the page table as its address map, so it gives flash_decode_tree's
// bits on the same keys; a block reads the table only for the pages that
// hold a key of [0, start + S).

#include "attn_mma.cuh"

// The tree variant (paged_attend_xla's tree branch): the bf16 entry's
// arguments with bits uint32 [S] and start int32 [B] (the chunk's first
// slot, page ordinal * P + row) in place of the positions; no window; S <=
// 32. Through the table, the function of flash_decode_tree_bf16.
extern "C" int paged_flash_tree_bf16(const void* q, const void* k_pool, const void* v_pool,
                                     const void* table, const void* bits, const void* start,
                                     void* out, void* ws, void* counters, int B, int S, int H,
                                     int KVH, int M, int P, int D, long long stride_page,
                                     float scale, float softcap, int nsplit, void* stream) {
  return mma::launch_paged_tree<__nv_bfloat16>(
      q, k_pool, v_pool, nullptr, nullptr, table, out, static_cast<float*>(ws),
      static_cast<unsigned*>(counters), B, S, H, KVH, M, P, D, stride_page, 0,
      {scale, softcap, 0, 0}, nsplit,
      {static_cast<const unsigned*>(bits), static_cast<const int*>(start)}, stream);
}

// The tree variant over int8 pools: paged_flash_int8's scale pools and
// strides, the tree's bits and start.
extern "C" int paged_flash_tree_int8(const void* q, const void* k_pool, const void* v_pool,
                                     const void* k_scale, const void* v_scale, const void* table,
                                     const void* bits, const void* start, void* out, void* ws,
                                     void* counters, int B, int S, int H, int KVH, int M, int P,
                                     int D, long long stride_page, long long stride_spage,
                                     float scale, float softcap, int nsplit, void* stream) {
  return mma::launch_paged_tree<int8_t>(
      q, k_pool, v_pool, k_scale, v_scale, table, out, static_cast<float*>(ws),
      static_cast<unsigned*>(counters), B, S, H, KVH, M, P, D, stride_page, stride_spage,
      {scale, softcap, 0, 0}, nsplit,
      {static_cast<const unsigned*>(bits), static_cast<const int*>(start)}, stream);
}
