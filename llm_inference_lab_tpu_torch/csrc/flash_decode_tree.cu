// Kernel D's tree variant, for Hopper: the verify chunk of tree speculation
// over a contiguous bf16 or int8 KV cache (S <= 32 rows).
//
// Replaces: llm_inference_lab_tpu/ops/attention.py attend_xla's tree branch
//           (:94-106), which the JAX package runs for a tree-masked call
//           (ops/pallas/flash_decode.py:240 sends tree_mask there): the
//           chunk's S nodes sit at slots start[b] .. start[b] + S - 1 of
//           sequence b, and node s sees every slot before the chunk and the
//           chunk's slot start[b] + j iff tree_mask[s, j] (itself and its
//           ancestors), nothing after it; a row with no visible key is zeros.
//
// What bounds it on the H100: the bytes of K and V up to the chunk's last
// slot (plus 8 bytes of scales a key for int8), q and out, at 3.35 TB/s:
// ~1 MB at the 3B's tree step (T = 256), a fraction of a microsecond; like
// kernel D at the verify, it waits on launch and load latency.
//
// Design: kernel D itself (attn_mma.cuh, TREE = true): the same tensor-core
// tile body, key tiles and split over T at fixed 256-key ranges, so a row's
// arithmetic is D's; only the mask differs. Each row takes one 32-bit
// ancestry word (bit j: the chunk's node j) into shared memory, and its key
// range is [0, start + S): the split's blocks past the chunk take their
// ticket and load nothing, and inside the chunk a key counts iff its bit is
// set. A node sits at slot start + i but at logical position start +
// depth(i), so the chain rule kv <= position would hide its own slot and its
// ancestors': the tree variant never reads positions.

#include "attn_mma.cuh"

// The tree variant (attend_xla's tree branch, which the JAX package runs for
// tree speculation's verify chunk): the bf16 entry's q, k, v, out, split
// buffers and strides, with bits uint32 [S] (bit j of bits[s]: node s sees
// node j of the chunk) and start int32 [B] (the chunk's first slot) in place
// of the positions; no window or ring; S <= 32. Row s sees the keys before
// start[b] and the chunk's keys its bits name.
extern "C" int flash_decode_tree_bf16(const void* q, const void* k, const void* v,
                                      const void* bits, const void* start, void* out, void* ws,
                                      void* counters, int B, int S, int H, int KVH, int T, int D,
                                      long long stride_kb, long long stride_kh, float scale,
                                      float softcap, int nsplit, void* stream) {
  return mma::launch_tree<__nv_bfloat16>(
      q, k, v, nullptr, nullptr, out, static_cast<float*>(ws), static_cast<unsigned*>(counters),
      B, S, H, KVH, T, D, stride_kb, stride_kh, 0, 0, {scale, softcap, 0, 0}, nsplit,
      {static_cast<const unsigned*>(bits), static_cast<const int*>(start)}, stream);
}

// The tree variant over an int8 cache: flash_decode_int8's scales and
// strides, the tree's bits and start.
extern "C" int flash_decode_tree_int8(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale, const void* bits,
                                      const void* start, void* out, void* ws, void* counters,
                                      int B, int S, int H, int KVH, int T, int D,
                                      long long stride_kb, long long stride_kh,
                                      long long stride_sb, long long stride_sh, float scale,
                                      float softcap, int nsplit, void* stream) {
  return mma::launch_tree<int8_t>(
      q, k, v, k_scale, v_scale, out, static_cast<float*>(ws), static_cast<unsigned*>(counters),
      B, S, H, KVH, T, D, stride_kb, stride_kh, stride_sb, stride_sh, {scale, softcap, 0, 0},
      nsplit, {static_cast<const unsigned*>(bits), static_cast<const int*>(start)}, stream);
}
