// Kernel D's shard variant with the ancestry word, for Hopper: the verify
// chunk of tree speculation over one rank's slice of a contiguous bf16 or
// int8 KV cache whose T is split over the seq axis (any number S of rows).
//
// Replaces: llm_inference_lab_tpu/ops/attention.py attend_xla's tree branch
//           (:94-106) over a cache that
//           llm_inference_lab_tpu/parallel/sharding.py _cache_sharding
//           splits on T over the "seq" mesh axis: there GSPMD gives the
//           masked softmax the global cache, here each rank attends its
//           slice and the ranks merge the slices' rows by log-sum-exp
//           (llm_inference_lab_tpu_torch/ops/attention.py attend_slices).
//
//   out[b, s, h, :] = softmax_t(cap(q[b,s,h] . k[b,h/g,t] * scale) |
//                               t < start[b] or bit (t - start[b]) of row s,
//                               t < start[b] + S, t0 <= t < t0 + T) @ v
//   lse[b, h, s]    = log sum_t exp(...)                  (-inf: no key)
//
// q bf16 [B, S, H, D]; k, v bf16 or int8 [B, KVH, T, D], the rank's slice,
// slot j holding position t0 + j (for int8, scales f32 [B, KVH, T]);
// bits uint32 [S, ceil(S / 32)], bit j % 32 of bits[s, j / 32] for the
// chunk's node j; start int32 [B], the chunk's first absolute position;
// out f32 [B, S, H, D] unrounded; lse f32 [B, H, S]. The chunk may straddle
// two ranks' slices: a rank sees its keys before the chunk and the chunk's
// keys in its slice whose bit is set; a row that sees none gets lse -inf
// and adds nothing to the merge.
//
// What bounds it on the H100: the bytes of K and V of the slice up to the
// chunk's last position (plus 8 bytes of scales a key for int8), q, out and
// lse, at 3.35 TB/s, as kernel D's tree variant.
//
// Design: kernel D itself (attn_mma.cuh with MAP_SHARD and TREE = true):
// the tree variant's mask on the shard map's absolute key positions, the
// split over T at fixed 256-key ranges, and the last block of a row block
// writing the rows unrounded with m + log(l). Built apart from
// flash_decode_shard.cu so the two compile side by side.

#include "attn_mma.cuh"

// The bf16 slice: flash_decode_shard_bf16's operands with bits and start
// in place of the positions, the scale and the softcap (0: off); no window.
extern "C" int flash_decode_shard_tree_bf16(const void* q, const void* k, const void* v,
                                            const void* bits, const void* start, void* out,
                                            void* lse, void* ws, void* counters, int B, int S,
                                            int H, int KVH, int T, int D, long long stride_kb,
                                            long long stride_kh, float scale, float softcap,
                                            int t0, int nsplit, void* stream) {
  return mma::launch_shard<__nv_bfloat16, true>(
      q, k, v, nullptr, nullptr, nullptr, out, static_cast<float*>(lse),
      static_cast<float*>(ws), static_cast<unsigned*>(counters), B, S, H, KVH, T, D, stride_kb,
      stride_kh, 0, 0, {scale, softcap, 0, 0}, t0, nsplit, stream,
      {static_cast<const unsigned*>(bits), static_cast<const int*>(start)});
}

// The int8 slice: flash_decode_shard_int8's scales and strides, the tree's
// bits and start.
extern "C" int flash_decode_shard_tree_int8(const void* q, const void* k, const void* v,
                                            const void* k_scale, const void* v_scale,
                                            const void* bits, const void* start, void* out,
                                            void* lse, void* ws, void* counters, int B, int S,
                                            int H, int KVH, int T, int D, long long stride_kb,
                                            long long stride_kh, long long stride_sb,
                                            long long stride_sh, float scale, float softcap,
                                            int t0, int nsplit, void* stream) {
  return mma::launch_shard<int8_t, true>(
      q, k, v, k_scale, v_scale, nullptr, out, static_cast<float*>(lse),
      static_cast<float*>(ws), static_cast<unsigned*>(counters), B, S, H, KVH, T, D, stride_kb,
      stride_kh, stride_sb, stride_sh, {scale, softcap, 0, 0}, t0, nsplit, stream,
      {static_cast<const unsigned*>(bits), static_cast<const int*>(start)});
}
