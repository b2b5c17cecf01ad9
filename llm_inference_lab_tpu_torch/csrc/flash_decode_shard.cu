// Kernel D's shard variant, for Hopper: attention of replicated query rows
// over one rank's slice of a KV cache whose T is split over the seq axis, a
// bf16 or an int8 cache.
//
// Replaces: llm_inference_lab_tpu/ops/pallas/flash_decode.py
//           flash_decode_attention over a cache that
//           llm_inference_lab_tpu/parallel/sharding.py _cache_sharding
//           splits on T over the "seq" mesh axis: there GSPMD gives the
//           kernel the global cache, here each rank attends its slice and
//           the ranks merge the slices' rows by log-sum-exp
//           (llm_inference_lab_tpu_torch/parallel/context.py), which gives
//           the global softmax without gathering the cache.
//
//   out[b, s, h, :] = softmax_t(cap(q[b,s,h] . k[b,h/g,t] * scale) |
//                               p[b,s] - window < t <= p[b,s],
//                               t0 <= t < t0 + T) @ v        (f32, unrounded)
//   lse[b, h, s]    = log sum_t exp(...)                    (-inf: no key)
//
// q bf16 [B, S, H, D]; k, v bf16 or int8 [B, KVH, T, D] (a layer's view of
// the rank's [L, B, KVH, T, D] slice, through its batch and head strides),
// slot j holding position t0 + j; for int8, k and v scales f32 [B, KVH, T];
// positions int32 [B, S]; out f32 [B, S, H, D]; lse f32 [B, H, S]. cap is
// Gemma-2's softcap (cap(s) = softcap * tanh(s / softcap); 0: off) and
// window its sliding window (0: off), compared with absolute positions, so
// a rank whose whole slice lies behind a row's window gives it lse -inf.
//
// What bounds it on the H100: the bytes of K and V of the slice that some
// row sees, from the lowest window start to the largest position (plus 8
// bytes of scales a key for int8), q, out and lse, at 3.35 TB/s, as kernel
// D's.
//
// Design: kernel D itself (attn_mma.cuh with MAP_SHARD): the same tile
// body, tiles at absolute positions and the split over T at fixed 256-key
// ranges, so a row's arithmetic over a slice is D's over the same keys; the
// last block of a row block writes the rows unrounded with m + log(l) of
// the combine. The window and the softcap are run-time options of the same
// instantiation (Gemma-2's layers over a T-split cache:
// ops/flash_decode.py flash_decode_shard_opts counts their launches).

#include "attn_mma.cuh"

// The bf16 cache: flash_decode_bf16's operands with t0 and lse, and the
// score scale, softcap and window (0 turns the last two off); no ring.
// nsplit >= 1 (ceil(T / 256), one more where t0 is not a multiple of 256).
extern "C" int flash_decode_shard_bf16(const void* q, const void* k, const void* v,
                                       const void* pos, void* out, void* lse, void* ws,
                                       void* counters, int B, int S, int H, int KVH, int T,
                                       int D, long long stride_kb, long long stride_kh,
                                       float scale, float softcap, int window, int t0,
                                       int nsplit, void* stream) {
  if (nsplit < 1) return (int)cudaErrorInvalidValue;
  return mma::launch_shard<__nv_bfloat16>(
      q, k, v, nullptr, nullptr, pos, out, static_cast<float*>(lse), static_cast<float*>(ws),
      static_cast<unsigned*>(counters), B, S, H, KVH, T, D, stride_kb, stride_kh, 0, 0,
      {scale, softcap, window, 0}, t0, nsplit, stream);
}

// The int8 cache: flash_decode_int8's scales and strides.
extern "C" int flash_decode_shard_int8(const void* q, const void* k, const void* v,
                                       const void* k_scale, const void* v_scale,
                                       const void* pos, void* out, void* lse, void* ws,
                                       void* counters, int B, int S, int H, int KVH, int T,
                                       int D, long long stride_kb, long long stride_kh,
                                       long long stride_sb, long long stride_sh, float scale,
                                       float softcap, int window, int t0, int nsplit,
                                       void* stream) {
  if (nsplit < 1) return (int)cudaErrorInvalidValue;
  return mma::launch_shard<int8_t>(
      q, k, v, k_scale, v_scale, pos, out, static_cast<float*>(lse), static_cast<float*>(ws),
      static_cast<unsigned*>(counters), B, S, H, KVH, T, D, stride_kb, stride_kh, stride_sb,
      stride_sh, {scale, softcap, window, 0}, t0, nsplit, stream);
}
