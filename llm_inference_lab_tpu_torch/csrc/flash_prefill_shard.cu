// Kernel E's shard variant, for Hopper: one hop of ring attention, the
// rank's resident query rows against the K/V block it holds.
//
// Replaces: llm_inference_lab_tpu/parallel/context.py _block_update, the
//           online-softmax step of ring_attention_shard against one K/V
//           block (JAX's XLA einsums; no Pallas kernel there). The ring
//           passes each rank's prompt block around the seq group; a rank
//           runs this kernel on each block it holds and merges the blocks'
//           rows by log-sum-exp (llm_inference_lab_tpu_torch/parallel/
//           context.py), which is the online softmax of JAX's loop.
//
//   out[b, s, h, :] = softmax_t(q[b,s,h] . k[b,h/g,t] * scale | t <= p[b,s],
//                               t0 <= t < t0 + T) @ v        (f32, unrounded)
//   lse[b, h, s]    = log sum_t exp(...)                    (-inf: no key)
//
// q bf16 [B, S, H, D] (the rank's S = P / n prompt rows); k, v bf16
// [B, KVH, T, D], the block of positions [t0, t0 + T) (the raw K and V of a
// prompt block, as JAX's ring attends them: never an int8 cache); positions
// int32 [B, S]; out f32 [B, S, H, D]; lse f32 [B, H, S].
//
// What bounds it on the H100: the larger of the bytes (q, out, the block's
// K and V) at 3.35 TB/s and the operations (4 * D per visible key, per
// query row and head) at the bf16 tensor-core peak, 989 TFLOP/s, as kernel
// E's: a 2048-row block against a 2048-key block at the 3B's geometry is
// 2 * 24 * 2048 * 2048 * 128 * 2 = 51.5 GFLOP, 52 us, when every key is
// visible (the diagonal block half of it, a block wholly in the future
// none).
//
// Design: kernel E itself (attn_mma.cuh with MAP_SHARD, no split): each
// block walks the tiles of its rows' visible keys of the block and writes
// its rows unrounded, with m + log(l).

#include "attn_mma.cuh"

// flash_prefill_bf16's operands with t0 and lse, no softcap, window or
// ring (the ring prefill refuses Gemma-2's options, as JAX's does).
extern "C" int flash_prefill_shard_bf16(const void* q, const void* k, const void* v,
                                        const void* pos, void* out, void* lse, int B, int S,
                                        int H, int KVH, int T, int D, long long stride_kb,
                                        long long stride_kh, float scale, int t0, void* stream) {
  return mma::launch_shard<__nv_bfloat16>(q, k, v, nullptr, nullptr, pos, out,
                                          static_cast<float*>(lse), nullptr, nullptr, B, S, H,
                                          KVH, T, D, stride_kb, stride_kh, 0, 0,
                                          {scale, 0.f, 0, 0}, t0, 0, stream);
}
