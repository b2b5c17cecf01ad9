// Online-softmax GQA attention over a contiguous bf16 or int8 KV cache, for
// Hopper (kernel D): the decode and verify calls (S <= 32).
//
// Replaces: llm_inference_lab_tpu/ops/pallas/flash_decode.py
//           flash_decode_attention (tile body _accum_tile), chain-decode
//           variants: mask kv_pos <= p, a bf16 cache (_kernel) and an int8
//           cache with per-row scales (_kernel_quant), with the options
//           scale, softcap, window and ring_len (the modular mask of the
//           rolling-buffer cache).
//
//   out[b, s, h, :] = softmax_t(cap(q[b,s,h] . k[b,h/g,t] * scale)
//                               | p[b,s] - window < t <= p[b,s]) @ v
//
// (with a ring of R slots, t is the position p - rel that slot
// (p - rel) % R holds, rel < min(window, R), and only slots below T exist)
//
// q bf16 [B, S, H, D]; k, v bf16 or int8 [B, KVH, T, D] (one layer's view
// of the stacked [L, B, KVH, T, D] cache, given by its batch and head
// strides); for int8, k and v scales f32 [B, KVH, T] (a layer's view of
// [L, B, KVH, T], by their batch and head strides): k[t] stands for
// k_int8[t] * k_scale[t]. positions int32 [B, S]; out bf16 [B, S, H, D].
//
// What bounds it on the H100: the bytes of K and V the rows see, from the
// lowest first visible key to max(p) (plus 8 bytes of scales a key for
// int8, q and out), at 3.35 TB/s: ~17 MB a call at Mistral-7B's window of
// 4096, 5 us. The TPU's sequential T grid axis walked by B * KVH = 8 blocks
// one tile after another is latency, not bytes.
//
// Design: the tensor-core body of attn_mma.cuh. The S * group query rows
// (4 at S = 1 and 20 at S = 5 for Mistral) go through one m16 fragment a
// warp together, so a verify costs about what a draft call does; and the
// keys are split at fixed absolute positions (mma::SPLIT = 256 keys, the
// same for every S and T, so a row's bits do not depend on them) into
// grid.z = nsplit blocks a (b, kv head, row block): ~17 a row at a window
// of 4096, 136 blocks over Mistral's 8 KV heads. The partials go to a
// workspace and the last block to finish combines them (one launch, the
// ticket counter resets itself). nsplit = 1 writes the rows directly.

#include "attn_mma.cuh"

// Requires D in {64, 96, 128, 256}, H % KVH == 0, contiguous q / out / positions
// and unit-stride [T, D] planes in k and v (checked in Python). softcap,
// window and ring: 0 turns them off; a ring needs a window and at least 64
// slots (a tile). nsplit > 1: ws holds B * KVH * row blocks * nsplit * 64 *
// (D + 2) floats, counters B * KVH * row blocks zeros (left zero).
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v, const void* pos,
                                 void* out, void* ws, void* counters, int B, int S, int H,
                                 int KVH, int T, int D, long long stride_kb, long long stride_kh,
                                 float scale, float softcap, int window, int ring, int nsplit,
                                 void* stream) {
  if (nsplit < 1) return (int)cudaErrorInvalidValue;
  return mma::launch_any<__nv_bfloat16>(
      q, k, v, nullptr, nullptr, pos, out, static_cast<float*>(ws),
      static_cast<unsigned*>(counters), B, S, H, KVH, T, D, stride_kb, stride_kh, 0, 0,
      {scale, softcap, window, ring}, nsplit, stream);
}

// The int8 cache: k, v int8 with the bf16 entry's strides (in bytes =
// elements); k_scale, v_scale f32 [B, KVH, T] planes with unit stride along
// T and equal batch and head strides (checked in Python).
extern "C" int flash_decode_int8(const void* q, const void* k, const void* v, const void* k_scale,
                                 const void* v_scale, const void* pos, void* out, void* ws,
                                 void* counters, int B, int S, int H, int KVH, int T, int D,
                                 long long stride_kb, long long stride_kh, long long stride_sb,
                                 long long stride_sh, float scale, float softcap, int window,
                                 int ring, int nsplit, void* stream) {
  if (nsplit < 1) return (int)cudaErrorInvalidValue;
  return mma::launch_any<int8_t>(q, k, v, k_scale, v_scale, pos, out, static_cast<float*>(ws),
                                 static_cast<unsigned*>(counters), B, S, H, KVH, T, D, stride_kb,
                                 stride_kh, stride_sb, stride_sh, {scale, softcap, window, ring},
                                 nsplit, stream);
}
