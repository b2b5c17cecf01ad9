// Online-softmax GQA attention for prefill-length query blocks over a
// contiguous bf16 or int8 KV cache, for Hopper (kernel E).
//
// Replaces: llm_inference_lab_tpu/ops/pallas/flash_prefill.py
//           flash_prefill_attention (_body: query-block grid axis, causal
//           and window tile skip), chain-mask variants: mask kv_pos <= p, a
//           bf16 cache (_kernel) and an int8 cache with per-row scales
//           (_kernel_quant), with the options scale, softcap and window;
//           and the rolling-buffer cache's ring_len, which the Pallas
//           prefill lacks (JAX sends ring prefill chunks to attend_xla's
//           ring branch, ops/attention.py): the function of that branch.
//
// The function of flash_decode.cu, for S > 32: q bf16 [B, S, H, D]; k, v
// bf16 or int8 [B, KVH, T, D] (a layer's view of the stacked cache, through
// its batch and head strides), for int8 with k and v scales f32 [B, KVH, T];
// positions int32 [B, S], which need not start at 0 (a chunk may resume at
// any base) and may be -1 (a dead row, zeros out); out bf16 [B, S, H, D].
// An admission wave prefills into an int8 scratch cache through this kernel,
// so its rows have the same bits as Engine.generate's prompt prefill.
//
// What bounds it on the H100: the larger of the bytes (q, out, and K and V
// up to the largest position) at 3.35 TB/s and the operations (4 * D per
// visible key, per query row and head) at the bf16 tensor-core peak, 989
// TFLOP/s. At the serving admission's shapes (P = 256, 3B geometry) the
// bytes bound it; from S of about 1.5k on, the operations (a Mistral ring
// chunk of 512 rows over a full window: 34.4 GFLOP, 35 us).
//
// Design: the tensor-core body of attn_mma.cuh (mma.sync m16n8k16 bf16
// with f32 accumulate, ldmatrix, K/V tiles of 64 keys double-buffered with
// cp.async; 32 keys at head dim 256). One block per (b, kv head, 64 query
// rows) with the GQA group folded into the rows: 256 blocks for a 512-row
// Mistral chunk. Tiles sit at absolute key positions and a tile a row does
// not see leaves it exactly unchanged, so a row's bits never depend on S,
// on the rows beside it, or on T beyond its position: admission (scratch
// T = P) and Engine.generate (T = max_len) prefill the same bits, and a
// chunk's rows equal the same rows of the whole prompt. wgmma and TMA are
// later work.

#include "attn_mma.cuh"

// Requires D in {64, 96, 128, 256}, H % KVH == 0, contiguous q / out / positions
// and unit-stride [T, D] planes in k and v (checked in Python); the options
// of flash_decode_bf16.
extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v, const void* pos,
                                  void* out, int B, int S, int H, int KVH, int T, int D,
                                  long long stride_kb, long long stride_kh, float scale,
                                  float softcap, int window, int ring, void* stream) {
  return mma::launch_any<__nv_bfloat16>(q, k, v, nullptr, nullptr, pos, out, nullptr, nullptr,
                                        B, S, H, KVH, T, D, stride_kb, stride_kh, 0, 0,
                                        {scale, softcap, window, ring}, 0, stream);
}

// The int8 cache, with the arguments of flash_decode_int8 but the workspace.
extern "C" int flash_prefill_int8(const void* q, const void* k, const void* v,
                                  const void* k_scale, const void* v_scale, const void* pos,
                                  void* out, int B, int S, int H, int KVH, int T, int D,
                                  long long stride_kb, long long stride_kh, long long stride_sb,
                                  long long stride_sh, float scale, float softcap, int window,
                                  int ring, void* stream) {
  return mma::launch_any<int8_t>(q, k, v, k_scale, v_scale, pos, out, nullptr, nullptr, B, S, H,
                                 KVH, T, D, stride_kb, stride_kh, stride_sb, stride_sh,
                                 {scale, softcap, window, ring}, 0, stream);
}
