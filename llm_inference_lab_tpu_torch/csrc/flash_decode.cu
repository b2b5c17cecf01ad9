// Online-softmax GQA attention over a contiguous bf16 or int8 KV cache, for
// Hopper (kernel D).
//
// Replaces: llm_inference_lab_tpu/ops/pallas/flash_decode.py
//           flash_decode_attention (tile body _accum_tile), chain-decode
//           variants: mask kv_pos <= p, scale D**-0.5, a bf16 cache (_kernel)
//           and an int8 cache with per-row scales (_kernel_quant). The
//           window, ring, softcap and scale-override options are not ported
//           yet.
//
//   out[b, s, h, :] = softmax_t(q[b,s,h] . k[b,h/g,t] * scale | t <= p[b,s]) @ v
//
// q bf16 [B, S, H, D]; k, v bf16 or int8 [B, KVH, T, D] (one layer's view
// of the stacked [L, B, KVH, T, D] cache, given by its batch and head
// strides); for int8, k and v scales f32 [B, KVH, T] (a layer's view of
// [L, B, KVH, T], by their batch and head strides): k[t] stands for
// k_int8[t] * k_scale[t]. positions int32 [B, S]; out bf16 [B, S, H, D].
// f32 m / l / accumulator.
//
// What bounds it on the H100: the bytes of K and V up to max(p) + 1 (plus
// 8 bytes of scales a key for int8, q and out), at 3.35 TB/s. At decode
// that is well under a megabyte per call, so launch latency and the
// per-block load latency of the few (b, kv-head) blocks dominate; no tensor
// cores are needed. An int8 cache halves the bytes, which does not move a
// latency-bound call.
//
// Design (simple first): the block body of attn_tile.cuh with 4 warps, so
// a block owns one (b, kv head) and 64 query rows; grid.y covers more rows
// (S = 1 draft, S = K+1 verify; S > 32 goes to flash_prefill.cu). The TPU's
// sequential T grid axis becomes the body's loop over 32-key tiles. The
// same body reads pages in paged_flash.cu, which therefore gives the same
// bits on the same keys.

#include "attn_tile.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int ROWS = WARPS * attn::RPW;  // query rows per block

template <int D, class T>
__global__ void __launch_bounds__(WARPS * 32)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ pos,
                    __nv_bfloat16* __restrict__ out, int S, int H, int KVH, int Tk,
                    long long stride_kb, long long stride_kh, long long stride_sb,
                    long long stride_sh, float scale) {
  __shared__ __align__(16) __nv_bfloat16 qs[ROWS * D];
  __shared__ __align__(16) attn::Tile<D, T> tile;
  __shared__ int kmax_s;
  const int b = blockIdx.x / KVH, h = blockIdx.x % KVH;
  const size_t kv = b * stride_kb + h * stride_kh, sc = b * stride_sb + h * stride_sh;
  const attn::PlaneKeys<D, T> keys{k + kv, v + kv, ks + sc, vs + sc};
  attn::attend_rows<D, T>(q, pos, out, keys, b, h, S, H, KVH, blockIdx.y * ROWS, Tk, scale, qs,
                          tile, kmax_s);
}

template <class T>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* pos, void* out, int B, int S, int H, int KVH, int Tk, int D,
           long long stride_kb, long long stride_kh, long long stride_sb, long long stride_sh,
           float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nrows = S * (H / KVH);
  dim3 grid(B * KVH, (nrows + ROWS - 1) / ROWS);
  dim3 block(WARPS * 32);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  const auto* ksp = static_cast<const float*>(ks);
  const auto* vsp = static_cast<const float*>(vs);
  const auto* pp = static_cast<const int*>(pos);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 128) {
    flash_decode_kernel<128, T><<<grid, block, 0, st>>>(qp, kp, vp, ksp, vsp, pp, op, S, H, KVH,
                                                        Tk, stride_kb, stride_kh, stride_sb,
                                                        stride_sh, scale);
  } else if (D == 64) {
    flash_decode_kernel<64, T><<<grid, block, 0, st>>>(qp, kp, vp, ksp, vsp, pp, op, S, H, KVH,
                                                       Tk, stride_kb, stride_kh, stride_sb,
                                                       stride_sh, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Requires D in {64, 128}, H % KVH == 0, contiguous q / out / positions and
// unit-stride [T, D] planes in k and v (checked in Python).
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v, const void* pos,
                                 void* out, int B, int S, int H, int KVH, int T, int D,
                                 long long stride_kb, long long stride_kh, float scale,
                                 void* stream) {
  return launch<__nv_bfloat16>(q, k, v, nullptr, nullptr, pos, out, B, S, H, KVH, T, D,
                               stride_kb, stride_kh, 0, 0, scale, stream);
}

// The int8 cache: k, v int8 with the bf16 entry's strides (in bytes =
// elements); k_scale, v_scale f32 [B, KVH, T] planes with unit stride along
// T and equal batch and head strides (checked in Python).
extern "C" int flash_decode_int8(const void* q, const void* k, const void* v, const void* k_scale,
                                 const void* v_scale, const void* pos, void* out, int B, int S,
                                 int H, int KVH, int T, int D, long long stride_kb,
                                 long long stride_kh, long long stride_sb, long long stride_sh,
                                 float scale, void* stream) {
  return launch<int8_t>(q, k, v, k_scale, v_scale, pos, out, B, S, H, KVH, T, D, stride_kb,
                        stride_kh, stride_sb, stride_sh, scale, stream);
}
