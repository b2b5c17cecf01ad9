// Online-softmax GQA attention over a contiguous bf16 or int8 KV cache, for
// Hopper (kernel D).
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
// f32 m / l / accumulator.
//
// What bounds it on the H100: the bytes of K and V the rows see, from the
// lowest first visible key to max(p) (plus 8 bytes of scales a key for
// int8, q and out), at 3.35 TB/s. At decode that is well under a megabyte
// per call at the Llama shapes and ~37 MB at Gemma-2 9B's 4480-key cache,
// so launch latency and the
// per-block load latency of the few (b, kv-head) blocks dominate; no tensor
// cores are needed. An int8 cache halves the bytes, which does not move a
// latency-bound call.
//
// Design (simple first): the block body of attn_tile.cuh with 4 warps, so
// a block owns one (b, kv head) and 64 query rows (32 at D = 256); grid.y
// covers more rows (S = 1 draft, S = K+1 verify; S > 32 goes to
// flash_prefill.cu). The TPU's sequential T grid axis becomes the body's
// loop over 32-key tiles, from the block's lowest first visible key (the
// window) to its largest position. The same body reads pages in
// paged_flash.cu, which therefore gives the same bits on the same keys. q
// rows sit in dynamic shared memory: at D = 256 they and the bf16 tile pass
// the default 48 KB.

#include "attn_tile.cuh"

namespace {

constexpr int WARPS = 4;

template <int D>
constexpr int ROWS = WARPS * attn::RPW<D>;  // query rows per block

template <int D, class T, bool RING>
__global__ void __launch_bounds__(WARPS * 32)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ pos,
                    __nv_bfloat16* __restrict__ out, int S, int H, int KVH, int Tk,
                    long long stride_kb, long long stride_kh, long long stride_sb,
                    long long stride_sh, attn::Options opt) {
  extern __shared__ __align__(16) unsigned char qs_raw[];  // [ROWS<D>, D] bf16
  __shared__ __align__(16) attn::Tile<D, T> tile;
  __shared__ int kmax_s, kmin_s;
  const int b = blockIdx.x / KVH, h = blockIdx.x % KVH;
  const size_t kv = b * stride_kb + h * stride_kh, sc = b * stride_sb + h * stride_sh;
  const attn::PlaneKeys<D, T, RING> keys{k + kv, v + kv, ks + sc, vs + sc};
  attn::attend_rows<D, T>(q, pos, out, keys, b, h, S, H, KVH, blockIdx.y * ROWS<D>, Tk, opt,
                          reinterpret_cast<__nv_bfloat16*>(qs_raw), tile, kmax_s, kmin_s);
}

template <int D, class T>
int launch_d(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             const void* pos, void* out, int B, int S, int H, int KVH, int Tk,
             long long stride_kb, long long stride_kh, long long stride_sb, long long stride_sh,
             attn::Options opt, cudaStream_t st) {
  constexpr size_t smem = (size_t)ROWS<D> * D * sizeof(__nv_bfloat16);
  constexpr size_t stat = sizeof(attn::Tile<D, T>) + 2 * sizeof(int);
  static const cudaError_t shared_ok[2] = {
      attn::allow_shared(flash_decode_kernel<D, T, false>, smem, stat),
      attn::allow_shared(flash_decode_kernel<D, T, true>, smem, stat)};
  if (shared_ok[opt.ring > 0] != cudaSuccess) return (int)shared_ok[opt.ring > 0];
  const int nrows = S * (H / KVH);
  dim3 grid(B * KVH, (nrows + ROWS<D> - 1) / ROWS<D>);
  const auto kernel =
      opt.ring > 0 ? flash_decode_kernel<D, T, true> : flash_decode_kernel<D, T, false>;
  kernel<<<grid, WARPS * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs), static_cast<const int*>(pos),
      static_cast<__nv_bfloat16*>(out), S, H, KVH, Tk, stride_kb, stride_kh, stride_sb,
      stride_sh, opt);
  return (int)cudaGetLastError();
}

template <class T>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* pos, void* out, int B, int S, int H, int KVH, int Tk, int D,
           long long stride_kb, long long stride_kh, long long stride_sb, long long stride_sh,
           attn::Options opt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // A ring needs a window, and no shorter than a tile.
  if (opt.ring > 0 && (opt.window <= 0 || opt.ring < attn::BT)) return (int)cudaErrorInvalidValue;
  if (D == 128)
    return launch_d<128, T>(q, k, v, ks, vs, pos, out, B, S, H, KVH, Tk, stride_kb, stride_kh,
                            stride_sb, stride_sh, opt, st);
  if (D == 64)
    return launch_d<64, T>(q, k, v, ks, vs, pos, out, B, S, H, KVH, Tk, stride_kb, stride_kh,
                           stride_sb, stride_sh, opt, st);
  if (D == 256)
    return launch_d<256, T>(q, k, v, ks, vs, pos, out, B, S, H, KVH, Tk, stride_kb, stride_kh,
                            stride_sb, stride_sh, opt, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Requires D in {64, 128, 256}, H % KVH == 0, contiguous q / out / positions
// and unit-stride [T, D] planes in k and v (checked in Python). softcap,
// window and ring: 0 turns them off; a ring needs a window and at least 32
// slots (a tile).
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v, const void* pos,
                                 void* out, int B, int S, int H, int KVH, int T, int D,
                                 long long stride_kb, long long stride_kh, float scale,
                                 float softcap, int window, int ring, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, nullptr, nullptr, pos, out, B, S, H, KVH, T, D,
                               stride_kb, stride_kh, 0, 0, {scale, softcap, window, ring},
                               stream);
}

// The int8 cache: k, v int8 with the bf16 entry's strides (in bytes =
// elements); k_scale, v_scale f32 [B, KVH, T] planes with unit stride along
// T and equal batch and head strides (checked in Python).
extern "C" int flash_decode_int8(const void* q, const void* k, const void* v, const void* k_scale,
                                 const void* v_scale, const void* pos, void* out, int B, int S,
                                 int H, int KVH, int T, int D, long long stride_kb,
                                 long long stride_kh, long long stride_sb, long long stride_sh,
                                 float scale, float softcap, int window, int ring,
                                 void* stream) {
  return launch<int8_t>(q, k, v, k_scale, v_scale, pos, out, B, S, H, KVH, T, D, stride_kb,
                        stride_kh, stride_sb, stride_sh, {scale, softcap, window, ring},
                        stream);
}
