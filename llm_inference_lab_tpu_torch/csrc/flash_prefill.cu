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
// TFLOP/s. At the serving admission's shapes (P = 256, 3B geometry: 0.4
// GFLOP against 4.2 MB, ~100 flops per byte, below the ridge of ~295) the
// bytes bound it; from S of about 1.5k on, the operations. This first
// kernel runs the arithmetic on CUDA cores in f32 and is far from either;
// tensor cores (wgmma), TMA and wider tiles are later work.
//
// Design (right first, then fast):
//  * One block per (b, kv head, QB-position query block): QB * group rows,
//    all group heads of the kv head, on 2 * group warps of attn::RPW<D> rows
//    each (group <= 4: 256 threads; QB = 32 at D <= 128, 16 at D = 256,
//    where a warp holds 8 rows). q rows sit in dynamic shared memory.
//  * The body of attn_tile.cuh: the block walks 32-key tiles from its lowest
//    first visible key to its largest position, and each row works only on
//    the tiles between its own first visible key and its position. That is
//    the causal (and window) tile skip, done per row: a row's bits never
//    depend on S, on the rows beside it, or on T beyond its position, so
//    admission (scratch T = P) and Engine.generate (T = max_len) prefill
//    the same bits, and they equal kernel D's for the same row.
//  * S and T need not be multiples of 32: rows past S are not written and
//    keys past T are never read.

#include "attn_tile.cuh"

namespace {

constexpr int MAX_GROUP = 4;  // 2 * group warps of attn::RPW<D> rows each

template <int D>
constexpr int QB = 2 * attn::RPW<D>;  // query positions per block

template <int D, class T, bool RING>
__global__ void __launch_bounds__(2 * MAX_GROUP * 32)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ ks,
                     const float* __restrict__ vs, const int* __restrict__ pos,
                     __nv_bfloat16* __restrict__ out, int S, int H, int KVH, int Tk,
                     long long stride_kb, long long stride_kh, long long stride_sb,
                     long long stride_sh, attn::Options opt) {
  extern __shared__ __align__(16) unsigned char qs_raw[];  // [QB<D> * group, D] bf16
  __shared__ __align__(16) attn::Tile<D, T> tile;
  __shared__ int kmax_s, kmin_s;
  const int b = blockIdx.x / KVH, h = blockIdx.x % KVH;
  const int group = H / KVH;
  const size_t kv = b * stride_kb + h * stride_kh, sc = b * stride_sb + h * stride_sh;
  const attn::PlaneKeys<D, T, RING> keys{k + kv, v + kv, ks + sc, vs + sc};
  attn::attend_rows<D, T>(q, pos, out, keys, b, h, S, H, KVH, blockIdx.y * QB<D> * group, Tk,
                          opt, reinterpret_cast<__nv_bfloat16*>(qs_raw), tile, kmax_s, kmin_s);
}

template <int D, class T>
int launch_d(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             const void* pos, void* out, int B, int S, int H, int KVH, int Tk,
             long long stride_kb, long long stride_kh, long long stride_sb, long long stride_sh,
             attn::Options opt, cudaStream_t st) {
  const int group = H / KVH;
  const size_t smem = (size_t)QB<D> * group * D * sizeof(__nv_bfloat16);
  // With the static tile, D = 128 at group 4 and D = 256 at group 2 need
  // more than the default 48 KB a block may take: allow the largest group's.
  constexpr size_t most = (size_t)QB<D> * MAX_GROUP * D * 2;
  constexpr size_t stat = sizeof(attn::Tile<D, T>) + 2 * sizeof(int);
  static const cudaError_t shared_ok[2] = {
      attn::allow_shared(flash_prefill_kernel<D, T, false>, most, stat),
      attn::allow_shared(flash_prefill_kernel<D, T, true>, most, stat)};
  if (shared_ok[opt.ring > 0] != cudaSuccess) return (int)shared_ok[opt.ring > 0];
  dim3 grid(B * KVH, (S + QB<D> - 1) / QB<D>);
  dim3 block(2 * group * 32);
  const auto kernel =
      opt.ring > 0 ? flash_prefill_kernel<D, T, true> : flash_prefill_kernel<D, T, false>;
  kernel<<<grid, block, smem, st>>>(
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
  if (H % KVH || H / KVH > MAX_GROUP) return (int)cudaErrorInvalidValue;
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

// Requires D in {64, 128, 256}, H % KVH == 0 with H / KVH <= 4, contiguous
// q / out / positions and unit-stride [T, D] planes in k and v (checked in
// Python); the options of flash_decode_bf16.
extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v, const void* pos,
                                  void* out, int B, int S, int H, int KVH, int T, int D,
                                  long long stride_kb, long long stride_kh, float scale,
                                  float softcap, int window, int ring, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, nullptr, nullptr, pos, out, B, S, H, KVH, T, D,
                               stride_kb, stride_kh, 0, 0, {scale, softcap, window, ring},
                               stream);
}

// The int8 cache, with the arguments of flash_decode_int8.
extern "C" int flash_prefill_int8(const void* q, const void* k, const void* v,
                                  const void* k_scale, const void* v_scale, const void* pos,
                                  void* out, int B, int S, int H, int KVH, int T, int D,
                                  long long stride_kb, long long stride_kh, long long stride_sb,
                                  long long stride_sh, float scale, float softcap, int window,
                                  int ring, void* stream) {
  return launch<int8_t>(q, k, v, k_scale, v_scale, pos, out, B, S, H, KVH, T, D, stride_kb,
                        stride_kh, stride_sb, stride_sh, {scale, softcap, window, ring},
                        stream);
}
