// Kernel H: one layer's new K and V rows written into the KV cache, and
// quantized on the way for an int8 cache, in one launch, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: llm_inference_lab_tpu/models/base.py:200
// _quantize_rows, :210 scatter_stack_layer and :267 update_cache_layer, and
// models/paged.py:109 update_paged_layer, XLA scatters that XLA fuses into
// the layer on the TPU. The port ran the quantization and an
// advanced-index store as separate eager kernels, for K and then V.
//
// Computes, for each written row r (source row (b[r], s[r]) of k_new and
// v_new [B, S, KVH, D], read through their strides) and each KV head h:
//   a bf16 or f32 cache: dst[outer[r], h, slot[r], :] = x[b, s, h, :];
//   an int8 cache: amax = max_d |f32(x)|, scale = max(amax, 1e-8) / 127
//   (IEEE division), q = rint(f32(x) / scale) (IEEE division, half to
//   even) clipped to +-127, stored with its scale at [outer[r], h, slot[r]]:
//   JAX's _quantize_rows bit for bit.
// (outer, slot) is (b, position), clipped to T - 1, for a contiguous cache;
// (b, position mod R) for the ring; (b, position - t0) for a rank's slice
// of T; (page, offset) for a page pool. The wrapper's index arrays hold
// them, computed once a forward on the device (ops/kv_write.py).
//
// What bounds it on the H100: the rows' bytes, read once and written once
// (4 KB for the 3B's K and V of one decode row: far below a microsecond at
// 3.35 TB/s); at decode a call is its launch.
//
// Design: one warp a (row, K or V, head): the lanes read the head's D
// values with stride 32 (any source strides, a stride-0 broadcast too),
// take the amax with a shuffle reduction (a max is exact in any order),
// and read them again to quantize; lane 0 stores the scale. The division
// and the rounding are __fdiv_rn and rintf, named so that no compiler flag
// can change them. Rows that clip to one slot land in an unspecified order,
// as in JAX's scatter.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps, a (row, K or V, head) each

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

struct Side {
  const void* src;          // [B, S, KVH, D] through the strides below (elements)
  void* dst;                // a layer's [O, KVH, T, D], inner three dims contiguous
  float* scale;             // a layer's [O, KVH, T] scales (int8 only)
  long long sb, ss, sh, sd;
};

template <typename Src, bool INT8>
__global__ void __launch_bounds__(THREADS)
kv_write_kernel(Side k, Side v, const int* __restrict__ b, const int* __restrict__ s,
                const int* __restrict__ outer, const int* __restrict__ slot, int n, int KVH,
                int D, int T, long long dst_o, long long scale_o) {
  const int task = (int)((blockIdx.x * (size_t)THREADS + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (task >= n * 2 * KVH) return;
  const int h = task % KVH, side = (task / KVH) & 1, r = task / (2 * KVH);
  const Side p = side ? v : k;
  const Src* src = static_cast<const Src*>(p.src) + b[r] * p.sb + s[r] * p.ss + h * p.sh;
  const size_t row = (size_t)outer[r] * dst_o + ((size_t)h * T + slot[r]) * D;
  if constexpr (!INT8) {
    Src* dst = static_cast<Src*>(p.dst) + row;
    for (int d = lane; d < D; d += 32) dst[d] = src[d * p.sd];
  } else {
    float amax = 0.f;
    for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(to_f32(src[d * p.sd])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float sc = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
    int8_t* dst = static_cast<int8_t*>(p.dst) + row;
    for (int d = lane; d < D; d += 32) {
      const float qv = rintf(__fdiv_rn(to_f32(src[d * p.sd]), sc));
      dst[d] = (int8_t)fminf(fmaxf(qv, -127.f), 127.f);
    }
    if (lane == 0) p.scale[(size_t)outer[r] * scale_o + (size_t)h * T + slot[r]] = sc;
  }
}

template <typename Src, bool INT8>
int launch(const Side& k, const Side& v, const int* b, const int* s, const int* outer,
           const int* slot, int n, int KVH, int D, int T, long long dst_o, long long scale_o,
           cudaStream_t st) {
  const long long warps = (long long)n * 2 * KVH;
  const unsigned blocks = (unsigned)((warps * 32 + THREADS - 1) / THREADS);
  kv_write_kernel<Src, INT8><<<blocks, THREADS, 0, st>>>(k, v, b, s, outer, slot, n, KVH, D, T,
                                                         dst_o, scale_o);
  return (int)cudaGetLastError();
}

}  // namespace

// k_src, v_src: [B, S, KVH, D] bf16 (src_f32 0) or f32 (src_f32 1), each
// through its strides in elements (ks_* for K, vs_*); k_dst, v_dst: a
// layer's cache [O, KVH, T, D] of the source's type (dst_int8 0) or int8
// (dst_int8 1), the inner three dims contiguous and dst_o elements from one
// outer index to the next; k_scale, v_scale: a layer's f32 [O, KVH, T]
// scales (scale_o apart; int8 only, else null); b, s, outer, slot: int32
// [n]. Requires n, KVH, D, T >= 1 (checked here and by the Python wrapper).
extern "C" int kv_write(const void* k_src, const void* v_src, void* k_dst, void* v_dst,
                        void* k_scale, void* v_scale, const void* b, const void* s,
                        const void* outer, const void* slot, int n, int KVH, int D, int T,
                        long long ks_b, long long ks_s, long long ks_h, long long ks_d,
                        long long vs_b, long long vs_s, long long vs_h, long long vs_d,
                        long long dst_o, long long scale_o, int src_f32, int dst_int8,
                        void* stream) {
  if (n < 1 || KVH < 1 || D < 1 || T < 1 || (dst_int8 && (!k_scale || !v_scale)))
    return (int)cudaErrorInvalidValue;
  const Side k{k_src, k_dst, static_cast<float*>(k_scale), ks_b, ks_s, ks_h, ks_d};
  const Side v{v_src, v_dst, static_cast<float*>(v_scale), vs_b, vs_s, vs_h, vs_d};
  const int* ib = static_cast<const int*>(b);
  const int* is = static_cast<const int*>(s);
  const int* io = static_cast<const int*>(outer);
  const int* il = static_cast<const int*>(slot);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (src_f32) {
    return dst_int8 ? launch<float, true>(k, v, ib, is, io, il, n, KVH, D, T, dst_o, scale_o, st)
                    : launch<float, false>(k, v, ib, is, io, il, n, KVH, D, T, dst_o, scale_o, st);
  }
  return dst_int8
             ? launch<__nv_bfloat16, true>(k, v, ib, is, io, il, n, KVH, D, T, dst_o, scale_o, st)
             : launch<__nv_bfloat16, false>(k, v, ib, is, io, il, n, KVH, D, T, dst_o, scale_o,
                                           st);
}
