// Loads and stores of float32 or bfloat16 device memory as float32 values,
// shared by kernels A, A' (fused_front*.cu) and D, D' (add_ln*.cu). Every
// kernel computes in float32; a bfloat16 tensor is widened on load and
// rounded once, to nearest even, on store.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace bf16_io {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive bfloat16 values (V = 2, 4 or 8) as one 4-, 8- or 16-byte access.
template <int V>
struct Raw;
template <>
struct Raw<2> {
  using T = uint32_t;
};
template <>
struct Raw<4> {
  using T = uint2;
};
template <>
struct Raw<8> {
  using T = uint4;
};

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const typename Raw<V>::T raw = *reinterpret_cast<const typename Raw<V>::T*>(p);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* in) {
  typename Raw<V>::T raw;
  __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < V / 2; ++i) pairs[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<typename Raw<V>::T*>(p) = raw;
}

}  // namespace bf16_io
