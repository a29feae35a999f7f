// Pieces shared by kernels D (add_ln.cu) and D' (add_ln_bwd.cu), the fused
// residual-add + LayerNorm of the prenorm block on bfloat16 (N, d) rows.
//
// One warp owns a row. Each lane holds d / 32 values as NC chunks of V = 8
// (d a multiple of 256: one 16-byte load per tensor per chunk), 4 (d = 128)
// or 2 (d = 64) consecutive bf16, so every access is a full, coalesced
// vector; the row's sums are warp shuffles in float32 (mean first, then the
// centred variance, as the TPU kernel's _row_stats).
#pragma once

#include "bf16_io.cuh"

namespace add_ln {

using bf16 = __nv_bfloat16;
using bf16_io::load_vec;
using bf16_io::store_vec;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // rows per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Column of element 0 of chunk c for this lane.
template <int V>
__device__ __forceinline__ int col_of(int c, int lane) {
  return c * 32 * V + lane * V;
}

// mean and rstd of the row held in x (NC chunks of V values per lane).
template <int V, int NC>
__device__ __forceinline__ void row_stats(const float (&x)[NC][V], float eps, float& mean,
                                          float& rstd) {
  constexpr float kInvD = 1.f / (NC * 32 * V);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < V; ++i) s += x[c][i];
  mean = warp_sum(s) * kInvD;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xc = x[c][i] - mean;
      q += xc * xc;
    }
  rstd = rsqrtf(warp_sum(q) * kInvD + eps);
}

}  // namespace add_ln

// The widths kernels D and D' take: d = 64, 128, 256, 512, 768 or 1024,
// as CALL(V, NC); any other d returns cudaErrorInvalidValue.
#define ADD_LN_DISPATCH(d, CALL)                      \
  switch (d) {                                        \
    case 64:                                          \
      return CALL(2, 1);                              \
    case 128:                                         \
      return CALL(4, 1);                              \
    case 256:                                         \
      return CALL(8, 1);                              \
    case 512:                                         \
      return CALL(8, 2);                              \
    case 768:                                         \
      return CALL(8, 3);                              \
    case 1024:                                        \
      return CALL(8, 4);                              \
    default:                                          \
      return static_cast<int>(cudaErrorInvalidValue); \
  }
