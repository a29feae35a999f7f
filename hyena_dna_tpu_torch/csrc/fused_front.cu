// Kernel A: the fused Hyena front end, for Hopper.
//
//   proj = u @ W + bp                                   (B, L, 3d), float32
//   conv = causal depthwise k=3 conv of proj over time, zero left padding,
//          plus the conv bias bc                        (taps wc, time-major)
//   [x0 | x1 | v] = conv split along channels
//   vx = v * x1, x0                                     both (B, d, L)
//
// u (B, L, d), vx and x0 are float32, or all three bfloat16 (the bf16
// model: vx and x0 in u's dtype, as the Pallas kernel's out_dtype =
// u.dtype); W (d, 3d), bp (3d), wc (3, 3d) with wc[j] multiplying
// proj[t - 2 + j] and bc (3d) are float32. The arithmetic is float32 either
// way: bf16 u is widened on load, so proj stays float32 and vx, x0 are
// rounded once.
//
// Replaces hyena_dna_tpu/ops/pallas_hyena.py::fused_proj_conv_gate
// (_kernel / _fwd_pallas), the front end of every order-2 Hyena layer.
//
// What bounds it on the H100: the projection, 2 * L * d * 3d flops per batch
// row in float32 on the CUDA cores (about 0.8 ms at the card's 67 TFLOP/s
// for B=4, L=32768, d=256), against 16 bytes per (t, channel) of traffic
// (8 in bfloat16). With bf16 inputs the least time would be the tensor
// cores' (0.05 ms at 989 TFLOP/s); this kernel keeps the CUDA-core SGEMM.
//
// The tile body, its design notes and the launcher are in
// fused_front_common.cuh, shared with kernel A4 (fused_front4.cu).
#define FRONT_NS front_fwd
#include "fused_front_common.cuh"

// All pointers to contiguous float32 device memory. Launches on `stream`,
// does not synchronise; returns the cudaError_t of the launch.
extern "C" int hyena_fused_front_fwd(const float* u, const float* w, const float* bp,
                                     const float* wc, const float* bc, float* vx, float* x0,
                                     int B, int L, int d, cudaStream_t stream) {
  return FRONT_NS::launch(u, w, bp, wc, bc, vx, x0, B, L, L, d, stream);
}

// As hyena_fused_front_fwd with u, vx and x0 bfloat16; the parameters float32.
extern "C" int hyena_fused_front_fwd_bf16(const __nv_bfloat16* u, const float* w,
                                          const float* bp, const float* wc, const float* bc,
                                          __nv_bfloat16* vx, __nv_bfloat16* x0, int B, int L,
                                          int d, cudaStream_t stream) {
  return FRONT_NS::launch(u, w, bp, wc, bc, vx, x0, B, L, L, d, stream);
}
