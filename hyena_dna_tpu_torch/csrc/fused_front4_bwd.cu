// Kernel A4': backward of kernel A4 (the fused Hyena front end writing the
// 4-D conv layout), for Hopper.
//
// Kernel A''s math and passes (fused_front_bwd_common.cuh), with the
// cotangents dvx, dx0 read in A4's (B, d, rows_pad, m) layout, the padded
// flat (B, d, lp), over the real times t < L only: the tail [L, lp) of vx
// and x0 is a constant zero, so its cotangents carry nothing (the pad's
// VJP on the flat route drops them the same way). Emits du (B, L, d), dW
// and the bias and tap gradients.
//
// Replaces hyena_dna_tpu/ops/pallas_hyena.py::_bwd_pallas4 (_bwd_kernel4 /
// _bwd_body, wired in _fpcg4_bwd), the backward of the JAX HYENA_FRONT4
// route.
//
// What bounds it on the H100: as kernel A', three float32 CUDA-core matrix
// products of 2 * B * L * d * 3d flops each over the L real times.
//
// Design: kernel A''s passes with the cotangents' row stride a parameter.
// The TPU kernel fetched 8-row blocks of the (rows, m) layout and picked
// its rows with a select tree, a constraint of its vector memory; here the
// 4-D array is the flat padded array, read at stride lp, so nothing is
// regrouped and no pass touches the tail.
#define FRONT_NS front4_bwd
#include "fused_front_bwd_common.cuh"

// As hyena_fused_front_bwd (fused_front_bwd.cu) with dvx and dx0
// (B, d, lp), lp >= L; all pointers to contiguous float32 device memory.
extern "C" int hyena_fused_front4_bwd(const float* u, const float* w, const float* bp,
                                      const float* wc, const float* bc, const float* dvx,
                                      const float* dx0, float* du, float* dw, float* dparams,
                                      float* dproj, float* part, float* dwpart, int B, int L,
                                      int lp, int d, int tiles, int slices,
                                      cudaStream_t stream) {
  return FRONT_NS::launch(u, w, bp, wc, bc, dvx, dx0, du, dw, dparams, dproj, part,
                                 dwpart, B, L, lp, d, tiles, slices, stream);
}

// As hyena_fused_front4_bwd with u, dvx, dx0 and du bfloat16; the rest float32.
extern "C" int hyena_fused_front4_bwd_bf16(const __nv_bfloat16* u, const float* w,
                                           const float* bp, const float* wc, const float* bc,
                                           const __nv_bfloat16* dvx, const __nv_bfloat16* dx0,
                                           __nv_bfloat16* du, float* dw, float* dparams,
                                           float* dproj, float* part, float* dwpart, int B,
                                           int L, int lp, int d, int tiles, int slices,
                                           cudaStream_t stream) {
  return FRONT_NS::launch(u, w, bp, wc, bc, dvx, dx0, du, dw, dparams, dproj, part,
                                 dwpart, B, L, lp, d, tiles, slices, stream);
}
