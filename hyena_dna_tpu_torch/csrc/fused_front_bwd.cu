// Kernel A': backward of the fused Hyena front end (kernel A), for Hopper.
//
// From the cotangents dvx, dx0 (B, d, L) of kernel A's outputs, emits du
// (B, L, d), dW (d, 3d) and the bias and tap gradients dbp, dwc, dbc (the
// math and the design are in fused_front_bwd_common.cuh, shared with kernel
// A4').
//
// Replaces hyena_dna_tpu/ops/pallas_hyena.py::_bwd_pallas (_bwd_kernel /
// _bwd_body, wired in _fpcg_bwd), the backward of every order-2 Hyena layer.
//
// What bounds it on the H100: three float32 matrix products of 2 * B * L *
// d * 3d flops each (the projection recompute, du and dW; 154.6 GFLOP at
// B=4, L=32768, d=256, about 2.3 ms at the card's 67 TFLOP/s on the CUDA
// cores) against about 16 bytes of input and output per (t, channel); with
// bf16 inputs the tensor cores' bound (0.16 ms at 989 TFLOP/s) is the
// least time, which this kernel's CUDA-core SGEMMs do not approach.
#define FRONT_NS front_bwd
#include "fused_front_bwd_common.cuh"

// All pointers to contiguous float32 device memory: u (B, L, d), w (d, 3d),
// bp (3d), wc (3, 3d), bc (3d), dvx and dx0 (B, d, L); outputs du (B, L, d),
// dw (d, 3d) and dparams (5, 3d) = [dbp; dwc[0..2]; dbc]. Scratch: dproj
// (B * L * 3d), part (B * tiles * 5 * 3d) with tiles = ceil(L / 60), dwpart
// (slices * d * 3d). Launches on `stream`, does not synchronise; returns
// the cudaError_t of the launches (0 on success).
extern "C" int hyena_fused_front_bwd(const float* u, const float* w, const float* bp,
                                     const float* wc, const float* bc, const float* dvx,
                                     const float* dx0, float* du, float* dw, float* dparams,
                                     float* dproj, float* part, float* dwpart, int B, int L,
                                     int d, int tiles, int slices, cudaStream_t stream) {
  return FRONT_NS::launch(u, w, bp, wc, bc, dvx, dx0, du, dw, dparams, dproj, part,
                                 dwpart, B, L, L, d, tiles, slices, stream);
}

// As hyena_fused_front_bwd with u, dvx, dx0 and du bfloat16; the rest float32.
extern "C" int hyena_fused_front_bwd_bf16(const __nv_bfloat16* u, const float* w,
                                          const float* bp, const float* wc, const float* bc,
                                          const __nv_bfloat16* dvx, const __nv_bfloat16* dx0,
                                          __nv_bfloat16* du, float* dw, float* dparams,
                                          float* dproj, float* part, float* dwpart, int B,
                                          int L, int d, int tiles, int slices,
                                          cudaStream_t stream) {
  return FRONT_NS::launch(u, w, bp, wc, bc, dvx, dx0, du, dw, dparams, dproj, part,
                                 dwpart, B, L, L, d, tiles, slices, stream);
}
