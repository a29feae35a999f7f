// Kernel A': backward of the fused Hyena front end (kernel A), for Hopper.
//
// From the cotangents dvx, dx0 (B, dc, L) of kernel A's outputs, emits du
// (B, L, di), dW (di, 3 dc) and the bias and tap gradients dbp, dwc, dbc
// (the math and the design are in fused_front_bwd_common.cuh, shared with
// kernel A4'). di == dc == d in the whole model; on a tensor-parallel rank
// dc = d / M and du is the rank's partial sum.
//
// Replaces hyena_dna_tpu/ops/pallas_hyena.py::_bwd_pallas (_bwd_kernel /
// _bwd_body, wired in _fpcg_bwd), the backward of every order-2 Hyena layer.
//
// What bounds it on the H100: three matrix products of 2 * B * L * d * 3d
// flops each (the projection recompute, du and dW; 154.6 GFLOP at B=4,
// L=32768, d=256), 0.16 ms at the tensor cores' 989 TFLOP/s, against 8
// (bf16) or 16 (float32) bytes of input and output per (t, channel). The
// passes issue the projection twice (once per pass) and every product as
// two or three bf16 pair products (bf16 u about 460 GFLOP, float32 u about
// 620), and keep dproj out of device memory.
#define FRONT_NS front_bwd
#include "fused_front_bwd_common.cuh"

// u (B, L, di), dvx and dx0 (B, dc, L), outputs du (B, L, di) float32;
// w (di, 3 dc), bp (3 dc), wc (3, 3 dc), bc (3 dc), outputs dw (di, 3 dc)
// and dparams (5, 3 dc) = [dbp; dwc[0..2]; dbc] float32; all contiguous
// device memory. Scratch: ws (hyena_front_ws_numel(di, dc) bf16), part
// (runs * 5 * 3 dc) and dwpart (runs * di * 3 dc) float32; runs: the dW
// pass's split of the B * ceil(L / 60) time tiles, hyena_front_bwd_runs(B,
// L, di, dc) (any other is refused). Launches on `stream`, does not
// synchronise; returns the cudaError_t of the launches (0 on success).
extern "C" int hyena_fused_front_bwd(const float* u, const float* w, const float* bp,
                                     const float* wc, const float* bc, const float* dvx,
                                     const float* dx0, float* du, float* dw, float* dparams,
                                     __nv_bfloat16* ws, float* part, float* dwpart, int B, int L,
                                     int di, int dc, int runs, cudaStream_t stream) {
  return FRONT_NS::launch(u, w, bp, wc, bc, dvx, dx0, du, dw, dparams, ws, part, dwpart, B, L,
                          L, di, dc, runs, stream);
}

// As hyena_fused_front_bwd with u, dvx, dx0 and du bfloat16.
extern "C" int hyena_fused_front_bwd_bf16(const __nv_bfloat16* u, const float* w,
                                          const float* bp, const float* wc, const float* bc,
                                          const __nv_bfloat16* dvx, const __nv_bfloat16* dx0,
                                          __nv_bfloat16* du, float* dw, float* dparams,
                                          __nv_bfloat16* ws, float* part, float* dwpart, int B,
                                          int L, int di, int dc, int runs, cudaStream_t stream) {
  return FRONT_NS::launch(u, w, bp, wc, bc, dvx, dx0, du, dw, dparams, ws, part, dwpart, B, L, L,
                          di, dc, runs, stream);
}

// bf16 values of the split-W scratch `ws` the entries take at widths
// (di, dc) (-1 if it exceeds an int); the wrapper sizes the scratch by it.
extern "C" int hyena_front_ws_numel(int di, int dc) { return FRONT_NS::tc::ws_numel(di, dc); }

// The run count `runs` the entries take at (B, L, di, dc), either type; the
// wrapper sizes part and dwpart by it.
extern "C" int hyena_front_bwd_runs(int B, int L, int di, int dc) {
  return FRONT_NS::bwd_runs(B, L, di, dc);
}
