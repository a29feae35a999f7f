// Kernel A4: the fused Hyena front end writing the 4-D conv layout, for
// Hopper.
//
// Kernel A's math (fused_front_common.cuh): proj = u @ W + bp, the causal
// k=3 depthwise conv with bias, vx = v * x1 and x0, at kernel A's two
// widths (u (B, L, di), W (di, 3 dc); a tensor-parallel rank's dc = d / M).
// The outputs are (B, dc, rows_pad, m), which is the padded flat (B, dc, lp) with
// lp = rows_pad * m >= L: times t < L hold the results and every t in
// [L, lp) is zero, the causal FFT's zero padding written once at the source.
// The 4-D conv entries (ops/fused_fftconv.py::fftconv_outer_fwd4) read it as
// it is.
//
// Replaces hyena_dna_tpu/ops/pallas_hyena.py::fused_proj_conv_gate4
// (_kernel4 / _fwd_pallas4), the front end of the JAX HYENA_FRONT4 route.
//
// What bounds it on the H100: as kernel A (the bytes, the tensor cores
// doing the projection) over the L real times, plus 2 * (lp - L) * d zero
// stores (5% more output bytes at L = 1,000,448, lp = 2^20; 16% at L =
// 450,048, lp = 2^19).
//
// Design: kernel A's tile body (both types of u) with the output row stride
// a parameter and the grid covering lp. The TPU kernel emitted (rows, m) blocks of 8 rows and
// revisited them across grid steps, a constraint of its vector memory;
// here the 4-D array is the flat padded array, so a tile writes its times
// at stride lp and needs no regrouping. Tiles past L only store zeros.
#define FRONT_NS front4_fwd
#include "fused_front_common.cuh"

// u (B, L, di), vx and x0 (B, dc, lp) float32, W (di, 3 dc) and the
// parameters float32, all contiguous device memory: di == dc == d in the
// whole model, dc = d / M on a rank of a model axis of M (its channels of
// each chunk); ws as hyena_fused_front_fwd's. Launches on `stream`, does
// not synchronise; returns the cudaError_t of the launches.
extern "C" int hyena_fused_front4_fwd(const float* u, const float* w, const float* bp,
                                      const float* wc, const float* bc, float* vx, float* x0,
                                      __nv_bfloat16* ws, int B, int L, int lp, int di, int dc,
                                      cudaStream_t stream) {
  return FRONT_NS::launch(u, w, bp, wc, bc, vx, x0, ws, B, L, lp, di, dc, stream);
}

// As hyena_fused_front4_fwd with u, vx and x0 bfloat16.
extern "C" int hyena_fused_front4_fwd_bf16(const __nv_bfloat16* u, const float* w,
                                           const float* bp, const float* wc, const float* bc,
                                           __nv_bfloat16* vx, __nv_bfloat16* x0,
                                           __nv_bfloat16* ws, int B, int L, int lp, int di,
                                           int dc, cudaStream_t stream) {
  return FRONT_NS::launch(u, w, bp, wc, bc, vx, x0, ws, B, L, lp, di, dc, stream);
}

// bf16 values of the split-W scratch `ws` the entries take at widths
// (di, dc) (-1 if it exceeds an int): kernel A's helper.
extern "C" int hyena_front_ws_numel(int di, int dc) { return FRONT_NS::tc::ws_numel(di, dc); }
