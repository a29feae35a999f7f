// Kernel E': backward of the gate-fused causal FFT conv (kernel E), for
// Hopper.
//
// For v = irfft(U K)[:L] + u D, y = v x0 and the cotangent dy, with
// dv = dy x0 (float32, never rounded):
//   dx0[b, c] = dy[b, c] * v[b, c]
//   du[b, c]  = irfft(DV[b, c] conj(K[c]), n)[:L] + dv[b, c] D[c]
//   dk[c]     = irfft(sum_b DV[b, c] conj(U[b, c]), n)[:Lk]
//   dD[c]     = sum_{b, t} dv u  (read off dk's lag 0 in float32, Parseval)
// U, K and DV are the size-n transforms of the zero-padded rows; du is a
// correlation, right because n >= 2L (kernel C's argument).
//
// u, x0, v, dy, k, du, dx0 and dk are float32 or bfloat16 (one type for
// all); D and dD float32; every transform, product and sum runs in float32.
//
// Replaces the gated backward Pallas kernels of the JAX package, one C
// entry point with three routes, as the JAX modes pick them:
//   route 0, specv (u's saved pair spectrum and the saved v):
//     hyena_dna_tpu/ops/pallas_fftconv.py:1796 fftconv_fused_bwd_specv_packed_gated
//   route 1, spec (u's saved pair spectrum; v recomputed):
//     hyena_dna_tpu/ops/pallas_fftconv.py:1662 fftconv_fused_bwd_spec_packed_gated
//   route 2, retransform (u itself; its spectrum and v recomputed):
//     hyena_dna_tpu/ops/pallas_fftconv.py:1932 fftconv_fused_bwd_packed_gated
//     (there the caller inverted dk's spectrum; here dk leaves in time, as
//     kernel C returns it).
//
// What bounds it on the H100: as kernel C, the float32 FFT arithmetic on
// the CUDA cores and the complex scratch between passes, which goes through
// device memory; no pass reaches the memory rate (utils/profile_passes.py
// splits a call by launch). Per real row pair: dv forward and du inverse
// (specv), plus v's inverse (spec), plus u's forward (retransform); per
// channel pair: k forward and dk inverse. The gate itself is elementwise
// work in the column passes' prologue and epilogues, a few reads of the I/O
// type.
//
// Design: kernel C's passes, its row pass itself (fft_grad_common.cuh), with
// the gate folded in:
//   k      cols_in_delta_kernel + rows_fwd_kernel into k's slab: the source
//          adds D at t = 0 (k + D delta), so the slab holds K + D on every
//          route (the TPU kernel's ks trick, pallas_fftconv.py:1430-1443),
//          which makes inv(U (K + D)) the whole v = conv + u D and
//          inv(DV conj(K + D)) the whole du = corr + dv D.
//   v      (spec, retransform) a row pass of its own, kernel B's
//          rows_conv_kernel: U's rows (read from the saved spectrum, or u's
//          column pass transformed there and stored back as a spectrum for
//          the dk sum) times K + D, inverse row FFT; then an inverse column
//          pass whose epilogue writes dx0 = dy v. Kept apart from the
//          gradient row pass, whose three buffers it would take a fourth.
//   dv     pass 1 whose source reads dy and x0 and transforms dv = dy x0 in
//          float32 (the TPU kernels round dv to their store type first);
//          on the specv route the same pass writes dx0 = dy v from the
//          saved v. Three blocks an SM, as C's forward column passes, its
//          reads batched four outputs at a time ahead of their stores
//          (fft_grad_common.cuh; PERF.md §6 has the variants measured).
//   du, dk kernel C's row pass (rows_grad_body) on dv's columns and U's
//          spectrum, with no D of its own (k's slab holds K + D): du's
//          rows back in dv's scratch, dk's (the batch sum in a fixed order
//          per block at B > 1, no atomics, the same bits every run; formed
//          in u's buffer beside K's rows at B = 1; at N2 = 4096 over a 2-CTA
//          cluster) back in k's slab; then kernel C's inverse column
//          passes: du's reads neither dy nor x0, dk's reads dD off lag 0.
// The gate's reads in the column passes (dy, x0, v in dv's source; dy in
// dx0's sink) are batched ahead of their stores (BatchedSourceIn,
// BatchedSinkOut).
// v's pass runs first and borrows dv's scratch, so the workspace is dv's
// scratch, u's (retransform only) and k's slab (hyena_fftconv_gated_bwd_ws_slabs).
#define FFT_NS conv_gbwd
#include "fft_grad_common.cuh"

namespace FFT_NS {

enum Route { kSpecV = 0, kSpec = 1, kRetransform = 2 };

// Pass 1 source (batched, fft_grad_common.cuh): dv = dy x0 in float32; with
// `v`, also writes dx0 = dy v.
template <typename T>
struct GateGradSource {
  struct In {
    float dy0, dy1, x0, x1, v0, v1;
  };
  const T* dy;
  const T* x0;
  const T* v;
  T* dx0;
  int64_t row0, len;
  bool has2;
  __device__ __forceinline__ void begin(int b, int c, int C, int len_, bool has2_) {
    row0 = (static_cast<int64_t>(b) * C + c) * len_;
    len = len_;
    has2 = has2_;
  }
  __device__ __forceinline__ In load(int t) const {
    const int64_t i = row0 + t, j = i + len;
    In in{to_f32(dy[i]), 0.f, to_f32(x0[i]), 0.f, 0.f, 0.f};
    if (has2) {
      in.dy1 = to_f32(dy[j]);
      in.x1 = to_f32(x0[j]);
    }
    if (v != nullptr) {
      in.v0 = to_f32(v[i]);
      if (has2) in.v1 = to_f32(v[j]);
    }
    return in;
  }
  __device__ __forceinline__ float2 value(int t, const In& in) const {
    if (v != nullptr) {
      const int64_t i = row0 + t;
      store(dx0 + i, in.dy0 * in.v0);
      if (has2) store(dx0 + i + len, in.dy1 * in.v1);
    }
    return make_float2(in.dy0 * in.x0, in.dy1 * in.x1);
  }
};

// Pass 3 sink (batched): v = value (the whole v, K + D in its product),
// dx0 = dy v.
template <typename T>
struct DxSink {
  using In = float2;  // dy of the pair's two channels
  const T* dy;
  T* dx0;
  int64_t row0, len;
  bool has2;
  __device__ __forceinline__ void begin(int b, int c, int C, int len_, bool has2_) {
    row0 = (static_cast<int64_t>(b) * C + c) * len_;
    len = len_;
    has2 = has2_;
  }
  __device__ __forceinline__ In load(int t) const {
    const int64_t i = row0 + t;
    return make_float2(to_f32(dy[i]), has2 ? to_f32(dy[i + len]) : 0.f);
  }
  __device__ __forceinline__ void store(int t, In g, float v0, float v1) const {
    const int64_t i = row0 + t;
    FFT_NS::store(dx0 + i, g.x * v0);
    if (has2) FFT_NS::store(dx0 + i + len, g.y * v1);
  }
};

// dv's column pass, under cols_in_kernel's bounds (three blocks an SM)
template <typename T, int kRadix>
__global__ void __launch_bounds__(256, 3) cols_in_dv_kernel(
    const T* __restrict__ dy, const T* __restrict__ x0, const T* __restrict__ v,
    T* __restrict__ dx0, int C, int len, Plan p, float2* __restrict__ out) {
  cols_fwd_body<kRadix, BatchedSourceIn>(GateGradSource<T>{dy, x0, v, dx0}, C, len, p, out);
}

template <typename T, int kRadix>
__global__ void __launch_bounds__(kMaxThreads) cols_inv_dx0_kernel(
    const float2* __restrict__ a, const T* __restrict__ dy, T* __restrict__ dx0, int C, int len,
    Plan p) {
  cols_inv_body<kRadix, BatchedSinkOut>(a, DxSink<T>{dy, dx0}, C, len, p);
}

// Complex64 slabs of n values in the workspace (see hyena_fftconv_gated_bwd).
inline int64_t ws_slabs(int B, int C, bool retransform) {
  return (static_cast<int64_t>(B) * (retransform ? 2 : 1) + 1) * ((C + 1) / 2);
}

template <typename T>
int launch_all(Route route, const T* u, const float2* uspec, const T* v, const T* dy, const T* x0,
               const T* k, const float* D, T* du, T* dx0, T* dk, float* dD, float2* ws, int B,
               int C, int L, int Lk, const Plan& p, cudaStream_t stream) {
  const int pairs = (C + 1) / 2;
  const int64_t batch_numel = static_cast<int64_t>(B) * pairs * p.n;
  float2* sdy = ws;
  float2* su = route == kRetransform ? sdy + batch_numel : nullptr;
  float2* kspec = (su != nullptr ? su : sdy) + batch_numel;
  const int wc = col_class(p), wr = row_class(p);
  const dim3 cols_c = cols_grid(p, pairs, 1), cols_b = cols_grid(p, pairs, B);
  const dim3 rows_b = pair_rows_grid(p, pairs, B);
  const int tc = cols_threads(p);
  const size_t sc = cols_smem_bytes(p), sr = rows_smem_bytes(p);
  auto rows_conv = [](auto w) { return rows_conv_kernel<decltype(w)::value>; };
  launch([](auto w) { return cols_in_delta_kernel<T, decltype(w)::value>; }, wc, cols_c, tc, sc,
         stream, k, D, C, Lk, p, kspec);
  launch([](auto w) { return rows_fwd_kernel<decltype(w)::value>; }, wr, rows_grid(p, pairs),
         rows_threads(p), sr, stream, kspec, p);
  const float2* gu = uspec;
  if (route != kSpecV) {  // v = inv(U (K + D)), dx0 = dy v; sdy is v's scratch here
    if (route == kRetransform) {
      launch([](auto w) { return cols_in_kernel<T, decltype(w)::value>; }, wc, cols_b, tc, sc,
             stream, u, C, L, p, su);
      launch(rows_conv, wr, rows_b, pair_threads(p), sr, stream, su, 0, kspec, su, sdy, p);
      gu = su;
    } else {
      launch(rows_conv, wr, rows_b, pair_threads(p), sr, stream, uspec, 1, kspec, nullptr, sdy,
             p);
    }
    launch([](auto w) { return cols_inv_dx0_kernel<T, decltype(w)::value>; }, wc, cols_b, tc, sc,
           stream, sdy, dy, dx0, C, L, p);
  }
  launch([](auto w) { return cols_in_dv_kernel<T, decltype(w)::value>; }, wc, cols_b, tc, sc,
         stream, dy, x0, route == kSpecV ? v : nullptr, dx0, C, L, p, sdy);
  // D null: k's slab already holds K + D. dk's rows go back into k's slab.
  launch_rows_grad(sdy, gu, kspec, nullptr, kspec, B, C, 1, p, stream);
  auto cols_inv = [](auto w) { return cols_inv_kernel<T, decltype(w)::value>; };
  launch(cols_inv, wc, cols_b, tc, sc, stream, sdy, nullptr, nullptr, du, nullptr, C, L, p);
  launch(cols_inv, wc, cols_c, tc, sc, stream, kspec, nullptr, nullptr, dk, dD, C, Lk, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace FFT_NS

// The workspace of hyena_fftconv_gated_bwd in complex64 slabs of n values
// (the wrapper allocates slabs * n * 8 bytes): dv's column pass (B slabs a
// channel pair), u's (B more) on the retransform route, and k's (one). -1
// for sizes or a route the kernel refuses.
extern "C" int hyena_fftconv_gated_bwd_ws_slabs(int B, int C, int route) {
  if (B < 1 || C < 1 || B > 65535 || (C + 1) / 2 > 65535 || route < 0 || route > 2) return -1;
  const int64_t slabs = FFT_NS::ws_slabs(B, C, route == FFT_NS::kRetransform);
  return slabs > 0x7fffffff ? -1 : static_cast<int>(slabs);
}

// dy, x0, du, dx0 (B, C, L), k, dk (C, Lk) contiguous, all float32
// (is_bf16 == 0) or all bfloat16; D, dD (C,) float32. route 0 (specv):
// uspec (kernel E's saved spectrum, B * ceil(C/2) * n complex64) and v
// (B, C, L) given, u null. route 1 (spec): uspec given, u and v null.
// route 2 (retransform): u (B, C, L) given, uspec and v null. ws holds
// `slabs` * n complex64, slabs = hyena_fftconv_gated_bwd_ws_slabs(B, C,
// route) (refused otherwise). Launches on `stream`, does not synchronise;
// returns the cudaError_t of the launches (0 on success).
extern "C" int hyena_fftconv_gated_bwd(const void* u, const void* uspec, const void* v,
                                       const void* dy, const void* x0, const void* k,
                                       const float* D, void* du, void* dx0, void* dk, float* dD,
                                       void* ws, int slabs, int route, int B, int C, int L,
                                       int Lk, int n, int is_bf16, cudaStream_t stream) {
  using namespace FFT_NS;
  const bool inputs_fit =
      (route == kSpecV && u == nullptr && uspec != nullptr && v != nullptr) ||
      (route == kSpec && u == nullptr && uspec != nullptr && v == nullptr) ||
      (route == kRetransform && u != nullptr && uspec == nullptr && v == nullptr);
  if (!inputs_fit || !valid_fft_size(n) || L < 1 || 2 * L > n || Lk < 1 || Lk > L || B < 1 ||
      C < 1 || (C + 1) / 2 > 65535 || B > 65535 || ws == nullptr ||
      slabs != hyena_fftconv_gated_bwd_ws_slabs(B, C, route)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(n);
  const Route r = static_cast<Route>(route);
  auto* us = static_cast<const float2*>(uspec);
  auto* w = static_cast<float2*>(ws);
  if (is_bf16) {
    using bf = __nv_bfloat16;
    return launch_all(r, static_cast<const bf*>(u), us, static_cast<const bf*>(v),
                      static_cast<const bf*>(dy), static_cast<const bf*>(x0),
                      static_cast<const bf*>(k), D, static_cast<bf*>(du), static_cast<bf*>(dx0),
                      static_cast<bf*>(dk), dD, w, B, C, L, Lk, p, stream);
  }
  return launch_all(r, static_cast<const float*>(u), us, static_cast<const float*>(v),
                    static_cast<const float*>(dy), static_cast<const float*>(x0),
                    static_cast<const float*>(k), D, static_cast<float*>(du),
                    static_cast<float*>(dx0), static_cast<float*>(dk), dD, w, B, C, L, Lk, p,
                    stream);
}
