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
// device memory. Per real row pair: dv forward and du inverse (specv), plus
// v's inverse (spec), plus u's forward (retransform); per channel pair: k
// forward and dk inverse. The gate itself is elementwise work in the
// column passes' prologue and epilogues, a few reads of the I/O type.
//
// Design: kernel C's passes (fft_common.cuh), with the gate folded in:
//   k      pass 1 + row pass into kspec. On the spec route the source adds
//          D at t = 0 (k + D delta), so kspec holds K + D: the TPU kernel's
//          ks trick (pallas_fftconv.py:1430-1443), which makes inv(U ks) the
//          whole v = conv + u D and inv(DV conj(ks)) the whole du. In the
//          pair spectrum it adds D_c + i D_{c+1} to every bin, and
//          split_pair, being linear, hands each channel K_c + D_c.
//   v      (spec, retransform) a row pass of its own, kernel B's
//          rows_conv_kernel: U's rows (read from the saved spectrum, or u's
//          column pass transformed there and stored back as a spectrum for
//          the dk sum) times kspec, inverse row FFT; then an inverse column
//          pass whose epilogue writes dx0 = dy v (+ u D on the retransform
//          route, whose kspec is plain K). Running it as its own pass keeps
//          rows_bwd_kernel's shared memory at three buffers of 2 g padded
//          rows (204 KB at N2 = 4096): a fourth would need 272 KB, over the
//          227 KB a block may use.
//   dv     pass 1 whose source reads dy and x0 and transforms dv = dy x0 in
//          float32 (the TPU kernels round dv to their store type first);
//          on the specv route the same pass writes dx0 = dy v from the
//          saved v.
//   du, dk rows_bwd_kernel (below) on U's spectrum (dk's batch sum in a
//          fixed order per block: no atomics, the same bits every run),
//          then inverse column passes: du's epilogue adds dv D (dv
//          recomputed from dy and x0) unless kspec already holds K + D;
//          dk's reads dD off lag 0.
// v's pass runs first and borrows dv's scratch, so the scratch is dv's,
// u's (retransform only), kspec and dk's.
#define FFT_NS conv_gbwd
#include "fft_common.cuh"

namespace FFT_NS {

enum Route { kSpecV = 0, kSpec = 1, kRetransform = 2 };

// The row pass of du and dk. gdy: dy's column pass in, du's inverse row
// pass out, (B, pairs, n). gu: u's column pass (u_is_spectrum == 0) or u's
// pair spectrum in the layout rows_conv_kernel saves, (B, pairs, n). gdk:
// dk's inverse row pass out, (pairs, n). One block per (g row pairs,
// channel pair) loops over the batch and owns dk's accumulator in shared
// memory, so the batch sum needs no atomics and is in a fixed order. With
// kspec null (the dk-spectrum mode) there is no du: the block stops after
// the batch sum and stores sum_b DY conj(U) as a pair spectrum, row f1 in
// natural f2 order, with no inverse.
template <int kRadix>
__global__ void __launch_bounds__(kMaxThreads) rows_bwd_kernel(
    float2* __restrict__ gdy, const float2* __restrict__ gu, const float2* __restrict__ kspec,
    float2* __restrict__ gdk, int B, int u_is_spectrum, Plan p) {
  extern __shared__ float2 smem[];
  const PairRows rows(p, blockIdx.x);
  const int pair = blockIdx.y;
  const int pairs = gridDim.y;
  const bool with_du = kspec != nullptr;
  const float2* ks = with_du ? kspec + static_cast<int64_t>(pair) * p.n : nullptr;
  const RowLayout lay{padded(p.n2)};
  const int part = 2 * p.g * lay.stride;
  float2* bdy = smem;
  float2* bu = bdy + part;
  float2* acc = bu + part;
  const SharedIO<RowLayout> sdy{bdy, lay}, su{bu, lay}, sacc{acc, lay};
  for (int e = threadIdx.x; e < part; e += blockDim.x) acc[e] = make_float2(0.f, 0.f);
  for (int b = 0; b < B; ++b) {
    const int64_t off = (static_cast<int64_t>(b) * pairs + pair) * p.n;
    const RowsIO<PairRows> dyb{gdy + off, rows, p.log_n2};
    fft<false, kRadix>(dyb, sdy, RowMap{}, sdy, p.log_n2, rows.nrows);
    if (u_is_spectrum) {
      rows_to_shared(bu, lay, gu + off, rows, rows.nrows, p.log_n2);
    } else {
      fft<false, kRadix>(RowsIO<PairRows>{const_cast<float2*>(gu) + off, rows, p.log_n2}, su,
                         RowMap{}, su, p.log_n2, rows.nrows);
    }
    for_each_pair(rows, p, [&](int s0, int i, int s1, int m, int r0, int r1) {
      float2& ya = bdy[lay(s0, i)];
      float2& yb = bdy[lay(s1, m)];
      float2 dy0, dy1, u0, u1;
      split_pair(ya, yb, dy0, dy1);
      split_pair(bu[lay(s0, i)], bu[lay(s1, m)], u0, u1);
      if (with_du) {
        float2 k0, k1;
        split_pair(ks[(static_cast<int64_t>(r0) << p.log_n2) + i],
                   ks[(static_cast<int64_t>(r1) << p.log_n2) + m], k0, k1);
        const float2 p0 = cmulc(dy0, k0);
        const float2 p1 = cmulc(dy1, k1);
        ya = join_pair(p0, p1);
        yb = join_pair_mirror(p0, p1);
      }
      const float2 q0 = cmulc(dy0, u0);
      const float2 q1 = cmulc(dy1, u1);
      const float2 w = join_pair(q0, q1);
      float2& aa = acc[lay(s0, i)];
      aa = make_float2(aa.x + w.x, aa.y + w.y);
      if (s0 != s1 || m != i) {  // f == -f (one bin) is accumulated once
        const float2 wm = join_pair_mirror(q0, q1);
        float2& ab = acc[lay(s1, m)];
        ab = make_float2(ab.x + wm.x, ab.y + wm.y);
      }
    });
    __syncthreads();
    if (with_du) fft<true, kRadix>(sdy, dyb, RowMap{}, sdy, p.log_n2, rows.nrows);
    __syncthreads();  // the next b overwrites bdy and bu
  }
  const RowsIO<PairRows> dk{gdk + static_cast<int64_t>(pair) * p.n, rows, p.log_n2};
  if (with_du) {
    fft<true, kRadix>(sacc, dk, RowMap{}, sacc, p.log_n2, rows.nrows);
  } else {
    shared_to_rows(dk.a, rows, acc, lay, rows.nrows, p.log_n2);
  }
}

// rows_bwd_kernel's shared memory: three buffers of 2 g padded rows (dy, u,
// dk's sum), 104 KB (204 KB at N2 = 4096)
inline size_t rows_bwd_smem_bytes(const Plan& p) { return 3 * rows_smem_bytes(p); }

// Pass 1 source for the filter with the skip term folded in: k + D delta.
template <typename T>
struct DeltaSource {
  const T* k;
  const float* D;
  int64_t row0, len;
  bool has2;
  float d0, d1;
  __device__ __forceinline__ void begin(int b, int c, int C, int len_, bool has2_) {
    row0 = (static_cast<int64_t>(b) * C + c) * len_;
    len = len_;
    has2 = has2_;
    d0 = D[c];
    d1 = has2 ? D[c + 1] : 0.f;
  }
  __device__ __forceinline__ float2 operator()(int t) const {
    float re = to_f32(k[row0 + t]), im = has2 ? to_f32(k[row0 + len + t]) : 0.f;
    if (t == 0) {
      re += d0;
      im += d1;
    }
    return make_float2(re, im);
  }
};

// Pass 1 source dv = dy x0 in float32; with `v`, also writes dx0 = dy v.
template <typename T>
struct GateGradSource {
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
  __device__ __forceinline__ float one(int64_t i) const {
    const float g = to_f32(dy[i]);
    if (v != nullptr) store(dx0 + i, g * to_f32(v[i]));
    return g * to_f32(x0[i]);
  }
  __device__ __forceinline__ float2 operator()(int t) const {
    const int64_t i = row0 + t;
    return make_float2(one(i), has2 ? one(i + len) : 0.f);
  }
};

// Pass 3 sink for du: value + dv D with dv = dy x0 recomputed, or the value
// alone when D is null (kspec held K + D).
template <typename T>
struct DuSink {
  const T* dy;
  const T* x0;
  const float* D;
  T* du;
  int64_t row0, len;
  bool has2;
  float d0, d1;
  __device__ __forceinline__ void begin(int b, int c, int C, int len_, bool has2_) {
    row0 = (static_cast<int64_t>(b) * C + c) * len_;
    len = len_;
    has2 = has2_;
    d0 = D != nullptr ? D[c] : 0.f;
    d1 = (D != nullptr && has2) ? D[c + 1] : 0.f;
  }
  __device__ __forceinline__ float one(int64_t i, float w, float d) const {
    return D != nullptr ? w + to_f32(dy[i]) * to_f32(x0[i]) * d : w;
  }
  __device__ __forceinline__ void operator()(int t, float w0, float w1) const {
    const int64_t i = row0 + t;
    store(du + i, one(i, w0, d0));
    if (has2) store(du + i + len, one(i + len, w1, d1));
  }
};

// Pass 3 sink for the gate's gradient: v = value (+ u D when u is given),
// dx0 = dy v.
template <typename T>
struct DxSink {
  const T* dy;
  const T* u;
  const float* D;
  T* dx0;
  int64_t row0, len;
  bool has2;
  float d0, d1;
  __device__ __forceinline__ void begin(int b, int c, int C, int len_, bool has2_) {
    row0 = (static_cast<int64_t>(b) * C + c) * len_;
    len = len_;
    has2 = has2_;
    d0 = u != nullptr ? D[c] : 0.f;
    d1 = (u != nullptr && has2) ? D[c + 1] : 0.f;
  }
  __device__ __forceinline__ void one(int64_t i, float w, float d) const {
    const float v = u != nullptr ? w + to_f32(u[i]) * d : w;
    store(dx0 + i, to_f32(dy[i]) * v);
  }
  __device__ __forceinline__ void operator()(int t, float w0, float w1) const {
    const int64_t i = row0 + t;
    one(i, w0, d0);
    if (has2) one(i + len, w1, d1);
  }
};

template <typename T, int kRadix>
__global__ void __launch_bounds__(kMaxThreads) cols_fwd_delta_kernel(
    const T* __restrict__ k, const float* __restrict__ D, int C, int len, Plan p,
    float2* __restrict__ out) {
  cols_fwd_body<kRadix>(DeltaSource<T>{k, D}, C, len, p, out);
}

template <typename T, int kRadix>
__global__ void __launch_bounds__(kMaxThreads) cols_fwd_dv_kernel(
    const T* __restrict__ dy, const T* __restrict__ x0, const T* __restrict__ v,
    T* __restrict__ dx0, int C, int len, Plan p, float2* __restrict__ out) {
  cols_fwd_body<kRadix>(GateGradSource<T>{dy, x0, v, dx0}, C, len, p, out);
}

template <typename T, int kRadix>
__global__ void __launch_bounds__(kMaxThreads) cols_inv_du_kernel(
    const float2* __restrict__ a, const T* __restrict__ dy, const T* __restrict__ x0,
    const float* __restrict__ D, T* __restrict__ du, int C, int len, Plan p) {
  cols_inv_body<kRadix>(a, DuSink<T>{dy, x0, D, du}, C, len, p);
}

template <typename T, int kRadix>
__global__ void __launch_bounds__(kMaxThreads) cols_inv_dx0_kernel(
    const float2* __restrict__ a, const T* __restrict__ dy, const T* __restrict__ u,
    const float* __restrict__ D, T* __restrict__ dx0, int C, int len, Plan p) {
  cols_inv_body<kRadix>(a, DxSink<T>{dy, u, D, dx0}, C, len, p);
}

template <typename T>
int launch_all(Route route, const T* u, const float2* uspec, const T* v, const T* dy, const T* x0,
               const T* k, const float* D, T* du, T* dx0, T* dk, float* dD, float2* sdy,
               float2* su, float2* kspec, float2* sdk, int B, int C, int L, int Lk,
               const Plan& p, cudaStream_t stream) {
  const int pairs = (C + 1) / 2;
  const int wc = radix_class(p.log_n1), wr = radix_class(p.log_n2);
  const dim3 cols_c = cols_grid(p, pairs, 1), cols_b = cols_grid(p, pairs, B);
  const dim3 rows_b = pair_rows_grid(p, pairs, B);
  const int tc = cols_threads(p);
  const size_t sc = cols_smem_bytes(p), sr = rows_smem_bytes(p);
  auto rows_conv = [](auto w) { return rows_conv_kernel<decltype(w)::value>; };
  const bool ks_trick = route == kSpec;  // kspec = K + D
  if (ks_trick) {
    launch([](auto w) { return cols_fwd_delta_kernel<T, decltype(w)::value>; }, wc, cols_c, tc,
           sc, stream, k, D, C, Lk, p, kspec);
  } else {
    launch([](auto w) { return cols_fwd_kernel<T, decltype(w)::value>; }, wc, cols_c, tc, sc,
           stream, k, C, Lk, p, kspec);
  }
  launch([](auto w) { return rows_fwd_kernel<decltype(w)::value>; }, wr, rows_grid(p, pairs),
         rows_threads(p), sr, stream, kspec, p);
  const float2* gu = uspec;
  if (route != kSpecV) {  // v = inv(U K) (+ u D), dx0 = dy v; sdy is v's scratch here
    if (route == kRetransform) {
      launch([](auto w) { return cols_fwd_kernel<T, decltype(w)::value>; }, wc, cols_b, tc, sc,
             stream, u, C, L, p, su);
      launch(rows_conv, wr, rows_b, pair_threads(p), sr, stream, su, 0, kspec, su, sdy, p);
      gu = su;
    } else {
      launch(rows_conv, wr, rows_b, pair_threads(p), sr, stream, uspec, 1, kspec, nullptr, sdy,
             p);
    }
    launch([](auto w) { return cols_inv_dx0_kernel<T, decltype(w)::value>; }, wc, cols_b, tc, sc,
           stream, sdy, dy, route == kRetransform ? u : nullptr, D, dx0, C, L, p);
  }
  launch([](auto w) { return cols_fwd_dv_kernel<T, decltype(w)::value>; }, wc, cols_b, tc, sc,
         stream, dy, x0, route == kSpecV ? v : nullptr, dx0, C, L, p, sdy);
  launch([](auto w) { return rows_bwd_kernel<decltype(w)::value>; }, wr,
         pair_rows_grid(p, pairs, 1), pair_threads(p), rows_bwd_smem_bytes(p), stream, sdy, gu,
         kspec, sdk, B, 1, p);
  launch([](auto w) { return cols_inv_du_kernel<T, decltype(w)::value>; }, wc, cols_b, tc, sc,
         stream, sdy, dy, x0, ks_trick ? nullptr : D, du, C, L, p);
  launch([](auto w) { return cols_inv_kernel<T, decltype(w)::value>; }, wc, cols_c, tc, sc, stream,
         sdk, nullptr, nullptr, dk, dD, C, Lk, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace FFT_NS

// dy, x0, du, dx0 (B, C, L), k, dk (C, Lk) contiguous, all float32
// (is_bf16 == 0) or all bfloat16; D, dD (C,) float32. route 0 (specv):
// uspec (kernel E's saved spectrum, B * ceil(C/2) * n complex64) and v
// (B, C, L) given, u null. route 1 (spec): uspec given, u and v null.
// route 2 (retransform): u (B, C, L) and su (B * ceil(C/2) * n complex64
// scratch) given, uspec and v null. sdy holds B * ceil(C/2) * n complex64,
// kspec and sdk ceil(C/2) * n each. Launches on `stream`, does not
// synchronise; returns the cudaError_t of the launches (0 on success).
extern "C" int hyena_fftconv_gated_bwd(const void* u, const void* uspec, const void* v,
                                       const void* dy, const void* x0, const void* k,
                                       const float* D, void* du, void* dx0, void* dk, float* dD,
                                       void* sdy, void* su, void* kspec, void* sdk, int route,
                                       int B, int C, int L, int Lk, int n, int is_bf16,
                                       cudaStream_t stream) {
  using namespace FFT_NS;
  const bool inputs_fit =
      (route == kSpecV && u == nullptr && uspec != nullptr && v != nullptr) ||
      (route == kSpec && u == nullptr && uspec != nullptr && v == nullptr) ||
      (route == kRetransform && u != nullptr && su != nullptr && uspec == nullptr && v == nullptr);
  if (!inputs_fit || !valid_fft_size(n) || L < 1 || 2 * L > n || Lk < 1 || Lk > L || B < 1 ||
      C < 1 || (C + 1) / 2 > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(n);
  const Route r = static_cast<Route>(route);
  auto* us = static_cast<const float2*>(uspec);
  auto f2 = [](void* q) { return static_cast<float2*>(q); };
  if (is_bf16) {
    using bf = __nv_bfloat16;
    return launch_all(r, static_cast<const bf*>(u), us, static_cast<const bf*>(v),
                      static_cast<const bf*>(dy), static_cast<const bf*>(x0),
                      static_cast<const bf*>(k), D, static_cast<bf*>(du), static_cast<bf*>(dx0),
                      static_cast<bf*>(dk), dD, f2(sdy), f2(su), f2(kspec), f2(sdk), B, C, L,
                      Lk, p, stream);
  }
  return launch_all(r, static_cast<const float*>(u), us, static_cast<const float*>(v),
                    static_cast<const float*>(dy), static_cast<const float*>(x0),
                    static_cast<const float*>(k), D, static_cast<float*>(du),
                    static_cast<float*>(dx0), static_cast<float*>(dk), dD, f2(sdy), f2(su),
                    f2(kspec), f2(sdk), B, C, L, Lk, p, stream);
}
