// Kernel E: the causal FFT long convolution with the Hyena post-gate fused
// into its epilogue, for Hopper.
//
//   v[b, c, :L] = irfft(rfft(u[b, c], n) * rfft(k[c], n), n)[:L] + u[b, c] * D[c]
//   y[b, c, :L] = v[b, c] * x0[b, c]
//
// u, x0, k, y (and v) are float32 or bfloat16 (one type for all); D is
// float32; every transform, product and sum runs in float32, and y is
// rounded once, from the float32 v times x0 (as the TPU kernel does). n is
// the power-of-two FFT size (>= 16, >= 2L, <= 2^21).
//
// Replaces the gated forward Pallas kernel of the JAX package:
//   hyena_dna_tpu/ops/pallas_fftconv.py:1534 fftconv_fused_fwd_packed_gated
//   (fft 2^16-2^17, even B, C % 8 == 0; the torch entry point keeps that
//   contract, this kernel takes any size kernel B takes).
// It optionally writes the ungated v in the I/O type (`save_v`, which the
// specv backward reads for dx0 = dy * v) and u's pair spectrum (kernel B's
// save_spectrum layout, read by the backward's specv and spec routes).
//
// What bounds it on the H100: as kernel B, the float32 FFT arithmetic on
// the CUDA cores (three transforms per real row pair) and the complex
// scratch between passes (a 2^16 row is 512 KB of complex64, so it goes
// through device memory); no pass reaches the memory rate
// (utils/profile_passes.py splits a call by launch). The gate adds one read
// of x0 (and one write of v) per element.
//
// Design: kernel B's three passes (fft_common.cuh) with the skip term in the
// filter and the gate in pass 3:
//   pass 1  k + D delta: column (cols_in_delta_kernel, fft_grad_common.cuh)
//           and row transforms into kspec, which then holds K + D (the TPU
//           kernels' ks trick, pallas_fftconv.py:1430-1443); u: column
//           transforms into the scratch (cols_in_kernel: three blocks an SM,
//           as kernel C's);
//   pass 2  rows_conv_kernel: u's row transform, product with K + D,
//           inverse row transform, fused in shared memory (and u's pair
//           spectrum stored on the way, before the product, with
//           save_spectrum);
//   pass 3  inverse column transforms whose epilogue takes the whole v
//           (conv + u D, formed in the spectrum), writes y = v * x0 rounded
//           once from float32 and, with save_v, v; it reads no u, and its
//           reads of x0 are batched ahead of its stores (BatchedSinkOut,
//           fft_grad_common.cuh).
// The post-gate therefore costs no pass of its own: the composite route
// (kernel B, then y = v * x0 as elementwise work) writes v and reads it
// back.
#define FFT_NS conv_gfwd
#include "fft_grad_common.cuh"

namespace FFT_NS {

// Pass 3 sink (batched, fft_grad_common.cuh): v = value (float32), y = v * x0
// rounded once, v stored too when `v` is not null.
template <typename T>
struct GateSink {
  using In = float2;  // x0 of the pair's two channels
  const T* x0;
  T* y;
  T* v;
  int64_t row0, len;
  bool has2;
  __device__ __forceinline__ void begin(int b, int c, int C, int len_, bool has2_) {
    row0 = (static_cast<int64_t>(b) * C + c) * len_;
    len = len_;
    has2 = has2_;
  }
  __device__ __forceinline__ In load(int t) const {
    const int64_t i = row0 + t;
    return make_float2(to_f32(x0[i]), has2 ? to_f32(x0[i + len]) : 0.f);
  }
  __device__ __forceinline__ void store(int t, In g, float v0, float v1) const {
    const int64_t i0 = row0 + t;
    store_one(i0, g.x, v0);
    if (has2) store_one(i0 + len, g.y, v1);
  }
  __device__ __forceinline__ void store_one(int64_t i, float g, float vv) const {
    FFT_NS::store(y + i, vv * g);
    if (v != nullptr) FFT_NS::store(v + i, vv);
  }
};

template <typename T, int kRadix>
__global__ void __launch_bounds__(kMaxThreads) cols_inv_gate_kernel(
    const float2* __restrict__ a, const T* __restrict__ x0, T* __restrict__ y, T* __restrict__ v,
    int C, int len, Plan p) {
  cols_inv_body<kRadix, BatchedSinkOut>(a, GateSink<T>{x0, y, v}, C, len, p);
}

template <typename T>
int launch_all(const T* u, const T* x0, const T* k, const float* D, T* y, T* v, float2* scratch,
               float2* kspec, float2* uspec, int B, int C, int L, int Lk, const Plan& p,
               cudaStream_t stream) {
  const int pairs = (C + 1) / 2;
  const int wc = col_class(p), wr = row_class(p);
  const dim3 cols_k = cols_grid(p, pairs, 1), cols_u = cols_grid(p, pairs, B);
  const int tc = cols_threads(p);
  const size_t sc = cols_smem_bytes(p), sr = rows_smem_bytes(p);
  launch([](auto w) { return cols_in_delta_kernel<T, decltype(w)::value>; }, wc, cols_k, tc, sc,
         stream, k, D, C, Lk, p, kspec);
  launch([](auto w) { return rows_fwd_kernel<decltype(w)::value>; }, wr, rows_grid(p, pairs),
         rows_threads(p), sr, stream, kspec, p);
  launch([](auto w) { return cols_in_kernel<T, decltype(w)::value>; }, wc, cols_u, tc, sc, stream,
         u, C, L, p, scratch);
  launch([](auto w) { return rows_conv_kernel<decltype(w)::value>; }, wr,
         pair_rows_grid(p, pairs, B), pair_threads(p), sr, stream, scratch, 0, kspec, uspec,
         scratch, p);
  launch([](auto w) { return cols_inv_gate_kernel<T, decltype(w)::value>; }, wc, cols_u, tc, sc,
         stream, scratch, x0, y, v, C, L, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace FFT_NS

// u, x0, y (B, C, L) and k (C, Lk) contiguous, all float32 (is_bf16 == 0) or
// all bfloat16; D (C,) float32. v is null or (B, C, L) in the same type,
// and receives the ungated conv output. scratch holds B * ceil(C/2) * n
// complex64, kspec ceil(C/2) * n. uspec is null, or B * ceil(C/2) * n
// complex64 that receives u's pair spectrum (kernel B's layout). Launches on
// `stream`, does not synchronise; returns the cudaError_t of the launches
// (0 on success).
extern "C" int hyena_fftconv_gated_fwd(const void* u, const void* x0, const void* k,
                                       const float* D, void* y, void* v, void* scratch,
                                       void* kspec, void* uspec, int B, int C, int L, int Lk,
                                       int n, int is_bf16, cudaStream_t stream) {
  using namespace FFT_NS;
  if (!valid_fft_size(n) || L < 1 || 2 * L > n || Lk < 1 || Lk > L || B < 1 || C < 1 ||
      (C + 1) / 2 > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(n);
  auto f2 = [](void* q) { return static_cast<float2*>(q); };
  if (is_bf16) {
    using bf = __nv_bfloat16;
    return launch_all(static_cast<const bf*>(u), static_cast<const bf*>(x0),
                      static_cast<const bf*>(k), D, static_cast<bf*>(y), static_cast<bf*>(v),
                      f2(scratch), f2(kspec), f2(uspec), B, C, L, Lk, p, stream);
  }
  return launch_all(static_cast<const float*>(u), static_cast<const float*>(x0),
                    static_cast<const float*>(k), D, static_cast<float*>(y),
                    static_cast<float*>(v), f2(scratch), f2(kspec), f2(uspec), B, C, L, Lk, p,
                    stream);
}
