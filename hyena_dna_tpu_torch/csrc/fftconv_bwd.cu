// Kernel C: backward of the causal FFT conv with the D skip term, for Hopper.
//
// For y = irfft(rfft(u, n) * rfft(k, n), n)[:L] + u * D and the cotangent dy:
//   du[b, c] = irfft(DY[b, c] * conj(K[c]), n)[:L] + dy[b, c] * D[c]
//   dk[c]    = irfft(sum_b DY[b, c] * conj(U[b, c]), n)[:Lk]
//   dD[c]    = sum_{b, t} dy[b, c, t] u[b, c, t]  (= the lag-0 value of dk)
// DY, U and K are the size-n transforms of the zero-padded rows. du is a
// correlation with k, and is right only because n >= 2L: the wrapped lags
// s - t < 0 land at n + s - t >= L >= Lk, past the filter's support. The
// same holds for dk (lags past Lk fall on u's zero padding).
//
// u, dy, k, du and dk are float32 or bfloat16 (one type for all); D and dD
// float32; every transform, product and sum runs in float32.
//
// Replaces the backward Pallas conv kernels of the JAX package, one kernel
// for one contract, (u or u's spectrum, dy, k, D) -> (du, dk, dD):
//   spectrum route (u's spectrum saved by kernel B's save_spectrum):
//     hyena_dna_tpu/ops/pallas_fftconv.py::fftconv_fused_bwd_spec_packed (fft 2^16-2^17, even B)
//     hyena_dna_tpu/ops/pallas_fftconv.py::fftconv_fused_bwd_spec        (fft 2^16, odd B)
//     hyena_dna_tpu/ops/pallas_fftconv.py::fftconv_fused_bwd_du and
//       fftconv_fused_dk_from_specs                                       (fft 2^18, split)
//   retransform route (u itself):
//     hyena_dna_tpu/ops/pallas_fftconv.py::fftconv_fused_bwd_packed / fftconv_fused_bwd
//     hyena_dna_tpu/ops/pallas_fftconv_n3.py::fftconv_outer_bwd           (fft 2^17-2^21)
//
// What bounds it on the H100: like kernel B, float32 FFT arithmetic on the
// CUDA cores (per real row: dy forward, du inverse, u forward on the
// retransform route; per channel: k forward, dk inverse) and the complex
// scratch between passes, which goes through device memory past n = 2^14.
//
// Design (simple and correct first), on kernel B's four-step pieces
// (fft_common.cuh) and its channel pairing:
//   pass 1  k: column + row FFTs into kspec (per call, as in kernel B);
//           dy (and u on the retransform route): column FFTs + twiddle;
//   pass 2  rows_bwd_kernel: one block per (g rows f1 and their mirrors,
//           channel pair) loops over the batch. Per b it row-transforms dy (and u),
//           splits each pair with the Hermitian mirror, forms DY conj(K) for
//           du (inverse row FFT, stored in place of dy's scratch) and adds
//           DY conj(U) into a dk accumulator that the block owns in shared
//           memory -- so the batch sum needs no atomics and is in a fixed
//           order. After the loop it inverse-transforms the accumulator.
//           Shared memory: three buffers (dy, u, dk accumulator) of the
//           block's 2 g padded rows, 204 KB at N2 = 4096;
//   pass 3  du: inverse column FFTs + dy * D; dk: inverse column FFTs over
//           C rows (no batch), first Lk outputs, with dD read off at t = 0
//           in float32 before dk's rounding (Parseval, as the TPU kernels
//           took dD from their dk accumulator).
// dk comes out in the I/O dtype, or in float32 (dk_f32) as the JAX narrow
// and 3-factor entries return it (pallas_fftconv.py::fftconv_fused_bwd_narrow,
// pallas_fftconv3.py::fftconv3_bwd).
//
// dk-spectrum mode (k null), replacing
// hyena_dna_tpu/ops/pallas_fftconv.py::fftconv_fused_dk_spec: only dy's
// and u's transforms and pass 2's batch sum run, and sdk receives
// sum_b DY conj(U) as a pair spectrum in the four-step layout (row f1,
// natural f2); no du, no inverse. The wrapper splits the pairs.
#define FFT_NS conv_bwd
#include "fft_common.cuh"

namespace FFT_NS {

template <typename T>
int launch_all(const T* u, const float2* uspec, const T* dy, const T* k, const float* D, T* du,
               void* dk, bool dk_f32, float* dD, float2* sdy, float2* su, float2* kspec,
               float2* sdk, int B, int C, int L, int Lk, const Plan& p, cudaStream_t stream) {
  const int pairs = (C + 1) / 2;
  const int wc = radix_class(p.log_n1), wr = radix_class(p.log_n2);
  const dim3 cols_c = cols_grid(p, pairs, 1), cols_b = cols_grid(p, pairs, B);
  const int tc = cols_threads(p);
  const size_t sc = cols_smem_bytes(p);
  auto cols_fwd = [](auto w) { return cols_fwd_kernel<T, decltype(w)::value>; };
  auto cols_inv = [](auto w) { return cols_inv_kernel<T, decltype(w)::value>; };
  const bool with_du = k != nullptr;  // else the dk-spectrum mode
  if (with_du) {
    launch(cols_fwd, wc, cols_c, tc, sc, stream, k, C, Lk, p, kspec);
    launch([](auto w) { return rows_fwd_kernel<decltype(w)::value>; }, wr, rows_grid(p, pairs),
           rows_threads(p), rows_smem_bytes(p), stream, kspec, p);
  }
  launch(cols_fwd, wc, cols_b, tc, sc, stream, dy, C, L, p, sdy);
  const float2* gu = uspec;
  if (uspec == nullptr) {
    launch(cols_fwd, wc, cols_b, tc, sc, stream, u, C, L, p, su);
    gu = su;
  }
  launch([](auto w) { return rows_bwd_kernel<decltype(w)::value>; }, wr,
         pair_rows_grid(p, pairs, 1), pair_threads(p), rows_bwd_smem_bytes(p), stream, sdy, gu,
         with_du ? kspec : nullptr, sdk, B, uspec != nullptr ? 1 : 0, p);
  if (with_du) {
    launch(cols_inv, wc, cols_b, tc, sc, stream, sdy, dy, D, du, nullptr, C, L, p);
    if (dk_f32) {
      launch([](auto w) { return cols_inv_kernel<float, decltype(w)::value>; }, wc, cols_c, tc, sc,
             stream, sdk, nullptr, nullptr, static_cast<float*>(dk), dD, C, Lk, p);
    } else {
      launch(cols_inv, wc, cols_c, tc, sc, stream, sdk, nullptr, nullptr, static_cast<T*>(dk), dD,
             C, Lk, p);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace FFT_NS

// dy, du (B, C, L), k (C, Lk) contiguous, all float32 (is_bf16 == 0) or all
// bfloat16; dk (C, Lk) in that dtype, or float32 with dk_f32 != 0; D, dD
// (C,) float32. Exactly one of u (B, C, L) and uspec (kernel B's saved
// spectrum, B * ceil(C/2) * n complex64) is non-null; su (B * ceil(C/2) * n
// complex64) is scratch for u's transform and may be null with uspec. sdy
// holds B * ceil(C/2) * n complex64, kspec and sdk ceil(C/2) * n each. With
// k null (the dk-spectrum mode) D, du, dk, dD and kspec are unused and sdk
// receives the batch sum. Launches on `stream`, does not synchronise;
// returns the cudaError_t of the launches (0 on success).
extern "C" int hyena_fftconv_bwd(const void* u, const void* uspec, const void* dy, const void* k,
                                 const float* D, void* du, void* dk, float* dD, void* sdy,
                                 void* su, void* kspec, void* sdk, int B, int C, int L, int Lk,
                                 int n, int is_bf16, int dk_f32, cudaStream_t stream) {
  using namespace FFT_NS;
  if (!valid_fft_size(n) || L < 1 || 2 * L > n || Lk < 1 || Lk > L || B < 1 || C < 1 ||
      (C + 1) / 2 > 65535 || B > 65535 || (u == nullptr) == (uspec == nullptr) ||
      (u != nullptr && su == nullptr) ||
      (k != nullptr && (D == nullptr || du == nullptr || dk == nullptr || dD == nullptr ||
                        kspec == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(n);
  auto* us = static_cast<const float2*>(uspec);
  auto f2 = [](void* q) { return static_cast<float2*>(q); };
  if (is_bf16) {
    using bf = __nv_bfloat16;
    return launch_all(static_cast<const bf*>(u), us, static_cast<const bf*>(dy),
                      static_cast<const bf*>(k), D, static_cast<bf*>(du), dk, dk_f32 != 0, dD,
                      f2(sdy), f2(su), f2(kspec), f2(sdk), B, C, L, Lk, p, stream);
  }
  return launch_all(static_cast<const float*>(u), us, static_cast<const float*>(dy),
                    static_cast<const float*>(k), D, static_cast<float*>(du), dk, dk_f32 != 0, dD,
                    f2(sdy), f2(su), f2(kspec), f2(sdk), B, C, L, Lk, p, stream);
}
