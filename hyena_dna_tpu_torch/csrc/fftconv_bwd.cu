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
// Two paths, as kernel B's:
//   * the short path (fft_short.cuh) at n <= 2^kShortMaxLogN (2^13) on the
//     retransform route with k: three launches (K + D once a call; one block
//     per (channel pair, batch slice) transforming dy's and u's rows whole in
//     shared memory, writing du and adding DY conj(U) into the slice's dk
//     partial; one block per pair summing the partials in slice order and
//     transforming dk back), no scratch between passes in device memory;
//   * the four-step passes below, above the cut, and at every size for the
//     two modes no route of the model takes at short n: the spectrum route
//     (u's spectrum saved by kernel B's save_spectrum, in the four-step
//     layout) and the dk-spectrum mode (k null, dk's spectrum out in that
//     layout). Those modes branch to the four-step passes by design.
//
// The four-step passes. What bounds them on the H100: the complex64 scratch
// between them goes through device memory past n = 2^14 (one pair's row of 2^21 is
// 16 MB, past any block's shared memory): at 1 x 1,000,448 x 256 about 28
// GB a call through the passes (8.5 ms at 3.35 TB/s), counted per pass by
// utils/profile_passes.py. Measured there, no pass reaches half that rate:
// the float32 FFT passes (instructions around the butterflies, a barrier a
// pass, one or two blocks an SM) bound each launch.
//
// Design, on the four-step pieces of fft_common.cuh (kernel B's) and its
// channel pairing:
//   pass 1  column FFTs + twiddle of k, of dy, and of u on the retransform
//           route, into one workspace whose size the C helper below gives
//           the wrapper (cols_in_kernel: three blocks an SM); k's row FFTs
//           in place (rows_fwd_kernel, once a call: K does not depend on the
//           batch row);
//   pass 2  rows_grad_kernel: one block per (g rows f1 and their Hermitian
//           mirrors, channel pair) loops over the batch. Per batch row dy's
//           and u's rows arrive by cp.async, are transformed in place and
//           split with the Hermitian mirror; DY conj(K + D) goes back in
//           dy's buffer and out through its inverse row FFT into dy's
//           scratch (du's rows: the skip term dy D rides in du's spectrum,
//           as kernel E' adds D to K on its spec route); DY conj(U) is dk's
//           term. At B = 1 (both
//           long-context steps) K's rows are copied in once beside them and
//           dk's spectrum is that term, formed in u's buffer: no
//           accumulator. At B > 1 the third buffer is dk's batch sum, which
//           the block owns, so the sum needs no atomics and is in a fixed
//           order, and u's next row is copied in while du's inverse runs.
//           dk's inverse row FFT goes back into k's scratch (each block
//           rewrites only the rows it read). Three buffers of 2 g padded
//           rows, 104 KB at N2 = 256. At N2 = 4096 (fft 2^20, 2^21) a pair
//           would take 209 KB and 512 threads, one block an SM:
//           rows_grad_cluster_kernel splits it over a cluster of two blocks,
//           one row each, the mirror row read through distributed shared
//           memory, two blocks an SM;
//   pass 3  inverse column FFTs: du's over the batch (no read of dy), dk's
//           over C rows (no batch), first Lk outputs, with dD read off at
//           t = 0 in float32 before dk's rounding (Parseval, as the TPU
//           kernels took dD from their dk accumulator).
// dk comes out in the I/O dtype, or in float32 (dk_f32) as the JAX narrow
// and 3-factor entries return it (pallas_fftconv.py::fftconv_fused_bwd_narrow,
// pallas_fftconv3.py::fftconv3_bwd).
//
// dk-spectrum mode (k null), replacing
// hyena_dna_tpu/ops/pallas_fftconv.py::fftconv_fused_dk_spec: only dy's
// and u's transforms and pass 2's batch sum run, and the output receives
// sum_b DY conj(U) as a pair spectrum in the four-step layout (row f1,
// natural f2); no du, no inverse. The wrapper splits the pairs.
//
// Passes 1 and 2 (cols_in_kernel, rows_grad_body and its two kernels) live
// in fft_grad_common.cuh, which kernel E' runs too.
#define FFT_NS conv_bwd
#include "fft_grad_common.cuh"
#include "fft_short.cuh"

namespace FFT_NS {

// Complex64 slabs of n values in the workspace (see hyena_fftconv_bwd).
inline int64_t ws_slabs(int B, int C, bool retransform, bool with_k) {
  return (static_cast<int64_t>(B) * (retransform ? 2 : 1) + (with_k ? 1 : 0)) * ((C + 1) / 2);
}

template <typename T>
int launch_all(const T* u, const float2* uspec, const T* dy, const T* k, const float* D, T* du,
               void* dk, bool dk_f32, float* dD, float2* ws, int B, int C, int L, int Lk,
               const Plan& p, cudaStream_t stream) {
  const int pairs = (C + 1) / 2;
  const int64_t batch_numel = static_cast<int64_t>(B) * pairs * p.n;
  float2* sdy = ws;
  float2* su = uspec == nullptr ? sdy + batch_numel : nullptr;
  float2* sk = (su != nullptr ? su : sdy) + batch_numel;
  const bool with_du = k != nullptr;  // else the dk-spectrum mode
  const int wc = radix_class(p.log_n1), wr = radix_class(p.log_n2);
  const dim3 cols_c = cols_grid(p, pairs, 1), cols_b = cols_grid(p, pairs, B);
  const int tc = cols_threads(p);
  const size_t sc = cols_smem_bytes(p);
  auto cols_in = [](auto w) { return cols_in_kernel<T, decltype(w)::value>; };
  if (with_du) {
    launch(cols_in, wc, cols_c, tc, sc, stream, k, C, Lk, p, sk);
    launch([](auto w) { return rows_fwd_kernel<decltype(w)::value>; }, wr, rows_grid(p, pairs),
           rows_threads(p), rows_smem_bytes(p), stream, sk, p);
  }
  launch(cols_in, wc, cols_b, tc, sc, stream, dy, C, L, p, sdy);
  if (su != nullptr) launch(cols_in, wc, cols_b, tc, sc, stream, u, C, L, p, su);
  const float2* gu = su != nullptr ? static_cast<const float2*>(su) : uspec;
  const float2* gk = with_du ? static_cast<const float2*>(sk) : nullptr;
  float2* gdk = with_du ? sk : static_cast<float2*>(dk);
  launch_rows_grad(sdy, gu, gk, D, gdk, B, C, su != nullptr ? 0 : 1, p, stream);
  if (with_du) {
    launch([](auto w) { return cols_inv_kernel<T, decltype(w)::value>; }, wc, cols_b, tc, sc,
           stream, sdy, nullptr, nullptr, du, nullptr, C, L, p);
    if (dk_f32) {
      launch([](auto w) { return cols_inv_kernel<float, decltype(w)::value>; }, wc, cols_c, tc, sc,
             stream, sk, nullptr, nullptr, static_cast<float*>(dk), dD, C, Lk, p);
    } else {
      launch([](auto w) { return cols_inv_kernel<T, decltype(w)::value>; }, wc, cols_c, tc, sc,
             stream, sk, nullptr, nullptr, static_cast<T*>(dk), dD, C, Lk, p);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace FFT_NS

// The workspace of hyena_fftconv_bwd in complex64 slabs of n values (the
// wrapper allocates slabs * n * 8 bytes): dy's column pass (B slabs a
// channel pair), u's (B more) on the retransform route (retransform != 0),
// and k's (one) unless in the dk-spectrum mode (with_k == 0). -1 for sizes
// the kernel refuses. The short path uses the first (S + 1) ceil(C/2) of
// them (K + D, then S <= B dk partials a pair).
extern "C" int hyena_fftconv_bwd_ws_slabs(int B, int C, int retransform, int with_k) {
  if (B < 1 || C < 1 || B > 65535 || (C + 1) / 2 > 65535) return -1;
  const int64_t slabs = FFT_NS::ws_slabs(B, C, retransform != 0, with_k != 0);
  return slabs > 0x7fffffff ? -1 : static_cast<int>(slabs);
}

// The number S of dk partials a channel pair that the short path sums at
// this shape (its batch slices, fixed for a card: the fewest rows a block
// for which its grid fits the card's resident blocks), 0 where n is above
// the cut; -1 for sizes the kernel refuses.
extern "C" int hyena_fftconv_bwd_short_slices(int B, int C, int n, int is_bf16) {
  using namespace FFT_NS;
  if (B < 1 || C < 1 || B > 65535 || (C + 1) / 2 > 65535 || !valid_fft_size(n)) return -1;
  if (!short_path_size(n)) return 0;
  const int log_n = 31 - __builtin_clz(static_cast<unsigned>(n));
  const int rows = is_bf16 ? short_grad_rows<__nv_bfloat16>(B, C, log_n)
                           : short_grad_rows<float>(B, C, log_n);
  return (B + rows - 1) / rows;
}

// dy, du (B, C, L), k (C, Lk) contiguous, all float32 (is_bf16 == 0) or all
// bfloat16; dk (C, Lk) in that dtype, or float32 with dk_f32 != 0; D, dD
// (C,) float32. Exactly one of u (B, C, L) and uspec (kernel B's saved
// spectrum, B * ceil(C/2) * n complex64) is non-null. ws holds `slabs` *
// n complex64, slabs = hyena_fftconv_bwd_ws_slabs(B, C, u != null, k !=
// null) (refused otherwise). With k null (the dk-spectrum mode) D, du and
// dD are unused and dk receives sum_b DY conj(U) as pair spectra,
// ceil(C/2) * n complex64 in the four-step layout. Launches on `stream`,
// does not synchronise; returns the cudaError_t of the launches (0 on
// success).
extern "C" int hyena_fftconv_bwd(const void* u, const void* uspec, const void* dy, const void* k,
                                 const float* D, void* du, void* dk, float* dD, void* ws,
                                 int slabs, int B, int C, int L, int Lk, int n, int is_bf16,
                                 int dk_f32, cudaStream_t stream) {
  using namespace FFT_NS;
  if (!valid_fft_size(n) || L < 1 || 2 * L > n || Lk < 1 || Lk > L || B < 1 || C < 1 ||
      (C + 1) / 2 > 65535 || B > 65535 || (u == nullptr) == (uspec == nullptr) ||
      ws == nullptr || dk == nullptr ||
      slabs != hyena_fftconv_bwd_ws_slabs(B, C, u != nullptr, k != nullptr) ||
      (k != nullptr && (D == nullptr || du == nullptr || dD == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* us = static_cast<const float2*>(uspec);
  auto* w = static_cast<float2*>(ws);
  // the spectrum route and the dk-spectrum mode keep the four-step passes
  if (short_path_size(n) && u != nullptr && k != nullptr) {
    const int log_n = 31 - __builtin_clz(static_cast<unsigned>(n));
    if (is_bf16) {
      using bf = __nv_bfloat16;
      return launch_short_bwd(static_cast<const bf*>(u), static_cast<const bf*>(dy),
                              static_cast<const bf*>(k), D, static_cast<bf*>(du), dk, dk_f32 != 0,
                              dD, w, B, C, L, Lk, log_n, stream);
    }
    return launch_short_bwd(static_cast<const float*>(u), static_cast<const float*>(dy),
                            static_cast<const float*>(k), D, static_cast<float*>(du), dk,
                            dk_f32 != 0, dD, w, B, C, L, Lk, log_n, stream);
  }
  const Plan p = make_plan(n);
  if (is_bf16) {
    using bf = __nv_bfloat16;
    return launch_all(static_cast<const bf*>(u), us, static_cast<const bf*>(dy),
                      static_cast<const bf*>(k), D, static_cast<bf*>(du), dk, dk_f32 != 0, dD, w,
                      B, C, L, Lk, p, stream);
  }
  return launch_all(static_cast<const float*>(u), us, static_cast<const float*>(dy),
                    static_cast<const float*>(k), D, static_cast<float*>(du), dk, dk_f32 != 0, dD,
                    w, B, C, L, Lk, p, stream);
}
