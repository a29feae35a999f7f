// Kernel B: causal FFT long convolution with the D skip term, for Hopper.
//
//   y[b, c, :L] = irfft(rfft(u[b, c], n) * rfft(k[c], n), n)[:L] + u[b, c] * D[c]
//
// u, k and y are float32 or bfloat16 (one type for all three); D is float32;
// every transform, product and sum runs in float32. n is the power-of-two
// FFT size (>= 16, >= 2L, <= 2^21).
//
// Replaces the forward Pallas conv kernels of the JAX package:
//   hyena_dna_tpu/ops/pallas_fftconv.py::fftconv_fused_fwd_packed (fft 2^16-2^17, even B)
//   hyena_dna_tpu/ops/pallas_fftconv.py::fftconv_fused_fwd        (fft 2^16, odd B)
//   hyena_dna_tpu/ops/pallas_fftconv_n3.py::fftconv_outer_fwd     (fft 2^17-2^21)
// and the XLA FFT the TPU used below 2^16. Two paths serve every size:
//   * the short path (fft_short.cuh) at n <= 2^kShortMaxLogN (2^13): each
//     channel pair's row whole in one block's shared memory, two launches
//     (K + D once a call, then the conv with the batch spread over the grid),
//     no scratch in device memory;
//   * the four-step passes below, above the cut, and at every size when the
//     caller asks for u's saved spectrum (save_spectrum): that spectrum is
//     kept in the four-step layout kernel C's spectrum route reads, so the
//     mode branches to the four-step passes here by design (no route of the
//     model saves a spectrum below 2^16).
//
// The four-step passes. What bounds them on the H100: the plan's complex64 scratch in
// device memory between passes (a 2^21 row is 16 MB, past any block's
// shared memory). Per (batch, channel pair) u's chain moves about 40 n
// bytes (pass 1 writes 8n; pass 2 reads 8n, reads 8n of k's spectrum and
// writes 8n; pass 3 reads 8n) and k's chain about 24 n per pair: 1.5 GB
// (0.46 ms at 3.35 TB/s) at 4 x 32768 x 256 and 17.2 GB (5.1 ms) at
// 1 x 1,000,448 x 256. The float32 arithmetic, about 2.5 n log2 n flops
// per complex transform, is a few percent of the card's rate; what it
// costs beyond that is instructions around the butterflies (index
// arithmetic, shared-memory traffic, barriers), which the sub-FFT design
// in fft_common.cuh keeps few: radix-16/8 passes in registers, two
// exchanges through shared memory for a 4096-point row.
//
// Design (simple and correct first; no tensor cores yet):
//  * Channel pairing: channels c and c+1 share one complex transform of
//    z = u_c + i u_{c+1} (k likewise). Their spectra are split again with
//    the Hermitian mirror Z[-k] inside the pointwise product, so a real
//    row costs half a complex transform at any batch size, odd B included.
//    For odd C the last channel pairs with zeros.
//  * Four-step transform, n = N1 * N2 (N1 <= 512, N2 <= 4096), index
//    t = N2 * t1 + t2 and frequency f = f1 + N1 * f2:
//      pass 1  column FFTs of size N1 (blocks of TC adjacent columns, so
//              loads and stores are coalesced), times the twiddle
//              W_n^(t2 f1), into a complex scratch of n per (b, pair);
//      pass 2  row FFTs of size N2, the pointwise product with k's
//              spectrum, and the inverse row FFTs -- fused, so the
//              spectrum never leaves shared memory; a block owns rows f1
//              and their Hermitian mirror rows N1 - f1;
//      pass 3  conjugate twiddle and inverse column FFTs, scale 1/n,
//              + u * D, only the first L outputs stored, in u's type.
//    k's spectrum is a pass 1 + forward pass 2 of its own per call (the TPU
//    kernels cached it in scratch across a sequential batch grid, which
//    CUDA blocks cannot share).
//  * Sub-FFTs are mixed-radix Stockham passes with register-resident
//    radix-16/8 DFTs (fft_common.cuh, shared with kernels C, E and E'); a
//    pass-2 block owns g (row, mirror row) pairs, 2 g N2 <= 8192 values.
//  * save_spectrum (a non-null `uspec`): pass 2 also stores u's pair
//    spectrum before the product, as pallas_fftconv.py::
//    fftconv_fused_fwd_packed(save_spectrum=True) does, so kernel C's
//    spectrum route transforms only dy. The layout is the four-step one
//    (row f1, natural f2) and is private to kernels B and C.
#define FFT_NS conv_fwd
#include "fft_common.cuh"
#include "fft_short.cuh"

namespace FFT_NS {

template <typename T>
int launch_all(const T* u, const T* k, const float* D, T* y, float2* scratch, float2* kspec,
               float2* uspec, int B, int C, int L, int Lk, const Plan& p, cudaStream_t stream) {
  const int pairs = (C + 1) / 2;
  const int wc = col_class(p), wr = row_class(p);
  const dim3 cols_k = cols_grid(p, pairs, 1), cols_u = cols_grid(p, pairs, B);
  const int tc = cols_threads(p);
  const size_t sc = cols_smem_bytes(p), sr = rows_smem_bytes(p);
  auto cols_fwd = [](auto w) { return cols_fwd_kernel<T, decltype(w)::value>; };
  launch(cols_fwd, wc, cols_k, tc, sc, stream, k, C, Lk, p, kspec);
  launch([](auto w) { return rows_fwd_kernel<decltype(w)::value>; }, wr, rows_grid(p, pairs),
         rows_threads(p), sr, stream, kspec, p);
  launch(cols_fwd, wc, cols_u, tc, sc, stream, u, C, L, p, scratch);
  launch([](auto w) { return rows_conv_kernel<decltype(w)::value>; }, wr,
         pair_rows_grid(p, pairs, B), pair_threads(p), sr, stream, scratch, 0, kspec, uspec,
         scratch, p);
  launch([](auto w) { return cols_inv_kernel<T, decltype(w)::value>; }, wc, cols_u, tc, sc, stream,
         scratch, u, D, y, nullptr, C, L, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace FFT_NS

// u (B, C, L), k (C, Lk), y (B, C, L) contiguous, all float32 (is_bf16 == 0)
// or all bfloat16; D (C,) float32. kspec holds ceil(C/2) * n complex64.
// scratch holds B * ceil(C/2) * n complex64, and may be null on the short
// path (n <= 2^kShortMaxLogN with uspec null), which does not touch it.
// uspec is null, or B * ceil(C/2) * n complex64 that receives u's pass-2
// spectrum for kernel C (the four-step passes at every n). Launches on
// `stream`, does not synchronise; returns the cudaError_t of the launches (0
// on success).
extern "C" int hyena_fftconv_fwd(const void* u, const void* k, const float* D, void* y,
                                 void* scratch, void* kspec, void* uspec, int B, int C, int L,
                                 int Lk, int n, int is_bf16, cudaStream_t stream) {
  using namespace FFT_NS;
  if (!valid_fft_size(n) || L < 1 || 2 * L > n || Lk < 1 || Lk > L || B < 1 || C < 1 ||
      (C + 1) / 2 > 65535 || B > 65535 || kspec == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* s = static_cast<float2*>(scratch);
  auto* ks = static_cast<float2*>(kspec);
  auto* us = static_cast<float2*>(uspec);
  const int log_n = 31 - __builtin_clz(static_cast<unsigned>(n));
  if (short_path_size(n) && us == nullptr) {  // the saved-spectrum mode keeps the four-step passes
    if (is_bf16) {
      using bf = __nv_bfloat16;
      return launch_short_fwd(static_cast<const bf*>(u), static_cast<const bf*>(k), D,
                              static_cast<bf*>(y), ks, B, C, L, Lk, log_n, stream);
    }
    return launch_short_fwd(static_cast<const float*>(u), static_cast<const float*>(k), D,
                            static_cast<float*>(y), ks, B, C, L, Lk, log_n, stream);
  }
  if (s == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(n);
  if (is_bf16) {
    return launch_all(static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(k), D,
                      static_cast<__nv_bfloat16*>(y), s, ks, us, B, C, L, Lk, p, stream);
  }
  return launch_all(static_cast<const float*>(u), static_cast<const float*>(k), D,
                    static_cast<float*>(y), s, ks, us, B, C, L, Lk, p, stream);
}
