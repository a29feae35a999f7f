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
// and the XLA FFT the TPU used below 2^16: one kernel serves every size.
//
// What bounds it on the H100: the FFT arithmetic in float32 on the CUDA
// cores (about 2.5 n log2 n flops per real transform, 3 transforms per row)
// and the complex intermediate, which does not fit in shared memory beyond
// n = 2^14 (a 2^21 row is 16 MB of complex64) and so goes through device
// memory between passes.
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
//              spectrum in the same permuted order, and the inverse row
//              FFTs -- fused, so the spectrum never leaves shared memory;
//              a block owns a row f1 and its Hermitian mirror row N1 - f1;
//      pass 3  conjugate twiddle and inverse column FFTs, scale 1/n,
//              + u * D, only the first L outputs stored, in u's type.
//    k's spectrum is a pass 1 + forward pass 2 of its own per call (the TPU
//    kernels cached it in scratch across a sequential batch grid, which
//    CUDA blocks cannot share).
//  * Sub-FFTs are iterative radix-2 in shared memory; the passes live in
//    fft_common.cuh, shared with kernels C, E and E'.
//  * save_spectrum (a non-null `uspec`): pass 2 also stores u's pair
//    spectrum before the product, as pallas_fftconv.py::
//    fftconv_fused_fwd_packed(save_spectrum=True) does, so kernel C's
//    spectrum route transforms only dy. The layout is the four-step one
//    (row f1, natural f2) and is private to kernels B and C.
#define FFT_NS conv_fwd
#include "fft_common.cuh"

namespace FFT_NS {

template <typename T>
int launch_all(const T* u, const T* k, const float* D, T* y, float2* scratch, float2* kspec,
               float2* uspec, int B, int C, int L, int Lk, const Plan& p, cudaStream_t stream) {
  const int pairs = (C + 1) / 2;
  const size_t smem_cols = cols_smem_bytes(p);
  const size_t smem_rows = rows_smem_bytes(p);
  cudaFuncSetAttribute(cols_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem_cols));
  cudaFuncSetAttribute(cols_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem_cols));
  cudaFuncSetAttribute(rows_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem_rows));
  cudaFuncSetAttribute(rows_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem_rows));
  const dim3 cols_k(p.n2 / p.tc, pairs, 1), cols_u(p.n2 / p.tc, pairs, B);
  cols_fwd_kernel<T><<<cols_k, kThreads, smem_cols, stream>>>(k, C, Lk, p, kspec);
  rows_fwd_kernel<<<dim3(p.n1, pairs, 1), kThreads, smem_rows, stream>>>(kspec, p);
  cols_fwd_kernel<T><<<cols_u, kThreads, smem_cols, stream>>>(u, C, L, p, scratch);
  rows_conv_kernel<<<dim3(p.n1 / 2 + 1, pairs, B), kThreads, smem_rows, stream>>>(scratch, kspec,
                                                                                  uspec, p);
  cols_inv_kernel<T><<<cols_u, kThreads, smem_cols, stream>>>(scratch, u, D, y, nullptr, C, L, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace FFT_NS

// u (B, C, L), k (C, Lk), y (B, C, L) contiguous, all float32 (is_bf16 == 0)
// or all bfloat16; D (C,) float32. scratch holds B * ceil(C/2) * n complex64,
// kspec ceil(C/2) * n. uspec is null, or B * ceil(C/2) * n complex64 that
// receives u's pass-2 spectrum for kernel C. Launches on `stream`, does not
// synchronise; returns the cudaError_t of the launches (0 on success).
extern "C" int hyena_fftconv_fwd(const void* u, const void* k, const float* D, void* y,
                                 void* scratch, void* kspec, void* uspec, int B, int C, int L,
                                 int Lk, int n, int is_bf16, cudaStream_t stream) {
  using namespace FFT_NS;
  if (!valid_fft_size(n) || L < 1 || 2 * L > n || Lk < 1 || Lk > L || B < 1 || C < 1 ||
      (C + 1) / 2 > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(n);
  auto* s = static_cast<float2*>(scratch);
  auto* ks = static_cast<float2*>(kspec);
  auto* us = static_cast<float2*>(uspec);
  if (is_bf16) {
    return launch_all(static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(k), D,
                      static_cast<__nv_bfloat16*>(y), s, ks, us, B, C, L, Lk, p, stream);
  }
  return launch_all(static_cast<const float*>(u), static_cast<const float*>(k), D,
                    static_cast<float*>(y), s, ks, us, B, C, L, Lk, p, stream);
}
