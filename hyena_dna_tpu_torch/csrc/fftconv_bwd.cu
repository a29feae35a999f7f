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
//   pass 2  rows_bwd_kernel: one block per (row f1 and its mirror, channel
//           pair) loops over the batch. Per b it row-transforms dy (and u),
//           splits each pair with the Hermitian mirror, forms DY conj(K) for
//           du (inverse row FFT, stored in place of dy's scratch) and adds
//           DY conj(U) into a dk accumulator that the block owns in shared
//           memory -- so the batch sum needs no atomics and is in a fixed
//           order. After the loop it inverse-transforms the accumulator.
//           Shared memory: twiddles N2/2 plus three two-row buffers (dy, u,
//           dk accumulator) = 6.5 N2 complex, 208 KB at N2 = 4096;
//   pass 3  du: inverse column FFTs + dy * D; dk: inverse column FFTs over
//           C rows (no batch), first Lk outputs, with dD read off at t = 0
//           in float32 before dk's rounding (Parseval, as the TPU kernels
//           took dD from their dk accumulator).
#define FFT_NS conv_bwd
#include "fft_common.cuh"

namespace FFT_NS {

constexpr int kRowThreads = 512;

// Pass 2 of the backward. gdy: dy's column pass in, du's inverse row pass
// out, (B, pairs, n). gu: u's column pass (retransform) or u's saved pair
// spectrum (spectrum route), (B, pairs, n). gdk: dk's inverse row pass out,
// (pairs, n).
__global__ void __launch_bounds__(kRowThreads) rows_bwd_kernel(
    float2* __restrict__ gdy, const float2* __restrict__ gu, const float2* __restrict__ kspec,
    float2* __restrict__ gdk, int B, int u_is_spectrum, Plan p) {
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* bdy = tw + p.n2 / 2;
  float2* bu = bdy + 2 * p.n2;
  float2* acc = bu + 2 * p.n2;
  const int r0 = blockIdx.x;
  const int r1 = mirror_row(r0, p);
  const int nrows = r0 == r1 ? 1 : 2;
  const int pair = blockIdx.y;
  const int pairs = gridDim.y;
  const float2* ks = kspec + static_cast<int64_t>(pair) * p.n;
  fill_twiddles(tw, p.n2);
  for (int e = threadIdx.x; e < nrows * p.n2; e += blockDim.x) acc[e] = make_float2(0.f, 0.f);
  float2* y0 = bdy;
  float2* y1 = bdy + (nrows - 1) * p.n2;
  const float2* v0 = bu;
  const float2* v1 = bu + (nrows - 1) * p.n2;
  float2* a0 = acc;
  float2* a1 = acc + (nrows - 1) * p.n2;
  for (int b = 0; b < B; ++b) {
    const int64_t off = (static_cast<int64_t>(b) * pairs + pair) * p.n;
    float2* dyb = gdy + off;
    const float2* ub = gu + off;
    for (int e = threadIdx.x; e < nrows * p.n2; e += blockDim.x) {
      const int rr = e / p.n2;
      const int i = e % p.n2;
      const int64_t src = static_cast<int64_t>(rr ? r1 : r0) * p.n2 + i;
      const int dst = rr * p.n2 + bitrev(i, p.log_n2);
      bdy[dst] = dyb[src];
      bu[u_is_spectrum ? e : dst] = ub[src];
    }
    __syncthreads();
    fft_dit(bdy, tw, p.n2, p.log_n2, nrows, 1, p.n2, false, false);
    if (!u_is_spectrum) fft_dit(bu, tw, p.n2, p.log_n2, nrows, 1, p.n2, false, false);
    for (int i = threadIdx.x; i < p.n2; i += blockDim.x) {
      const int m = mirror_index(r0, i, p);  // f = r0 + N1 i; -f is (r1, m)
      if (r0 == r1 && m < i) continue;       // a self-mirrored row: each pair once
      float2 dy0, dy1, u0, u1, k0, k1;
      split_pair(y0[i], y1[m], dy0, dy1);
      split_pair(v0[i], v1[m], u0, u1);
      split_pair(ks[static_cast<int64_t>(r0) * p.n2 + i], ks[static_cast<int64_t>(r1) * p.n2 + m],
                 k0, k1);
      const float2 p0 = cmulc(dy0, k0);
      const float2 p1 = cmulc(dy1, k1);
      y0[i] = join_pair(p0, p1);
      y1[m] = join_pair_mirror(p0, p1);
      const float2 q0 = cmulc(dy0, u0);
      const float2 q1 = cmulc(dy1, u1);
      const float2 w = join_pair(q0, q1);
      a0[i] = make_float2(a0[i].x + w.x, a0[i].y + w.y);
      if (r0 != r1 || m != i) {  // f == -f (one bin) is accumulated once
        const float2 wm = join_pair_mirror(q0, q1);
        a1[m] = make_float2(a1[m].x + wm.x, a1[m].y + wm.y);
      }
    }
    __syncthreads();
    fft_dif(bdy, tw, p.n2, p.log_n2, nrows, 1, p.n2, true, false);
    for (int e = threadIdx.x; e < nrows * p.n2; e += blockDim.x) {
      const int rr = e / p.n2;
      const int i = e % p.n2;
      dyb[static_cast<int64_t>(rr ? r1 : r0) * p.n2 + i] = bdy[rr * p.n2 + bitrev(i, p.log_n2)];
    }
    __syncthreads();  // the next b overwrites bdy and bu
  }
  fft_dif(acc, tw, p.n2, p.log_n2, nrows, 1, p.n2, true, false);
  float2* dk = gdk + static_cast<int64_t>(pair) * p.n;
  for (int e = threadIdx.x; e < nrows * p.n2; e += blockDim.x) {
    const int rr = e / p.n2;
    const int i = e % p.n2;
    dk[static_cast<int64_t>(rr ? r1 : r0) * p.n2 + i] = acc[rr * p.n2 + bitrev(i, p.log_n2)];
  }
}

template <typename T>
int launch_all(const T* u, const float2* uspec, const T* dy, const T* k, const float* D, T* du,
               T* dk, float* dD, float2* sdy, float2* su, float2* kspec, float2* sdk, int B,
               int C, int L, int Lk, const Plan& p, cudaStream_t stream) {
  const int pairs = (C + 1) / 2;
  const size_t smem_cols = cols_smem_bytes(p);
  const size_t smem_krows = sizeof(float2) * (p.n2 / 2 + 2 * p.n2);
  const size_t smem_rows = sizeof(float2) * (p.n2 / 2 + 6 * p.n2);
  cudaFuncSetAttribute(cols_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem_cols));
  cudaFuncSetAttribute(cols_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem_cols));
  cudaFuncSetAttribute(rows_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem_krows));
  cudaFuncSetAttribute(rows_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem_rows));
  const dim3 cols_c(p.n2 / p.tc, pairs, 1), cols_b(p.n2 / p.tc, pairs, B);
  cols_fwd_kernel<T><<<cols_c, kThreads, smem_cols, stream>>>(k, C, Lk, p, kspec);
  rows_fwd_kernel<<<dim3(p.n1, pairs, 1), kThreads, smem_krows, stream>>>(kspec, p);
  cols_fwd_kernel<T><<<cols_b, kThreads, smem_cols, stream>>>(dy, C, L, p, sdy);
  const float2* gu = uspec;
  if (uspec == nullptr) {
    cols_fwd_kernel<T><<<cols_b, kThreads, smem_cols, stream>>>(u, C, L, p, su);
    gu = su;
  }
  rows_bwd_kernel<<<dim3(p.n1 / 2 + 1, pairs, 1), kRowThreads, smem_rows, stream>>>(
      sdy, gu, kspec, sdk, B, uspec != nullptr, p);
  cols_inv_kernel<T><<<cols_b, kThreads, smem_cols, stream>>>(sdy, dy, D, du, nullptr, C, L, p);
  cols_inv_kernel<T><<<cols_c, kThreads, smem_cols, stream>>>(sdk, nullptr, nullptr, dk, dD, C,
                                                              Lk, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace FFT_NS

// dy, du (B, C, L), k, dk (C, Lk) contiguous, all float32 (is_bf16 == 0) or
// all bfloat16; D, dD (C,) float32. Exactly one of u (B, C, L) and uspec
// (kernel B's saved spectrum, B * ceil(C/2) * n complex64) is non-null; su
// (B * ceil(C/2) * n complex64) is scratch for u's transform and may be null
// with uspec. sdy holds B * ceil(C/2) * n complex64, kspec and sdk
// ceil(C/2) * n each. Launches on `stream`, does not synchronise; returns
// the cudaError_t of the launches (0 on success).
extern "C" int hyena_fftconv_bwd(const void* u, const void* uspec, const void* dy, const void* k,
                                 const float* D, void* du, void* dk, float* dD, void* sdy,
                                 void* su, void* kspec, void* sdk, int B, int C, int L, int Lk,
                                 int n, int is_bf16, cudaStream_t stream) {
  using namespace FFT_NS;
  if (!valid_fft_size(n) || L < 1 || 2 * L > n || Lk < 1 || Lk > L || B < 1 || C < 1 ||
      (C + 1) / 2 > 65535 || B > 65535 || (u == nullptr) == (uspec == nullptr) ||
      (u != nullptr && su == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(n);
  auto* us = static_cast<const float2*>(uspec);
  auto f2 = [](void* q) { return static_cast<float2*>(q); };
  if (is_bf16) {
    using bf = __nv_bfloat16;
    return launch_all(static_cast<const bf*>(u), us, static_cast<const bf*>(dy),
                      static_cast<const bf*>(k), D, static_cast<bf*>(du), static_cast<bf*>(dk), dD,
                      f2(sdy), f2(su), f2(kspec), f2(sdk), B, C, L, Lk, p, stream);
  }
  return launch_all(static_cast<const float*>(u), us, static_cast<const float*>(dy),
                    static_cast<const float*>(k), D, static_cast<float*>(du),
                    static_cast<float*>(dk), dD, f2(sdy), f2(su), f2(kspec), f2(sdk), B, C, L, Lk,
                    p, stream);
}
