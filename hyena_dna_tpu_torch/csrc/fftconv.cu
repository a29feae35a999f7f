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
//  * Sub-FFTs are iterative radix-2 in shared memory: decimation in time
//    (bit-reversed in, natural out) forward, decimation in frequency
//    (natural in, bit-reversed out) inverse, with a per-block twiddle table
//    from sincospif so the angles are exact multiples of pi.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLogN = 21;
constexpr int kMaxLogN1 = 9;
constexpr int kMaxTC = 16;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ int bitrev(int i, int log_m) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - log_m));
}

// exp(-2 pi i j / m) for 0 <= j < m, m a power of two <= 2^21: -2j/m is exact
// in float32, so sincospif sees the exact angle.
__device__ __forceinline__ float2 twiddle(int j, int m) {
  float s, c;
  sincospif(-2.0f * static_cast<float>(j) / static_cast<float>(m), &s, &c);
  return make_float2(c, s);
}

__device__ void fill_twiddles(float2* tw, int m) {
  for (int j = threadIdx.x; j < m / 2; j += blockDim.x) tw[j] = twiddle(j, m);
  __syncthreads();
}

// `count` in-place radix-2 FFTs of size m = 2^log_m in shared memory;
// element i of sequence s sits at data[i * si + s * ss]. `cols` maps
// adjacent threads to adjacent sequences (interleaved column layout, si ==
// count, ss == 1), otherwise to adjacent butterflies of one sequence.
// Decimation in time: bit-reversed input, natural-order output.
__device__ void fft_dit(float2* data, const float2* tw, int m, int log_m,
                        int count, int si, int ss, bool inverse, bool cols) {
  const int hm = m / 2;
  const int nb = hm * count;
  for (int half = 1, ts = hm; half < m; half <<= 1, ts >>= 1) {
    for (int e = threadIdx.x; e < nb; e += blockDim.x) {
      const int s = cols ? e % count : e / hm;
      const int k = cols ? e / count : e % hm;
      const int pos = k & (half - 1);
      const int i0 = ((k - pos) << 1) + pos;
      float2 w = tw[pos * ts];
      if (inverse) w.y = -w.y;
      float2* p0 = data + i0 * si + s * ss;
      float2* p1 = p0 + half * si;
      const float2 a = *p0;
      const float2 b = cmul(*p1, w);
      *p0 = make_float2(a.x + b.x, a.y + b.y);
      *p1 = make_float2(a.x - b.x, a.y - b.y);
    }
    __syncthreads();
  }
}

// Decimation in frequency: natural-order input, bit-reversed output.
__device__ void fft_dif(float2* data, const float2* tw, int m, int log_m,
                        int count, int si, int ss, bool inverse, bool cols) {
  const int hm = m / 2;
  const int nb = hm * count;
  for (int half = hm, ts = 1; half >= 1; half >>= 1, ts <<= 1) {
    for (int e = threadIdx.x; e < nb; e += blockDim.x) {
      const int s = cols ? e % count : e / hm;
      const int k = cols ? e / count : e % hm;
      const int pos = k & (half - 1);
      const int i0 = ((k - pos) << 1) + pos;
      float2 w = tw[pos * ts];
      if (inverse) w.y = -w.y;
      float2* p0 = data + i0 * si + s * ss;
      float2* p1 = p0 + half * si;
      const float2 a = *p0;
      const float2 b = *p1;
      *p0 = make_float2(a.x + b.x, a.y + b.y);
      *p1 = cmul(make_float2(a.x - b.x, a.y - b.y), w);
    }
    __syncthreads();
  }
}

struct Plan {
  int n, log_n, n1, log_n1, n2, log_n2, tc;
};

// Pass 1: z = x[b, 2p] + i x[b, 2p+1] (zero past `len` and past channel C-1),
// column FFTs over t1, twiddle, store A[f1][t2] for blocks of TC columns.
template <typename T>
__global__ void __launch_bounds__(kThreads) cols_fwd_kernel(
    const T* __restrict__ x, int C, int len, Plan p, float2* __restrict__ out) {
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = smem + p.n1 / 2;
  const int col0 = blockIdx.x * p.tc;
  const int pair = blockIdx.y;
  const int b = blockIdx.z;
  const int c = 2 * pair;
  const bool has2 = c + 1 < C;
  const T* x0 = x + (static_cast<int64_t>(b) * C + c) * len;
  const T* x1 = x0 + len;
  fill_twiddles(tw, p.n1);
  for (int e = threadIdx.x; e < p.n1 * p.tc; e += blockDim.x) {
    const int j = e % p.tc;
    const int t1 = e / p.tc;
    const int t = t1 * p.n2 + col0 + j;
    float re = 0.f, im = 0.f;
    if (t < len) {
      re = to_f32(x0[t]);
      if (has2) im = to_f32(x1[t]);
    }
    buf[bitrev(t1, p.log_n1) * p.tc + j] = make_float2(re, im);
  }
  __syncthreads();
  fft_dit(buf, tw, p.n1, p.log_n1, p.tc, p.tc, 1, false, true);
  float2* o = out + (static_cast<int64_t>(b) * gridDim.y + pair) * p.n;
  for (int e = threadIdx.x; e < p.n1 * p.tc; e += blockDim.x) {
    const int j = e % p.tc;
    const int f1 = e / p.tc;
    const int t2 = col0 + j;
    o[static_cast<int64_t>(f1) * p.n2 + t2] = cmul(buf[f1 * p.tc + j], twiddle(f1 * t2, p.n));
  }
}

// Pass 2 for k: forward row FFTs in place, natural order along f2.
__global__ void __launch_bounds__(kThreads) rows_fwd_kernel(float2* __restrict__ a, Plan p) {
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = smem + p.n2 / 2;
  float2* row = a + static_cast<int64_t>(blockIdx.y) * p.n + static_cast<int64_t>(blockIdx.x) * p.n2;
  fill_twiddles(tw, p.n2);
  for (int i = threadIdx.x; i < p.n2; i += blockDim.x) buf[bitrev(i, p.log_n2)] = row[i];
  __syncthreads();
  fft_dit(buf, tw, p.n2, p.log_n2, 1, 1, p.n2, false, false);
  for (int i = threadIdx.x; i < p.n2; i += blockDim.x) row[i] = buf[i];
}

// Pass 2 for u: row f1 = blockIdx.x and its mirror row (N1 - f1) mod N1.
// Forward row FFTs, split the channel pair with the Hermitian mirror, multiply
// by k's pair spectrum, recombine, inverse row FFTs, store in place.
__global__ void __launch_bounds__(kThreads) rows_conv_kernel(
    float2* __restrict__ a, const float2* __restrict__ kspec, Plan p) {
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = smem + p.n2 / 2;
  const int r0 = blockIdx.x;
  const int r1 = (p.n1 - r0) & (p.n1 - 1);
  const int nrows = r0 == r1 ? 1 : 2;
  const int pair = blockIdx.y;
  float2* base = a + (static_cast<int64_t>(blockIdx.z) * gridDim.y + pair) * p.n;
  const float2* ks = kspec + static_cast<int64_t>(pair) * p.n;
  fill_twiddles(tw, p.n2);
  for (int e = threadIdx.x; e < nrows * p.n2; e += blockDim.x) {
    const int rr = e / p.n2;
    const int i = e % p.n2;
    const int r = rr ? r1 : r0;
    buf[rr * p.n2 + bitrev(i, p.log_n2)] = base[static_cast<int64_t>(r) * p.n2 + i];
  }
  __syncthreads();
  fft_dit(buf, tw, p.n2, p.log_n2, nrows, 1, p.n2, false, false);
  float2* z0 = buf;
  float2* z1 = buf + (nrows - 1) * p.n2;
  for (int i = threadIdx.x; i < p.n2; i += blockDim.x) {
    // frequency f = r0 + N1 i; -f lands in row r1 at index m
    const int m = r0 == 0 ? ((p.n2 - i) & (p.n2 - 1)) : p.n2 - 1 - i;
    if (r0 == r1 && m < i) continue;  // a self-mirrored row: each pair once
    const float2 za = z0[i], zb = z1[m];
    const float2 ka = ks[static_cast<int64_t>(r0) * p.n2 + i];
    const float2 kb = ks[static_cast<int64_t>(r1) * p.n2 + m];
    // channel spectra at f: X0 = (Z[f] + conj Z[-f]) / 2, X1 = (Z[f] - conj Z[-f]) / 2i
    const float2 u0 = make_float2(0.5f * (za.x + zb.x), 0.5f * (za.y - zb.y));
    const float2 u1 = make_float2(0.5f * (za.y + zb.y), -0.5f * (za.x - zb.x));
    const float2 k0 = make_float2(0.5f * (ka.x + kb.x), 0.5f * (ka.y - kb.y));
    const float2 k1 = make_float2(0.5f * (ka.y + kb.y), -0.5f * (ka.x - kb.x));
    const float2 p0 = cmul(u0, k0);
    const float2 p1 = cmul(u1, k1);
    // W[f] = P0 + i P1; W[-f] = conj(P0) + i conj(P1) (both outputs are real)
    z0[i] = make_float2(p0.x - p1.y, p0.y + p1.x);
    z1[m] = make_float2(p0.x + p1.y, p1.x - p0.y);
  }
  __syncthreads();
  fft_dif(buf, tw, p.n2, p.log_n2, nrows, 1, p.n2, true, false);
  for (int e = threadIdx.x; e < nrows * p.n2; e += blockDim.x) {
    const int rr = e / p.n2;
    const int i = e % p.n2;
    const int r = rr ? r1 : r0;
    base[static_cast<int64_t>(r) * p.n2 + i] = buf[rr * p.n2 + bitrev(i, p.log_n2)];
  }
}

// Pass 3: conjugate twiddle, inverse column FFTs, 1/n, + u * D, first L outputs.
template <typename T>
__global__ void __launch_bounds__(kThreads) cols_inv_kernel(
    const float2* __restrict__ a, const T* __restrict__ u, const float* __restrict__ D,
    T* __restrict__ y, int C, int L, Plan p) {
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = smem + p.n1 / 2;
  const int col0 = blockIdx.x * p.tc;
  const int pair = blockIdx.y;
  const int b = blockIdx.z;
  const float2* src = a + (static_cast<int64_t>(b) * gridDim.y + pair) * p.n;
  fill_twiddles(tw, p.n1);
  for (int e = threadIdx.x; e < p.n1 * p.tc; e += blockDim.x) {
    const int j = e % p.tc;
    const int f1 = e / p.tc;
    const int t2 = col0 + j;
    float2 w = twiddle(f1 * t2, p.n);
    w.y = -w.y;
    buf[f1 * p.tc + j] = cmul(src[static_cast<int64_t>(f1) * p.n2 + t2], w);
  }
  __syncthreads();
  fft_dif(buf, tw, p.n1, p.log_n1, p.tc, p.tc, 1, true, true);
  const float scale = 1.0f / static_cast<float>(p.n);
  const int c = 2 * pair;
  const bool has2 = c + 1 < C;
  const float d0 = D[c];
  const float d1 = has2 ? D[c + 1] : 0.f;
  const int64_t row0 = (static_cast<int64_t>(b) * C + c) * L;
  for (int e = threadIdx.x; e < p.n1 * p.tc; e += blockDim.x) {
    const int j = e % p.tc;
    const int t1 = e / p.tc;
    const int t = t1 * p.n2 + col0 + j;
    if (t >= L) continue;
    const float2 v = buf[bitrev(t1, p.log_n1) * p.tc + j];
    store(y + row0 + t, v.x * scale + to_f32(u[row0 + t]) * d0);
    if (has2) store(y + row0 + L + t, v.y * scale + to_f32(u[row0 + L + t]) * d1);
  }
}

template <typename T>
int launch_all(const T* u, const T* k, const float* D, T* y, float2* scratch, float2* kspec,
               int B, int C, int L, int Lk, const Plan& p, cudaStream_t stream) {
  const int pairs = (C + 1) / 2;
  const size_t smem_cols = sizeof(float2) * (p.n1 / 2 + p.n1 * p.tc);
  const size_t smem_rows = sizeof(float2) * (p.n2 / 2 + 2 * p.n2);
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
  rows_conv_kernel<<<dim3(p.n1 / 2 + 1, pairs, B), kThreads, smem_rows, stream>>>(scratch, kspec, p);
  cols_inv_kernel<T><<<cols_u, kThreads, smem_cols, stream>>>(scratch, u, D, y, C, L, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u (B, C, L), k (C, Lk), y (B, C, L) contiguous, all float32 (is_bf16 == 0)
// or all bfloat16; D (C,) float32. scratch holds B * ceil(C/2) * n complex64,
// kspec ceil(C/2) * n. Launches on `stream`, does not synchronise; returns
// the cudaError_t of the launches (0 on success).
extern "C" int hyena_fftconv_fwd(const void* u, const void* k, const float* D, void* y,
                                 void* scratch, void* kspec, int B, int C, int L, int Lk,
                                 int n, int is_bf16, cudaStream_t stream) {
  if (n < 16 || (n & (n - 1)) != 0 || n > (1 << kMaxLogN) || L < 1 || 2 * L > n ||
      Lk < 1 || Lk > L || B < 1 || C < 1 || (C + 1) / 2 > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p;
  p.n = n;
  p.log_n = 31 - __builtin_clz(static_cast<unsigned>(n));
  p.log_n1 = p.log_n / 2 < kMaxLogN1 ? p.log_n / 2 : kMaxLogN1;
  p.log_n2 = p.log_n - p.log_n1;
  p.n1 = 1 << p.log_n1;
  p.n2 = 1 << p.log_n2;
  p.tc = p.n2 < kMaxTC ? p.n2 : kMaxTC;
  auto* s = static_cast<float2*>(scratch);
  auto* ks = static_cast<float2*>(kspec);
  if (is_bf16) {
    return launch_all(static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(k), D,
                      static_cast<__nv_bfloat16*>(y), s, ks, B, C, L, Lk, p, stream);
  }
  return launch_all(static_cast<const float*>(u), static_cast<const float*>(k), D,
                    static_cast<float*>(y), s, ks, B, C, L, Lk, p, stream);
}
