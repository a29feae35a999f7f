// Four-step FFT pieces shared by kernel B (fftconv.cu, the causal conv) and
// kernel C (fftconv_bwd.cu, its backward). Each .cu file is its own shared
// library; the including file defines FFT_NS so the two libraries' kernels
// carry different names in a profiler trace.
//
// Layout: n = N1 * N2 (N1 <= 512, N2 <= 4096), time t = N2 * t1 + t2 and
// frequency f = f1 + N1 * f2. A channel pair (c, c+1) shares one complex
// transform of z = x_c + i x_{c+1}; the two real spectra are split again
// with the Hermitian mirror Z[-f] wherever a product needs them.
//   pass 1  column FFTs of size N1 (blocks of TC adjacent columns) times
//           the twiddle W_n^(t2 f1) -> A[f1][t2] in a complex scratch of n
//           per (batch, pair);
//   pass 2  row FFTs of size N2 along t2 -> the spectrum at f1 + N1 f2, in
//           natural f2 order (kernel-specific; rows_fwd_kernel here is the
//           forward-only form);
//   pass 3  conjugate twiddle, inverse column FFTs, scale 1/n, optional
//           + x * D skip, first `len` outputs stored.
// Sub-FFTs are iterative radix-2 in shared memory: decimation in time
// (bit-reversed in, natural out) forward, decimation in frequency (natural
// in, bit-reversed out) inverse, with a per-block twiddle table from
// sincospif so the angles are exact multiples of pi.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#ifndef FFT_NS
#error "define FFT_NS before including fft_common.cuh"
#endif

namespace FFT_NS {

constexpr int kThreads = 256;
constexpr int kMaxLogN = 21;
constexpr int kMaxLogN1 = 9;
constexpr int kMaxTC = 16;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
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

inline Plan make_plan(int n) {
  Plan p;
  p.n = n;
  p.log_n = 31 - __builtin_clz(static_cast<unsigned>(n));
  p.log_n1 = p.log_n / 2 < kMaxLogN1 ? p.log_n / 2 : kMaxLogN1;
  p.log_n2 = p.log_n - p.log_n1;
  p.n1 = 1 << p.log_n1;
  p.n2 = 1 << p.log_n2;
  p.tc = p.n2 < kMaxTC ? p.n2 : kMaxTC;
  return p;
}

inline bool valid_fft_size(int n) {
  return n >= 16 && (n & (n - 1)) == 0 && n <= (1 << kMaxLogN);
}

// frequency f = r0 + N1 * i sits in row r0 at index i; -f sits in row
// mirror_row(r0) at mirror_index(r0, i)
__device__ __forceinline__ int mirror_row(int r0, const Plan& p) { return (p.n1 - r0) & (p.n1 - 1); }
__device__ __forceinline__ int mirror_index(int r0, int i, const Plan& p) {
  return r0 == 0 ? ((p.n2 - i) & (p.n2 - 1)) : p.n2 - 1 - i;
}

// Channel spectra at f from a pair spectrum: X0 = (Z[f] + conj Z[-f]) / 2,
// X1 = (Z[f] - conj Z[-f]) / 2i, with za = Z[f] and zb = Z[-f].
__device__ __forceinline__ void split_pair(float2 za, float2 zb, float2& x0, float2& x1) {
  x0 = make_float2(0.5f * (za.x + zb.x), 0.5f * (za.y - zb.y));
  x1 = make_float2(0.5f * (za.y + zb.y), -0.5f * (za.x - zb.x));
}

// The pair spectrum of two real outputs with spectra P0, P1 at f:
// W[f] = P0 + i P1 and W[-f] = conj(P0) + i conj(P1).
__device__ __forceinline__ float2 join_pair(float2 p0, float2 p1) {
  return make_float2(p0.x - p1.y, p0.y + p1.x);
}
__device__ __forceinline__ float2 join_pair_mirror(float2 p0, float2 p1) {
  return make_float2(p0.x + p1.y, p1.x - p0.y);
}

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

// Pass 2 for the filter: forward row FFTs in place, natural order along f2.
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

// Pass 3: conjugate twiddle, inverse column FFTs, 1/n, first `len` outputs.
// With D, adds the skip term x * D (x in y's layout); with dD, also writes
// the float32 value at t = 0 of each channel (before y's rounding).
template <typename T>
__global__ void __launch_bounds__(kThreads) cols_inv_kernel(
    const float2* __restrict__ a, const T* __restrict__ x, const float* __restrict__ D,
    T* __restrict__ y, float* __restrict__ dD, int C, int len, Plan p) {
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
  const float d0 = D != nullptr ? D[c] : 0.f;
  const float d1 = (D != nullptr && has2) ? D[c + 1] : 0.f;
  const int64_t row0 = (static_cast<int64_t>(b) * C + c) * len;
  for (int e = threadIdx.x; e < p.n1 * p.tc; e += blockDim.x) {
    const int j = e % p.tc;
    const int t1 = e / p.tc;
    const int t = t1 * p.n2 + col0 + j;
    if (t >= len) continue;
    const float2 v = buf[bitrev(t1, p.log_n1) * p.tc + j];
    float y0 = v.x * scale, y1 = v.y * scale;
    if (D != nullptr) {
      y0 += to_f32(x[row0 + t]) * d0;
      if (has2) y1 += to_f32(x[row0 + len + t]) * d1;
    }
    store(y + row0 + t, y0);
    if (has2) store(y + row0 + len + t, y1);
    if (dD != nullptr && t == 0) {
      dD[c] = y0;
      if (has2) dD[c + 1] = y1;
    }
  }
}

inline size_t cols_smem_bytes(const Plan& p) { return sizeof(float2) * (p.n1 / 2 + p.n1 * p.tc); }

}  // namespace FFT_NS
