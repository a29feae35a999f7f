// Four-step FFT pieces shared by the conv kernels: B (fftconv.cu, the
// causal conv), C (fftconv_bwd.cu, its backward), E (fftconv_gated.cu, the
// conv with the Hyena post-gate) and E' (fftconv_gated_bwd.cu, its
// backward). Each .cu file is its own shared library; the including file
// defines FFT_NS so the libraries' kernels carry different names in a
// profiler trace.
//
// Layout: n = N1 * N2 (N1 <= 512, N2 <= 4096), time t = N2 * t1 + t2 and
// frequency f = f1 + N1 * f2. A channel pair (c, c+1) shares one complex
// transform of z = x_c + i x_{c+1}; the two real spectra are split again
// with the Hermitian mirror Z[-f] wherever a product needs them.
//   pass 1  column FFTs of size N1 (blocks of TC adjacent columns) times
//           the twiddle W_n^(t2 f1) -> A[f1][t2] in a complex scratch of n
//           per (batch, pair); what the pass reads is a "source" (the
//           signal, or the gated kernels' products of two signals);
//   pass 2  row FFTs of size N2 along t2 -> the spectrum at f1 + N1 f2, in
//           natural f2 order: rows_fwd_kernel (the filter), rows_conv_kernel
//           (the forward conv's transform, product and inverse),
//           rows_bwd_kernel (the backward's du rows and dk's batch sum);
//   pass 3  conjugate twiddle, inverse column FFTs, scale 1/n, the first
//           `len` outputs handed to a "sink" (the D skip term, or the gated
//           kernels' epilogues).
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

// Column passes, generic over what a pass reads and writes. A source gives
// the channel pair (c, c+1) at time t < len as z = x_c + i x_{c+1}; a sink
// takes the pair's two float32 outputs at t < len. Each is a small struct
// copied into every thread; `begin` fixes the block's (b, c) once, so the
// inner loops index from one row offset, as a hand-written loop would.

// Pass 1 source: the signal itself.
template <typename T>
struct PairSource {
  const T* x;
  int64_t row0, len;
  bool has2;
  __device__ __forceinline__ void begin(int b, int c, int C, int len_, bool has2_) {
    row0 = (static_cast<int64_t>(b) * C + c) * len_;
    len = len_;
    has2 = has2_;
  }
  __device__ __forceinline__ float2 operator()(int t) const {
    float re = to_f32(x[row0 + t]), im = 0.f;
    if (has2) im = to_f32(x[row0 + len + t]);
    return make_float2(re, im);
  }
};

// Pass 3 sink: y = value (+ x * D), with dD (if given) the float32 value at
// t = 0 of each channel (before y's rounding).
template <typename T>
struct SkipSink {
  const T* x;
  const float* D;
  T* y;
  float* dD;
  int64_t row0, len;
  int c;
  bool has2;
  float d0, d1;
  __device__ __forceinline__ void begin(int b, int c_, int C, int len_, bool has2_) {
    row0 = (static_cast<int64_t>(b) * C + c_) * len_;
    len = len_;
    c = c_;
    has2 = has2_;
    d0 = D != nullptr ? D[c] : 0.f;
    d1 = (D != nullptr && has2) ? D[c + 1] : 0.f;
  }
  __device__ __forceinline__ void operator()(int t, float y0, float y1) const {
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
};

// Pass 1: z from `src` (zero past `len` and past channel C-1), column FFTs
// over t1, twiddle, store A[f1][t2] for blocks of TC columns.
template <typename Src>
__device__ __forceinline__ void cols_fwd_body(Src src, int C, int len, const Plan& p,
                                              float2* __restrict__ out) {
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = smem + p.n1 / 2;
  const int col0 = blockIdx.x * p.tc;
  const int pair = blockIdx.y;
  const int b = blockIdx.z;
  const int c = 2 * pair;
  src.begin(b, c, C, len, c + 1 < C);
  fill_twiddles(tw, p.n1);
  for (int e = threadIdx.x; e < p.n1 * p.tc; e += blockDim.x) {
    const int j = e % p.tc;
    const int t1 = e / p.tc;
    const int t = t1 * p.n2 + col0 + j;
    buf[bitrev(t1, p.log_n1) * p.tc + j] = t < len ? src(t) : make_float2(0.f, 0.f);
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

template <typename T>
__global__ void __launch_bounds__(kThreads) cols_fwd_kernel(
    const T* __restrict__ x, int C, int len, Plan p, float2* __restrict__ out) {
  cols_fwd_body(PairSource<T>{x}, C, len, p, out);
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

// Pass 3: conjugate twiddle, inverse column FFTs, 1/n, the first `len`
// outputs handed to `sink`.
template <typename Sink>
__device__ __forceinline__ void cols_inv_body(const float2* __restrict__ a, Sink sink, int C,
                                              int len, const Plan& p) {
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
  sink.begin(b, c, C, len, c + 1 < C);
  for (int e = threadIdx.x; e < p.n1 * p.tc; e += blockDim.x) {
    const int j = e % p.tc;
    const int t1 = e / p.tc;
    const int t = t1 * p.n2 + col0 + j;
    if (t >= len) continue;
    const float2 v = buf[bitrev(t1, p.log_n1) * p.tc + j];
    sink(t, v.x * scale, v.y * scale);
  }
}

// Pass 3 with the D skip term x * D (x in y's layout); with dD, also writes
// the float32 value at t = 0 of each channel (before y's rounding).
template <typename T>
__global__ void __launch_bounds__(kThreads) cols_inv_kernel(
    const float2* __restrict__ a, const T* __restrict__ x, const float* __restrict__ D,
    T* __restrict__ y, float* __restrict__ dD, int C, int len, Plan p) {
  cols_inv_body(a, SkipSink<T>{x, D, y, dD}, C, len, p);
}

// Pass 2 of the forward conv: row f1 = blockIdx.x and its mirror row
// (N1 - f1) mod N1. Forward row FFTs, split the channel pair with the
// Hermitian mirror, multiply by k's pair spectrum, recombine, inverse row
// FFTs, store in place. With `uspec`, the forward row spectra (u's pair
// spectrum at f1 + N1 f2, natural f2 order, the layout the backward reads)
// are stored there before the product.
__global__ void __launch_bounds__(kThreads) rows_conv_kernel(
    float2* __restrict__ a, const float2* __restrict__ kspec, float2* __restrict__ uspec, Plan p) {
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = smem + p.n2 / 2;
  const int r0 = blockIdx.x;
  const int r1 = mirror_row(r0, p);
  const int nrows = r0 == r1 ? 1 : 2;
  const int pair = blockIdx.y;
  const int64_t off = (static_cast<int64_t>(blockIdx.z) * gridDim.y + pair) * p.n;
  float2* base = a + off;
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
  if (uspec != nullptr) {
    for (int e = threadIdx.x; e < nrows * p.n2; e += blockDim.x) {
      const int rr = e / p.n2;
      const int i = e % p.n2;
      const int r = rr ? r1 : r0;
      uspec[off + static_cast<int64_t>(r) * p.n2 + i] = buf[e];
    }
    __syncthreads();
  }
  float2* z0 = buf;
  float2* z1 = buf + (nrows - 1) * p.n2;
  for (int i = threadIdx.x; i < p.n2; i += blockDim.x) {
    const int m = mirror_index(r0, i, p);  // f = r0 + N1 i; -f is (r1, m)
    if (r0 == r1 && m < i) continue;       // a self-mirrored row: each pair once
    float2 u0, u1, k0, k1;
    split_pair(z0[i], z1[m], u0, u1);
    split_pair(ks[static_cast<int64_t>(r0) * p.n2 + i], ks[static_cast<int64_t>(r1) * p.n2 + m], k0, k1);
    const float2 p0 = cmul(u0, k0);
    const float2 p1 = cmul(u1, k1);
    z0[i] = join_pair(p0, p1);
    z1[m] = join_pair_mirror(p0, p1);
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

constexpr int kRowThreads = 512;

// Pass 2 of the backward conv. gdy: dy's column pass in, du's inverse row
// pass out, (B, pairs, n). gu: u's column pass (u_is_spectrum == 0) or u's
// pair spectrum in the layout rows_conv_kernel saves, (B, pairs, n). gdk:
// dk's inverse row pass out, (pairs, n). One block per (row f1 and its
// mirror, channel pair) loops over the batch and owns dk's accumulator in
// shared memory, so the batch sum needs no atomics and is in a fixed order.
// With kspec null (the dk-spectrum mode) there is no du: the block stops
// after the batch sum and stores sum_b DY conj(U) as a pair spectrum, row
// f1 in natural f2 order, with no inverse.
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
  const bool with_du = kspec != nullptr;
  const float2* ks = with_du ? kspec + static_cast<int64_t>(pair) * p.n : nullptr;
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
      float2 dy0, dy1, u0, u1;
      split_pair(y0[i], y1[m], dy0, dy1);
      split_pair(v0[i], v1[m], u0, u1);
      if (with_du) {
        float2 k0, k1;
        split_pair(ks[static_cast<int64_t>(r0) * p.n2 + i],
                   ks[static_cast<int64_t>(r1) * p.n2 + m], k0, k1);
        const float2 p0 = cmulc(dy0, k0);
        const float2 p1 = cmulc(dy1, k1);
        y0[i] = join_pair(p0, p1);
        y1[m] = join_pair_mirror(p0, p1);
      }
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
    if (with_du) {
      fft_dif(bdy, tw, p.n2, p.log_n2, nrows, 1, p.n2, true, false);
      for (int e = threadIdx.x; e < nrows * p.n2; e += blockDim.x) {
        const int rr = e / p.n2;
        const int i = e % p.n2;
        dyb[static_cast<int64_t>(rr ? r1 : r0) * p.n2 + i] = bdy[rr * p.n2 + bitrev(i, p.log_n2)];
      }
    }
    __syncthreads();  // the next b overwrites bdy and bu
  }
  if (with_du) fft_dif(acc, tw, p.n2, p.log_n2, nrows, 1, p.n2, true, false);
  float2* dk = gdk + static_cast<int64_t>(pair) * p.n;
  for (int e = threadIdx.x; e < nrows * p.n2; e += blockDim.x) {
    const int rr = e / p.n2;
    const int i = e % p.n2;
    dk[static_cast<int64_t>(rr ? r1 : r0) * p.n2 + i] =
        acc[rr * p.n2 + (with_du ? bitrev(i, p.log_n2) : i)];
  }
}

inline size_t cols_smem_bytes(const Plan& p) { return sizeof(float2) * (p.n1 / 2 + p.n1 * p.tc); }
// rows_fwd_kernel and rows_conv_kernel: twiddles and two rows
inline size_t rows_smem_bytes(const Plan& p) { return sizeof(float2) * (p.n2 / 2 + 2 * p.n2); }
// rows_bwd_kernel: twiddles and three two-row buffers (dy, u, dk's sum),
// 208 KB at N2 = 4096
inline size_t rows_bwd_smem_bytes(const Plan& p) { return sizeof(float2) * (p.n2 / 2 + 6 * p.n2); }

}  // namespace FFT_NS
