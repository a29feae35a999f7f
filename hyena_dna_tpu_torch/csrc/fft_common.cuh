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
//   pass 1  column FFTs of size N1 (blocks of TC <= 16 adjacent columns)
//           times the twiddle W_n^(t2 f1) -> A[f1][t2] in a complex scratch
//           of n per (batch, pair); what the pass reads is a "source" (the
//           signal, or the gated kernels' products of two signals);
//   pass 2  row FFTs of size N2 along t2 -> the spectrum at f1 + N1 f2, in
//           natural f2 order: rows_fwd_kernel (the filter), rows_conv_kernel
//           (the conv's transform, product with K and inverse), and the
//           backward kernels' gradient row pass (fft_grad_common.cuh, which
//           C and E' share); a block owns a few rows f1 and their Hermitian
//           mirrors N1 - f1;
//   pass 3  conjugate twiddle, inverse column FFTs, scale 1/n, the first
//           `len` outputs handed to a "sink" (the D skip term, or the gated
//           kernels' epilogues).
//
// Sub-FFTs (fft below): mixed-radix Stockham passes, natural order in and
// natural order out, forward and inverse alike. A size m = 2^log_m
// transform takes ceil(log_m / 4) passes of radix R = 2^LR (LR <= 4, the
// bits split as evenly as possible: 4096 = 16 16 16, 2048 = 16 16 8,
// 512 = 8 8 8, 256 = 16 16). In the pass with stride Ns (the product of the
// earlier radices) item q of a sequence takes the R values at
// q + r m / R, multiplies value r by W_(Ns R)^(r (q mod Ns)), runs an
// R-point DFT in registers (LR radix-2 stages on constants) and puts
// output r at (q / Ns) Ns R + q mod Ns + r Ns. A thread holds the values of
// its items (16 complex) in registers through a pass, so a pass reads and
// writes shared memory once and needs one barrier (two where it reads and
// writes the same buffer): a 4096-point row takes 2 exchanges through
// shared memory, not 12 radix-2 stages. The first pass reads straight from
// its source (device memory, or the block's buffer) and the last hands its
// outputs straight to their consumer, with the four-step twiddles folded
// into those two ends. Twiddles come from exact angles: sincospif of
// j / 2^k (one per item and pass; the item's powers by products in
// registers), and the DFTs' W_16 constants; no table. Every kernel is
// compiled three times (kRadix): for sub-FFTs of 16, 256 or 4096 points
// (radix-16 passes only: the main shapes' rows, and their columns at
// 2^16), of 8, 64 or 512 points (radix 8 only: the columns from 2^18) and
// for the plan's sizes of neither class (kSchedLogN1, kSchedLogN2: the
// 128-point columns of 2^19 and the 4-point passes of 2^4 and 2^5), each
// at a compile-time schedule of its own (fft_sched), so no class's register
// allocation pays for another's code. No four-step pass chooses its radices
// at run time (the short path's any-size transform for 2^4-2^9, fft_any in
// fft_short.cuh, does).
//
// Shared layouts: columns interleaved (element i of column s at
// TC i + s; with TC = 16 a half-warp touches 16 adjacent float2, no bank
// conflict; with TC = 8, at N1 = 512, a swizzle keeps the two elements a
// half-warp touches in distinct banks);
// rows padded by one float2 per 16 (element i of row s at
// s * (m + m/16) + i + i/16), so a pass's stride-R writes fall in distinct
// banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#ifndef FFT_NS
#error "define FFT_NS before including fft_common.cuh"
#endif

namespace FFT_NS {

constexpr int kMaxLogN = 21;
constexpr int kMaxLogTC = 4;
// A thread holds kElems complex values in registers through a pass; a block
// transforms about kBlockElems values (TC columns of N1, or rows of N2), so
// 256 threads, two blocks an SM; a row and its mirror at N2 = 4096 take 512.
constexpr int kElems = 16;
constexpr int kBlockElems = 4096;
constexpr int kMaxThreads = 512;

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

// exp(i pi a); the callers' a = +-2 j / 2^k is exact in float32
__device__ __forceinline__ float2 cis_pi(float a) {
  float s, c;
  sincospif(a, &s, &c);
  return make_float2(c, s);
}

// W_n^(sign j), W_n = exp(-2 pi i / n), n a power of two, j reduced mod n
__device__ __forceinline__ float2 twiddle(int j, int n, bool inverse) {
  const float a = 2.0f * static_cast<float>(j & (n - 1)) / static_cast<float>(n);
  return cis_pi(inverse ? a : -a);
}

// ---------------------------------------------------------------------------
// The sub-FFT core.

// static_for<N>(f) calls f(Index<i>) for i < N in order, so a pass's
// items index its register array by constants (a rolled loop over them
// would put the array in local memory).
template <int I>
struct Index {
  static constexpr int value = I;
  __host__ __device__ constexpr operator int() const { return I; }
};
template <int N, int I = 0, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(Index<I>{});
    static_for<N, I + 1>(f);
  }
}

// cos and sin of 2 pi j / 16, 0 <= j < 8
__host__ __device__ constexpr float cos16(int j) {
  constexpr float kC1 = 0.92387953251128674f;  // cos(pi / 8)
  constexpr float kS1 = 0.38268343236508978f;  // sin(pi / 8)
  constexpr float kH = 0.70710678118654752f;   // sqrt(1/2)
  return j == 0 ? 1.f : j == 1 ? kC1 : j == 2 ? kH : j == 3 ? kS1 : j == 4 ? 0.f
       : j == 5 ? -kS1 : j == 6 ? -kH : -kC1;
}
__host__ __device__ constexpr float sin16(int j) { return cos16(j < 4 ? 4 - j : j - 4); }

// x * W_16^j for 0 <= j < 8 (W_16 = exp(-2 pi i / 16); its conjugate with
// kInv); j is a constant wherever dft unrolls
template <bool kInv>
__device__ __forceinline__ float2 rot16(float2 x, int j) {
  if (j == 0) return x;
  if (j == 4) return kInv ? make_float2(-x.y, x.x) : make_float2(x.y, -x.x);
  const float c = cos16(j), s = kInv ? sin16(j) : -sin16(j);
  return make_float2(x.x * c - x.y * s, x.x * s + x.y * c);
}

__host__ __device__ constexpr int reverse_bits(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

// In-order R-point DFT of v in registers, R = 2^LR <= 16: radix-2
// decimation in time, its bit-reversed input order a renaming of registers.
// Two spellings of the same arithmetic: loops the compiler unrolls (kLoops,
// the radix-16 kernels) and compile-time recursion (static_for, the
// others). Measured on the H100, each compiles to registers only in its own
// kind of kernel: nvcc left the radix-8 loops rolled (the array went to
// local memory), and the recursion spilled around radix 16.
template <int LR, bool kInv, bool kLoops>
__device__ __forceinline__ void dft(float2 (&v)[1 << LR]) {
  constexpr int R = 1 << LR;
  float2 t[R];
  if constexpr (kLoops) {
#pragma unroll
    for (int i = 0; i < R; ++i) t[i] = v[reverse_bits(i, LR)];
#pragma unroll
    for (int lh = 0; lh < LR; ++lh) {
      const int half = 1 << lh;
#pragma unroll
      for (int k = 0; k < R / 2; ++k) {
        const int pos = k & (half - 1);
        const int i0 = ((k - pos) << 1) + pos;
        const float2 a = t[i0];
        const float2 b = rot16<kInv>(t[i0 + half], pos << (3 - lh));
        t[i0] = make_float2(a.x + b.x, a.y + b.y);
        t[i0 + half] = make_float2(a.x - b.x, a.y - b.y);
      }
    }
  } else {
    static_for<R>([&](auto i) { t[decltype(i)::value] = v[reverse_bits(decltype(i)::value, LR)]; });
    static_for<LR>([&](auto lh) {
      constexpr int kHalf = 1 << decltype(lh)::value;
      static_for<R / 2>([&](auto k) {
        constexpr int kPos = decltype(k)::value & (kHalf - 1);
        constexpr int kI0 = ((decltype(k)::value - kPos) << 1) + kPos;
        const float2 a = t[kI0];
        const float2 b = rot16<kInv>(t[kI0 + kHalf], kPos << (3 - decltype(lh)::value));
        t[kI0] = make_float2(a.x + b.x, a.y + b.y);
        t[kI0 + kHalf] = make_float2(a.x - b.x, a.y - b.y);
      });
    });
  }
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = t[i];
}

// Items of `count` sequences: item e is item q of sequence s. Columns put
// adjacent items' sequences side by side (count = 2^log_c), rows their q.
struct ColMap {
  int log_c;
  __device__ __forceinline__ int seq(int e, int) const { return e & ((1 << log_c) - 1); }
  __device__ __forceinline__ int item(int e, int) const { return e >> log_c; }
};
struct RowMap {
  __device__ __forceinline__ int seq(int e, int log_q) const { return e >> log_q; }
  __device__ __forceinline__ int item(int e, int log_q) const { return e & ((1 << log_q) - 1); }
};

// Shared layouts: the index of element i of sequence s.
struct ColLayout {
  int log_c;
  // with 8 columns a half-warp spans two elements i; rows of the other
  // parity of i / 8 are swapped in pairs, so the radix-8 passes' stride-8
  // writes do not meet in one bank
  __device__ __forceinline__ int operator()(int s, int i) const {
    const int x = (i << log_c) + s;
    return log_c == 3 ? x ^ (i & 8) : x;
  }
};
__host__ __device__ constexpr int padded(int m) { return m + (m >> 4); }
struct RowLayout {
  int stride;  // padded(m)
  __device__ __forceinline__ int operator()(int s, int i) const {
    return s * stride + i + (i >> 4);
  }
};

// The ends of a transform are functors: get(s, base, stride, v) loads the
// R values base + r stride of sequence s, put(s, base, stride, v) stores
// them. kShared says that other threads of the block may read or write the
// same storage within the transform (its buffer, or rows it transforms in
// place): a pass that reads and writes such storage synchronises between.
template <typename Layout>
struct SharedIO {
  static constexpr bool kShared = true;
  float2* buf;
  Layout lay;
  template <int R>
  __device__ __forceinline__ void get(int s, int base, int stride, float2 (&v)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = buf[lay(s, base + r * stride)];
  }
  template <int R>
  __device__ __forceinline__ void put(int s, int base, int stride, const float2 (&v)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) buf[lay(s, base + r * stride)] = v[r];
  }
};

// One Stockham pass of radix 2^LR (see the header).
template <int LR, bool kInv, bool kLoops, class In, class Out, class Map>
__device__ __forceinline__ void fft_pass(const In& in, const Out& out, const Map& map, int log_m,
                                         int log_ns, int count) {
  constexpr int R = 1 << LR;
  constexpr int kItems = kElems / R;
  const int log_q = log_m - LR;
  const int total = count << log_q;
  float2 v[kItems][R];
  static_for<kItems>([&](auto it) {
    const int e = threadIdx.x + decltype(it)::value * blockDim.x;
    if (e < total) {
      in.get(map.seq(e, log_q), map.item(e, log_q), 1 << log_q, v[decltype(it)::value]);
    }
  });
  if (In::kShared && Out::kShared) __syncthreads();
  const int ns_mask = (1 << log_ns) - 1;
  static_for<kItems>([&](auto it) {
    float2 (&w)[R] = v[decltype(it)::value];
    const int e = threadIdx.x + decltype(it)::value * blockDim.x;
    if (e < total) {
      const int q = map.item(e, log_q);
      const int j = q & ns_mask;
      if (j != 0) {
        const float a = 2.0f * static_cast<float>(j) / static_cast<float>(R << log_ns);
        const float2 w1 = cis_pi(kInv ? a : -a);
        float2 wr = w1;
#pragma unroll
        for (int r = 1; r < R; ++r) {
          w[r] = cmul(w[r], wr);
          wr = cmul(wr, w1);
        }
      }
      dft<LR, kInv, kLoops>(w);
      out.put(map.seq(e, log_q), ((q >> log_ns) << (log_ns + LR)) + j, 1 << log_ns, w);
    }
  });
  if (Out::kShared) __syncthreads();
}

// Compile-time schedules. A transform of 2^kLogM points whose passes'
// radices are constants: ceil(kLogM / 4) passes, the bits split as evenly
// as possible, the larger first (128 = 16 8, 1024 = 16 8 8, 2048 = 16 16 8,
// 8192 = 16 8 8 8). Radix-16 DFTs take the loops spelling, the others the
// recursion (see dft).
__host__ __device__ constexpr int sched_passes(int log_m) { return (log_m + 3) / 4; }
// log2 of the radix of pass p
__host__ __device__ constexpr int sched_lr(int log_m, int p) {
  return log_m / sched_passes(log_m) + (p < log_m % sched_passes(log_m) ? 1 : 0);
}
// log2 of pass p's stride Ns, the product of the earlier radices
__host__ __device__ constexpr int sched_log_ns(int log_m, int p) {
  int s = 0;
  for (int i = 0; i < p; ++i) s += sched_lr(log_m, i);
  return s;
}

// fft's transform (see fft) at the compile-time schedule of 2^kLogM points.
template <int kLogM, bool kInv, class In, class Out, class Map, class Layout>
__device__ __forceinline__ void fft_sched(const In& in, const Out& out, const Map& map,
                                          const SharedIO<Layout>& mid, int count) {
  constexpr int kPasses = sched_passes(kLogM);
  static_for<kPasses>([&](auto pi) {
    constexpr int p = decltype(pi)::value;
    constexpr int kLR = sched_lr(kLogM, p);
    constexpr int kLogNs = sched_log_ns(kLogM, p);
    constexpr bool kLoops = kLR == 4;
    if constexpr (kPasses == 1) {
      fft_pass<kLR, kInv, kLoops>(in, out, map, kLogM, kLogNs, count);
    } else if constexpr (p == 0) {
      fft_pass<kLR, kInv, kLoops>(in, mid, map, kLogM, kLogNs, count);
    } else if constexpr (p == kPasses - 1) {
      fft_pass<kLR, kInv, kLoops>(mid, out, map, kLogM, kLogNs, count);
    } else {
      fft_pass<kLR, kInv, kLoops>(mid, mid, map, kLogM, kLogNs, count);
    }
  });
}

// The plan's sub-FFT sizes 2^log_m of neither radix class (kPlanLogN1
// below), each transformed at its compile-time schedule (fft_sched): the
// columns (N1) of 4 points (the passes at 2^4 and 2^5) and of
// 128 (2^19, 16 8), the rows (N2) of 4 (2^4). tests/test_torch_port_plan.py
// reads these sizes.
constexpr int kSchedLogN1[] = {2, 7};
constexpr int kSchedLogN2[] = {2};
constexpr int kSchedCountN1 = sizeof(kSchedLogN1) / sizeof(int);
constexpr int kSchedCountN2 = sizeof(kSchedLogN2) / sizeof(int);
// entry i of each, for device code (a constant-expression call reads a host
// constexpr array there)
__host__ __device__ constexpr int sched_log_n1(int i) { return kSchedLogN1[i]; }
__host__ __device__ constexpr int sched_log_n2(int i) { return kSchedLogN2[i]; }

// `count` transforms of size 2^log_m (natural order in and out) from `in`
// to `out`, the passes between exchanging through `mid`; blockDim * kElems
// >= count * 2^log_m. Every thread of the block calls it. kRadix 16 or 8:
// log_m is a multiple of 4 or 3 and every pass has that radix; 0: log_m is
// one of kSchedLogN1 in a column pass (ColMap) or of kSchedLogN2 in a row
// pass, at its compile-time schedule. The kernels of each class are
// compiled apart; launch picks the class, and radix_class refuses any
// other size.
template <bool kInv, int kRadix, class In, class Out, class Map, class Layout>
__device__ void fft(const In& in, const Out& out, const Map& map, const SharedIO<Layout>& mid,
                    int log_m, int count) {
  if constexpr (kRadix != 0) {
    constexpr int kLR = kRadix == 16 ? 4 : 3;
    constexpr bool kLoops = kRadix == 16;
    const int passes = log_m / kLR;
    if (passes == 1) {
      fft_pass<kLR, kInv, kLoops>(in, out, map, log_m, 0, count);
      return;
    }
    for (int p = 0, log_ns = 0; p < passes; ++p, log_ns += kLR) {
      if (p == 0) {
        fft_pass<kLR, kInv, kLoops>(in, mid, map, log_m, log_ns, count);
      } else if (p == passes - 1) {
        fft_pass<kLR, kInv, kLoops>(mid, out, map, log_m, log_ns, count);
      } else {
        fft_pass<kLR, kInv, kLoops>(mid, mid, map, log_m, log_ns, count);
      }
    }
  } else {
    constexpr bool kCols = std::is_same<Map, ColMap>::value;
    static_for<kCols ? kSchedCountN1 : kSchedCountN2>([&](auto i) {
      constexpr int kLogM = kCols ? sched_log_n1(decltype(i)::value)
                                  : sched_log_n2(decltype(i)::value);
      if (log_m == kLogM) fft_sched<kLogM, kInv>(in, out, map, mid, count);
    });
  }
}

// ---------------------------------------------------------------------------
// The four-step plan.

struct Plan {
  int n, log_n, n1, log_n1, n2, log_n2;
  int tc, log_tc;  // columns a block of passes 1 and 3 owns: TC N1 <= kBlockElems
  int g;           // (row, mirror row) pairs a row-pair block owns: 2 g N2 <= kBlockElems
  int rpb;         // rows a rows_fwd_kernel block owns
};

// log2 N1 at n = 2^log_n (ops/fused_fftconv.py::_four_step reads this
// table, and tests/test_torch_port_plan.py holds it to the rule). The rule:
// the most balanced split N1 <= 512, N2 <= 4096 whose two sizes both fall
// in the radix-16 or radix-8 class (log2 a multiple of 4 or of 3, see
// radix_class), the smaller N1 on a tie. Where none exists the factors of
// kSchedLogN1 / kSchedLogN2 take the rest: 2^4 and 2^5 split 4 x 4 and
// 4 x 8, and 2^19 128 x 4096, so that its rows are the radix-16 class's
// (kernel C's 2-CTA cluster at N2 = 4096, as at 2^20 and 2^21) and only
// its 128-point columns take a compile-time schedule (512 x 1024, its rows
// at 16 8 8 or 4 16 16, ran B 25-26% and C 17-18% slower on an NVIDIA H100:
// PERF.md, scripts/conv_2e19_ab.py). The saved-spectrum sizes 2^16-2^18
// split 256 x 256, 256 x 512, 512 x 512.
constexpr int kPlanLogN1[kMaxLogN + 1] = {0, 0, 0, 0, 2, 2, 3, 3, 4, 3, 4,
                                          3, 6, 4, 6, 6, 8, 8, 9, 7, 8, 9};

inline Plan make_plan(int n) {
  Plan p;
  p.n = n;
  p.log_n = 31 - __builtin_clz(static_cast<unsigned>(n));
  p.log_n1 = kPlanLogN1[p.log_n];
  p.log_n2 = p.log_n - p.log_n1;
  p.n1 = 1 << p.log_n1;
  p.n2 = 1 << p.log_n2;
  p.log_tc = p.log_n2 < kMaxLogTC ? p.log_n2 : kMaxLogTC;
  while ((p.n1 << p.log_tc) > kBlockElems) --p.log_tc;
  p.tc = 1 << p.log_tc;
  const int pairs = p.n1 / 2 + 1;
  const int g = kBlockElems / (2 * p.n2) > 1 ? kBlockElems / (2 * p.n2) : 1;
  p.g = g < pairs ? g : pairs;
  const int rpb = kBlockElems / p.n2 > 1 ? kBlockElems / p.n2 : 1;
  p.rpb = rpb < p.n1 ? rpb : p.n1;
  return p;
}

// The class of the kernels that transform 2^log_m points in the column
// passes (cols) or the row passes: 16, 8, 0 (see fft), or -1 where none
// takes that size (launch then launches nothing).
inline int radix_class(int log_m, bool cols) {
  if (log_m >= 4 && log_m <= 12 && log_m % 4 == 0) return 16;
  if (log_m >= 3 && log_m <= 9 && log_m % 3 == 0) return 8;
  const int* sched = cols ? kSchedLogN1 : kSchedLogN2;
  for (int i = 0; i < (cols ? kSchedCountN1 : kSchedCountN2); ++i) {
    if (sched[i] == log_m) return 0;
  }
  return -1;
}
inline int col_class(const Plan& p) { return radix_class(p.log_n1, true); }
inline int row_class(const Plan& p) { return radix_class(p.log_n2, false); }

// A power of two from 16 to 2^kMaxLogN whose four-step factors both have a
// class.
inline bool valid_fft_size(int n) {
  if (n < 16 || (n & (n - 1)) != 0 || n > (1 << kMaxLogN)) return false;
  const Plan p = make_plan(n);
  return col_class(p) >= 0 && row_class(p) >= 0;
}

// Grids and block sizes (kElems values a thread, at least a warp): column
// passes (TC columns a block), rows_fwd_kernel (rpb rows a block), the
// row-pair kernels (g pairs a block).
inline int threads_for(int elems) { return elems / kElems > 32 ? elems / kElems : 32; }
inline dim3 cols_grid(const Plan& p, int pairs, int B) { return dim3(p.n2 / p.tc, pairs, B); }
inline int cols_threads(const Plan& p) { return threads_for(p.n1 * p.tc); }
inline dim3 rows_grid(const Plan& p, int pairs) { return dim3(p.n1 / p.rpb, pairs, 1); }
inline int rows_threads(const Plan& p) { return threads_for(p.rpb * p.n2); }
inline dim3 pair_rows_grid(const Plan& p, int pairs, int B) {
  return dim3((p.n1 / 2 + p.g) / p.g, pairs, B);
}
inline int pair_threads(const Plan& p) { return threads_for(2 * p.g * p.n2); }

// Every FFT kernel is a template on kRadix, compiled three times: for
// sub-FFTs of 16, 256 or 4096 points (radix-16 passes only), of 8, 64 or
// 512 points (radix 8 only), and of the kSchedLogN1 / kSchedLogN2 sizes
// (columns of 4 and 128 points, rows of 4, each at its compile-time
// schedule). launch picks the instantiation for the class `radix`
// (col_class or row_class of the plan;
// `pick` maps std::integral_constant<int, kRadix> to the kernel), sets the
// dynamic shared memory it needs and launches it on `stream`. It launches
// nothing for a size of no class (-1), which the entry points refuse
// first (valid_fft_size).
template <class Pick, class... Args>
inline void launch(Pick pick, int radix, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   Args... args) {
  auto go = [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    kernel<<<grid, threads, smem, stream>>>(args...);
  };
  if (radix == 16) {
    go(pick(std::integral_constant<int, 16>{}));
  } else if (radix == 8) {
    go(pick(std::integral_constant<int, 8>{}));
  } else if (radix == 0) {
    go(pick(std::integral_constant<int, 0>{}));
  }
}

inline size_t cols_smem_bytes(const Plan& p) { return sizeof(float2) * p.n1 * p.tc; }
// rows_fwd_kernel and rows_conv_kernel: 2 g padded rows (34.8 KB; 69.6 KB
// at N2 = 4096)
inline size_t rows_smem_bytes(const Plan& p) {
  return sizeof(float2) * 2 * p.g * padded(p.n2);
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

// ---------------------------------------------------------------------------
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

// The column transforms' ends. Column s of the block is t2 = col0 + s; its
// element t1 (or f1) is at t = N2 t1 + t2 of the row, or A[f1][t2].
template <typename Src>
struct ColSourceIn {  // pass 1: z at t = N2 t1 + t2 < len, zero past it
  static constexpr bool kShared = false;
  Src src;
  int log_n2, col0, len;
  template <int R>
  __device__ __forceinline__ void get(int s, int base, int stride, float2 (&v)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = ((base + r * stride) << log_n2) + col0 + s;
      v[r] = t < len ? src(t) : make_float2(0.f, 0.f);
    }
  }
};

struct ColTwiddleOut {  // pass 1: A[f1][t2] = X[f1] W_n^(f1 t2)
  static constexpr bool kShared = false;
  float2* a;
  int log_n2, col0, n;
  template <int R>
  __device__ __forceinline__ void put(int s, int base, int stride, const float2 (&v)[R]) const {
    const int t2 = col0 + s;
    float2 w = twiddle(base * t2, n, false);
    const float2 step = twiddle(stride * t2, n, false);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      a[(static_cast<int64_t>(base + r * stride) << log_n2) + t2] = cmul(v[r], w);
      w = cmul(w, step);
    }
  }
};

struct ColTwiddleIn {  // pass 3: A[f1][t2] W_n^(-f1 t2)
  static constexpr bool kShared = false;
  const float2* a;
  int log_n2, col0, n;
  template <int R>
  __device__ __forceinline__ void get(int s, int base, int stride, float2 (&v)[R]) const {
    const int t2 = col0 + s;
    float2 w = twiddle(base * t2, n, true);
    const float2 step = twiddle(stride * t2, n, true);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = cmul(a[(static_cast<int64_t>(base + r * stride) << log_n2) + t2], w);
      w = cmul(w, step);
    }
  }
};

template <typename Sink>
struct ColSinkOut {  // pass 3: the outputs at t < len, times 1/n, to the sink
  static constexpr bool kShared = false;
  Sink sink;
  int log_n2, col0, len;
  float scale;
  template <int R>
  __device__ __forceinline__ void put(int s, int base, int stride, const float2 (&v)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = ((base + r * stride) << log_n2) + col0 + s;
      if (t < len) sink(t, v[r].x * scale, v[r].y * scale);
    }
  }
};

// Pass 1: z from `src` (zero past `len` and past channel C-1), column FFTs
// over t1, twiddle, store A[f1][t2] for blocks of TC columns. `In` is the
// transform's input end around `src` (ColSourceIn, or the gated kernels'
// BatchedSourceIn, fft_grad_common.cuh).
template <int kRadix, template <class> class In = ColSourceIn, typename Src>
__device__ __forceinline__ void cols_fwd_body(Src src, int C, int len, const Plan& p,
                                              float2* __restrict__ out) {
  extern __shared__ float2 smem[];
  const int col0 = blockIdx.x * p.tc;
  const int pair = blockIdx.y;
  const int b = blockIdx.z;
  const int c = 2 * pair;
  src.begin(b, c, C, len, c + 1 < C);
  float2* o = out + (static_cast<int64_t>(b) * gridDim.y + pair) * p.n;
  fft<false, kRadix>(In<Src>{src, p.log_n2, col0, len},
                    ColTwiddleOut{o, p.log_n2, col0, p.n}, ColMap{p.log_tc},
                    SharedIO<ColLayout>{smem, ColLayout{p.log_tc}}, p.log_n1, p.tc);
}

template <typename T, int kRadix>
__global__ void __launch_bounds__(kMaxThreads) cols_fwd_kernel(
    const T* __restrict__ x, int C, int len, Plan p, float2* __restrict__ out) {
  cols_fwd_body<kRadix>(PairSource<T>{x}, C, len, p, out);
}

// Pass 3: conjugate twiddle, inverse column FFTs, 1/n, the first `len`
// outputs handed to `sink` through the output end `Out` (ColSinkOut, or
// BatchedSinkOut).
template <int kRadix, template <class> class Out = ColSinkOut, typename Sink>
__device__ __forceinline__ void cols_inv_body(const float2* __restrict__ a, Sink sink, int C,
                                              int len, const Plan& p) {
  extern __shared__ float2 smem[];
  const int col0 = blockIdx.x * p.tc;
  const int pair = blockIdx.y;
  const int b = blockIdx.z;
  const int c = 2 * pair;
  sink.begin(b, c, C, len, c + 1 < C);
  const float2* src = a + (static_cast<int64_t>(b) * gridDim.y + pair) * p.n;
  fft<true, kRadix>(ColTwiddleIn{src, p.log_n2, col0, p.n},
                   Out<Sink>{sink, p.log_n2, col0, len, 1.0f / static_cast<float>(p.n)},
                   ColMap{p.log_tc}, SharedIO<ColLayout>{smem, ColLayout{p.log_tc}}, p.log_n1,
                   p.tc);
}

// Pass 3 with the D skip term x * D (x in y's layout); with dD, also writes
// the float32 value at t = 0 of each channel (before y's rounding).
template <typename T, int kRadix>
__global__ void __launch_bounds__(kMaxThreads) cols_inv_kernel(
    const float2* __restrict__ a, const T* __restrict__ x, const float* __restrict__ D,
    T* __restrict__ y, float* __restrict__ dD, int C, int len, Plan p) {
  cols_inv_body<kRadix>(a, SkipSink<T>{x, D, y, dD}, C, len, p);
}

// ---------------------------------------------------------------------------
// Row passes.

// The rows f1 of a row-pair block: pairs pr in [p0, p0 + np) of 0..N1/2,
// each row pr and its mirror N1 - pr, in slots 0..nrows-1; rows 0 and N1/2
// are their own mirrors and take one slot.
struct PairRows {
  int p0, np, nrows, n1;
  __device__ __forceinline__ PairRows(const Plan& p, int block) : p0(block * p.g), n1(p.n1) {
    const int left = p.n1 / 2 + 1 - p0;
    np = p.g < left ? p.g : left;
    nrows = 2 * np - (p0 == 0) - (p0 + np == p.n1 / 2 + 1);
  }
  __device__ __forceinline__ int row(int s) const {
    s += p0 == 0;
    const int pr = p0 + (s >> 1);
    return (s & 1) ? (n1 - pr) & (n1 - 1) : pr;
  }
  // the slot of pair pr's row (mirror 0) or mirror row (mirror 1)
  __device__ __forceinline__ int slot(int pr, int mirror) const {
    return pr == 0 ? 0 : 2 * (pr - p0) + mirror - (p0 == 0);
  }
};

// Contiguous rows row0, row0 + 1, ... (rows_fwd_kernel).
struct NextRows {
  int row0;
  __device__ __forceinline__ int row(int s) const { return row0 + s; }
};

// Rows of a (batch, pair) scratch in device memory, element i of slot s at
// a[row(s) N2 + i]. A transform whose two ends are the same rows has more
// than one pass, or goes through the block's buffer first (rows_fwd_kernel).
template <typename Rows>
struct RowsIO {
  static constexpr bool kShared = false;
  float2* a;
  Rows rows;
  int log_n2;
  template <int R>
  __device__ __forceinline__ void get(int s, int base, int stride, float2 (&v)[R]) const {
    const float2* row = a + (static_cast<int64_t>(rows.row(s)) << log_n2);
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = row[base + r * stride];
  }
  template <int R>
  __device__ __forceinline__ void put(int s, int base, int stride, const float2 (&v)[R]) const {
    float2* row = a + (static_cast<int64_t>(rows.row(s)) << log_n2);
#pragma unroll
    for (int r = 0; r < R; ++r) row[base + r * stride] = v[r];
  }
};

// The block's rows of a (batch, pair) scratch into its buffer (natural
// order) or back; every thread calls these, and each ends in a barrier.
template <typename Rows>
__device__ __forceinline__ void rows_to_shared(float2* buf, RowLayout lay, const float2* a,
                                               const Rows& rows, int nrows, int log_n2) {
  for (int e = threadIdx.x; e < (nrows << log_n2); e += blockDim.x) {
    const int s = e >> log_n2, i = e & ((1 << log_n2) - 1);
    buf[lay(s, i)] = a[(static_cast<int64_t>(rows.row(s)) << log_n2) + i];
  }
  __syncthreads();
}

template <typename Rows>
__device__ __forceinline__ void shared_to_rows(float2* a, const Rows& rows, const float2* buf,
                                               RowLayout lay, int nrows, int log_n2) {
  for (int e = threadIdx.x; e < (nrows << log_n2); e += blockDim.x) {
    const int s = e >> log_n2, i = e & ((1 << log_n2) - 1);
    a[(static_cast<int64_t>(rows.row(s)) << log_n2) + i] = buf[lay(s, i)];
  }
  __syncthreads();
}

// Pass 2 for the filter: forward row FFTs in place, natural order along f2.
template <int kRadix>
__global__ void __launch_bounds__(kMaxThreads) rows_fwd_kernel(float2* __restrict__ a, Plan p) {
  extern __shared__ float2 smem[];
  const RowsIO<NextRows> io{a + static_cast<int64_t>(blockIdx.y) * p.n,
                            NextRows{static_cast<int>(blockIdx.x) * p.rpb}, p.log_n2};
  const RowLayout lay{padded(p.n2)};
  const SharedIO<RowLayout> buf{smem, lay};
  if (p.log_n2 <= 4) {  // one pass: read the rows whole before writing them
    rows_to_shared(smem, lay, io.a, io.rows, p.rpb, p.log_n2);
    fft<false, kRadix>(buf, io, RowMap{}, buf, p.log_n2, p.rpb);
  } else {
    fft<false, kRadix>(io, io, RowMap{}, buf, p.log_n2, p.rpb);
  }
}

// The pointwise work of a block's row pairs: op(s0, i, s1, m, r0, r1) once
// for each frequency pair (f, -f) of its rows, f = r0 + N1 i at index i of
// slot s0 (row r0) and -f at index m of slot s1 (its mirror row r1).
template <typename Op>
__device__ __forceinline__ void for_each_pair(const PairRows& rows, const Plan& p, Op op) {
  for (int e = threadIdx.x; e < (rows.np << p.log_n2); e += blockDim.x) {
    const int r0 = rows.p0 + (e >> p.log_n2), i = e & (p.n2 - 1);
    const int r1 = mirror_row(r0, p);
    const int m = mirror_index(r0, i, p);  // f = r0 + N1 i; -f is (r1, m)
    if (r0 == r1 && m < i) continue;       // a self-mirrored row: each pair once
    op(rows.slot(r0, 0), i, rows.slot(r0, r0 != r1), m, r0, r1);
  }
}

// Pass 2 of a conv: rows f1 and their mirror rows (N1 - f1) mod N1, g pairs
// a block. `src` holds the column pass (src_is_spectrum == 0: forward row
// FFTs here, and with `spec_out` the forward row spectra stored there, u's
// pair spectrum at f1 + N1 f2 in natural f2 order, the layout kernel C
// reads) or that spectrum itself. Then the Hermitian split, the product
// with k's pair spectrum, the recombination, inverse row FFTs, and the
// result in `dst`. src, spec_out and dst may be one buffer: a block reads
// its rows whole before it writes them.
template <int kRadix>
__global__ void __launch_bounds__(kMaxThreads) rows_conv_kernel(
    const float2* src, int src_is_spectrum, const float2* __restrict__ kspec, float2* spec_out,
    float2* dst, Plan p) {
  extern __shared__ float2 smem[];
  const PairRows rows(p, blockIdx.x);
  const int pair = blockIdx.y;
  const int64_t off = (static_cast<int64_t>(blockIdx.z) * gridDim.y + pair) * p.n;
  const float2* ks = kspec + static_cast<int64_t>(pair) * p.n;
  const RowLayout lay{padded(p.n2)};
  const SharedIO<RowLayout> buf{smem, lay};
  if (src_is_spectrum) {
    rows_to_shared(smem, lay, src + off, rows, rows.nrows, p.log_n2);
  } else {
    fft<false, kRadix>(RowsIO<PairRows>{const_cast<float2*>(src) + off, rows, p.log_n2}, buf,
                      RowMap{}, buf, p.log_n2, rows.nrows);
    if (spec_out != nullptr) shared_to_rows(spec_out + off, rows, smem, lay, rows.nrows, p.log_n2);
  }
  for_each_pair(rows, p, [&](int s0, int i, int s1, int m, int r0, int r1) {
    float2& za = smem[lay(s0, i)];
    float2& zb = smem[lay(s1, m)];
    float2 u0, u1, k0, k1;
    split_pair(za, zb, u0, u1);
    split_pair(ks[(static_cast<int64_t>(r0) << p.log_n2) + i],
               ks[(static_cast<int64_t>(r1) << p.log_n2) + m], k0, k1);
    const float2 p0 = cmul(u0, k0);
    const float2 p1 = cmul(u1, k1);
    za = join_pair(p0, p1);
    zb = join_pair_mirror(p0, p1);
  });
  __syncthreads();
  fft<true, kRadix>(buf, RowsIO<PairRows>{dst + off, rows, p.log_n2}, RowMap{}, buf, p.log_n2,
                   rows.nrows);
}

}  // namespace FFT_NS
