// The short path of kernels B (fftconv.cu) and C (fftconv_bwd.cu): FFT sizes n <= 2^kShortMaxLogN,
// where a channel pair's whole row (n complex64, 64 KB at n = 2^13) fits in one block's shared
// memory, so a row is transformed, multiplied and transformed back inside one block and no complex
// scratch goes through device memory. Above the cut the four-step passes of fft_common.cuh run.
//
// Replaces no Pallas kernel: below fft 2^16 the JAX package ran XLA's FFT
// (hyena_dna_tpu/ops/fftconv.py, MATMUL_FFT_MIN). It serves the shipped configs at L <= 4096 (fft
// 2^10-2^13): pretraining at 1k, every fine-tune, the first stages of both seqlen curricula, where
// the four-step plan made five (B) and six (C) launches around a scratch of B pairs n complex64 and
// ran C's row pass with one block per channel pair looping the batch.
//
// What bounds it on the H100: the float32 transforms' instructions. The I/O is B C L elements in
// and out (50 MB, 15 us at 3.35 TB/s for C at 32 x 128 x 1024 float32), the arithmetic about 2.5 n
// log2 n flops a complex transform (three a batch row's channel pair in C), and every transform
// pass is a barrier and a shared-memory exchange (measured on an NVIDIA H100 80GB HBM3 at 700 W:
// C's grad launch moves its bytes at 26% of the memory rate). The design keeps each row's
// transforms in one block with the radix-16/8 Stockham passes of fft_common.cuh, at a compile-time
// schedule per size.
//
// Layout: a pair row z = x_c + i x_{c+1} (a zero channel after an odd C), zero-padded to n, sits in
// shared memory in natural order (RowLayout, one float2 of padding per 16). The first pass of each
// forward transform reads the row straight from device memory into registers (16 values a thread,
// coalesced, the zero padding never loaded); the last pass of each inverse stores the first `len`
// outputs straight to device memory in the I/O type. The filter's pair spectrum with the skip term
// folded in (K + D, as kernel E does: the transform of k + D delta) is split into its two channels'
// half spectra once a call and packed n / 2 float4 a pair (short_kspec_kernel: entry f holds
// K_c[f], K_{c+1}[f]; entry 0 the real values at f = 0 and f = n / 2), so the pointwise pass reads
// one float4 a frequency pair.
//
// Kernel B, two launches: short_kspec_kernel (one block a pair), then short_conv_kernel, one block
// per (pair, batch row): u's forward transform, the product U (K + D) over the frequency pairs (f,
// -f) (the Hermitian split of fft_common.cuh; K + D read from L2), the inverse, y's first L
// columns. Measured on the H100 (80GB HBM3, 700 W; PERF.md), this beat blocks that loop over a
// batch slice with K + D staged in shared memory once by 9-10% at fft 2^11-2^12 (more blocks in
// flight) and lost 7% at 2^13.
//
// Kernel C, three launches: short_kspec_kernel; short_grad_kernel, one block per (pair, batch slice
// s of S); short_dk_kernel, one block a pair. A grad block transforms dy's and u's rows of a batch
// row together (two sequences in one set of passes, 2 n / 16 threads), forms du's spectrum DY
// conj(K + D) in dy's buffer and adds DY conj(U) to the slice's dk accumulator in shared memory
// (each frequency pair owned by one thread, rows in order: a fixed summation order), runs du's
// inverse, and prefetches the next batch row's dy and u into L2 while it works (7-10% at fft
// 2^12-2^13, nothing at 2^11; staging the rows in shared memory by cp.async instead is not taken: a
// bf16 row of odd L starts on a 2-byte boundary, below cp.async's 4). Then it writes its
// accumulator, a pair spectrum, to the workspace. short_dk_kernel sums the S partials in slice
// order (no atomics: dk and dD bit-equal run to run), transforms back and writes dk's first Lk
// columns, dD read off lag 0 in float32 before dk's rounding. S is the number of slices that fills
// the card's resident blocks once (the occupancy API), at most B: twice as many slices measured
// 5-10% slower, and a register cap for four blocks an SM spilled and lost 40%.
//
// Sizes 2^10 .. 2^kShortMaxLogN are compiled each with its own pass schedule (fft_common.cuh's
// fft_sched, which the four-step passes' 128- and 4-point factors run too: radix 16 passes first,
// then 8; the radix-16 DFTs as loops, the others by recursion), sizes 2^4 .. 2^9 by one kernel of
// the any-size transform (fft_any below, kLogN = 0).
#pragma once

#include "fft_common.cuh"

#include <type_traits>

namespace FFT_NS {

// The cut: kernels B and C take the short path at n <= 2^kShortMaxLogN (ops/fused_fftconv.py reads
// this line). At 2^13 the short path still beat the four-step passes on an NVIDIA H100 80GB HBM3 at
// 700 W (32 x 128 x 4096 float32: B 0.229 against 0.536 ms, C 0.349 against 0.927; PERF.md, from
// scripts/conv_short_ab.py); at 2^14 kernel C's two rows and dk's accumulator (406 KB) no longer
// fit in a block's shared memory.
constexpr int kShortMaxLogN = 13;
constexpr int kShortMinLogN = 10;  // below it, one any-size kernel (kLogN = 0)

// Threads of a block that transforms `seqs` rows of 2^log_n together.
__host__ __device__ constexpr int short_threads(int log_n, int seqs) {
  return (seqs << log_n) / kElems > 32 ? (seqs << log_n) / kElems : 32;
}
// Rows kernel C's grad block transforms together: dy's and u's (2 n / 16
// threads) up to n = 2^12, one at a time above.
__host__ __device__ constexpr int grad_seqs(int log_n) { return log_n <= 12 ? 2 : 1; }
template <int kLogN, int kSeqs>
constexpr int kShortBound = short_threads(kLogN ? kLogN : kShortMinLogN - 1, kSeqs);

// The pass of radix 2^lr; a transform of 2^2..2^12 points takes lr 2-4
// alone, or 3-4 first and in the middle and 2-4 last (the schedule in
// fft_any).
template <bool kInv, int kMinLR, class In, class Out, class Map>
__device__ __forceinline__ void fft_pass_lr(int lr, const In& in, const Out& out, const Map& map,
                                            int log_m, int log_ns, int count) {
  if (kMinLR <= 2 && lr == 2) {
    fft_pass<2, kInv, false>(in, out, map, log_m, log_ns, count);
  } else if (lr == 3) {
    fft_pass<3, kInv, false>(in, out, map, log_m, log_ns, count);
  } else {
    fft_pass<4, kInv, false>(in, out, map, log_m, log_ns, count);
  }
}

// `count` transforms of size 2^log_m (4 <= 2^log_m <= 4096; natural order
// in and out) from `in` to `out`, the passes between exchanging through
// `mid`; blockDim * kElems >= count * 2^log_m. Every thread of the block
// calls it. Any log_m: ceil(log_m / 4) passes whose radices are chosen at
// run time, all three spelled in one kernel (which spills around radix 16,
// see dft). Only the short path's kernel for 2^4-2^9 runs it; the
// four-step passes take the classes of fft_common.cuh's fft.
template <bool kInv, class In, class Out, class Map, class Layout>
__device__ void fft_any(const In& in, const Out& out, const Map& map, const SharedIO<Layout>& mid,
                        int log_m, int count) {
  const int passes = (log_m + 3) >> 2;
  if (passes == 1) {
    fft_pass_lr<kInv, 2>(log_m, in, out, map, log_m, 0, count);
    return;
  }
  int log_ns = 0;
  for (int p = 0; p < passes; ++p) {
    const int lr = log_m / passes + (p < log_m % passes ? 1 : 0);
    if (p == 0) {
      fft_pass_lr<kInv, 3>(lr, in, mid, map, log_m, log_ns, count);
    } else if (p == passes - 1) {
      fft_pass_lr<kInv, 2>(lr, mid, out, map, log_m, log_ns, count);
    } else {
      fft_pass_lr<kInv, 3>(lr, mid, mid, map, log_m, log_ns, count);
    }
    log_ns += lr;
  }
}

// `count` row transforms of 2^log_n points (natural order in and out), the
// passes between through `mid`: fft_common.cuh's compile-time schedule of
// size 2^kLogN (fft_sched, radix 16 passes first, then 8), or the any-size
// transform above (kLogN = 0).
template <int kLogN, bool kInv, class In, class Out>
__device__ __forceinline__ void short_fft(const In& in, const Out& out,
                                          const SharedIO<RowLayout>& mid, int log_n, int count) {
  if constexpr (kLogN == 0) {
    fft_any<kInv>(in, out, RowMap{}, mid, log_n, count);
  } else {
    fft_sched<kLogN, kInv>(in, out, RowMap{}, mid, count);
  }
}

// First-pass source: the pair rows (channels c, c+1, each `len` long, zero
// past it) of sequence 0 at x0 and sequence 1 at x1; d0, d1 added at t = 0
// (the filter's skip term, K + D; zero for a signal).
template <typename T>
struct PairRowsIn {
  static constexpr bool kShared = false;
  const T* x0;
  const T* x1;
  int len;
  bool has2;
  float d0, d1;
  template <int R>
  __device__ __forceinline__ void get(int s, int base, int stride, float2 (&v)[R]) const {
    const T* r0 = s ? x1 : x0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = base + r * stride;
      float re = 0.f, im = 0.f;
      if (t < len) {
        re = to_f32(r0[t]);
        if (has2) im = to_f32(r0[len + t]);
      }
      if (t == 0) {
        re += d0;
        im += d1;
      }
      v[r] = make_float2(re, im);
    }
  }
};

// Last-pass sink: the first `len` outputs times `scale` to the rows of
// channels c, c+1 at y (real part to c, imaginary to c+1), and with dD the
// float32 values at t = 0 before their rounding.
template <typename T>
struct PairRowsOut {
  static constexpr bool kShared = false;
  T* y;
  int len;
  bool has2;
  float scale;
  float* dD;
  template <int R>
  __device__ __forceinline__ void put(int, int base, int stride, const float2 (&v)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = base + r * stride;
      if (t < len) {
        const float a = v[r].x * scale, b = v[r].y * scale;
        store(y + t, a);
        if (has2) store(y + len + t, b);
        if (dD != nullptr && t == 0) {
          dD[0] = a;
          if (has2) dD[1] = b;
        }
      }
    }
  }
};

// First-pass source of short_dk_kernel: one pair's S partial dk spectra,
// `step` values apart, summed in slice order.
struct PartialsIn {
  static constexpr bool kShared = false;
  const float2* p;
  int64_t step;
  int slices;
  template <int R>
  __device__ __forceinline__ void get(int, int base, int stride, float2 (&v)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = base + r * stride;
      float2 acc = p[i];
      for (int s = 1; s < slices; ++s) {
        const float2 w = p[s * step + i];
        acc = make_float2(acc.x + w.x, acc.y + w.y);
      }
      v[r] = acc;
    }
  }
};

// The two channels' spectra at f (0 <= f <= n / 2) from the packed K + D
// (see the header): k0 = K_c[f], k1 = K_{c+1}[f].
__device__ __forceinline__ void packed_at(const float4* ks, int f, int half, float2& k0,
                                          float2& k1) {
  if (f == 0 || f == half) {
    const float2 r = reinterpret_cast<const float2*>(ks)[f == half];
    k0 = make_float2(r.x, 0.f);
    k1 = make_float2(r.y, 0.f);
  } else {
    const float4 q = ks[f];
    k0 = make_float2(q.x, q.y);
    k1 = make_float2(q.z, q.w);
  }
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Starts bringing the `bytes` at p into L2, one 128-byte line a thread.
__device__ __forceinline__ void prefetch_rows(const void* p, int64_t bytes) {
  const char* c = static_cast<const char*>(p);
  for (int64_t o = static_cast<int64_t>(threadIdx.x) * 128; o < bytes;
       o += static_cast<int64_t>(blockDim.x) * 128) {
    prefetch_l2(c + o);
  }
}

// K + D of channel pair blockIdx.x, packed (see the header) into
// out + pair n / 2: the forward transform of (k_c + D_c delta) +
// i (k_{c+1} + D_{c+1} delta), split into the two channels.
template <typename T, int kLogN>
__global__ void __launch_bounds__(kShortBound<kLogN, 1>) short_kspec_kernel(
    const T* __restrict__ k, const float* __restrict__ D, int C, int Lk, int log_n_arg,
    float4* __restrict__ out) {
  extern __shared__ float2 smem[];
  const int log_n = kLogN ? kLogN : log_n_arg;
  const int n = 1 << log_n, half = n >> 1;
  const int pair = blockIdx.x, c = 2 * pair;
  const bool has2 = c + 1 < C;
  const RowLayout lay{padded(n)};
  const SharedIO<RowLayout> buf{smem, lay};
  short_fft<kLogN, false>(
      PairRowsIn<T>{k + static_cast<int64_t>(c) * Lk, nullptr, Lk, has2, D[c], has2 ? D[c + 1] : 0.f},
      buf, buf, log_n, 1);
  float4* o = out + static_cast<int64_t>(pair) * half;
  for (int f = threadIdx.x; f <= half; f += blockDim.x) {
    float2 k0, k1;
    split_pair(smem[lay(0, f)], smem[lay(0, (n - f) & (n - 1))], k0, k1);
    if (f == 0 || f == half) {
      reinterpret_cast<float2*>(o)[f == half] = make_float2(k0.x, k1.x);  // real there
    } else {
      o[f] = make_float4(k0.x, k0.y, k1.x, k1.y);
    }
  }
}

// Kernel B's conv: pair blockIdx.x, batch row blockIdx.y.
template <typename T, int kLogN>
__global__ void __launch_bounds__(kShortBound<kLogN, 1>) short_conv_kernel(
    const T* __restrict__ u, const float4* __restrict__ kspec, T* __restrict__ y, int C, int L,
    int log_n_arg) {
  extern __shared__ float2 smem[];
  const int log_n = kLogN ? kLogN : log_n_arg;
  const int n = 1 << log_n, half = n >> 1;
  const int pair = blockIdx.x, c = 2 * pair;
  const bool has2 = c + 1 < C;
  const RowLayout lay{padded(n)};
  const SharedIO<RowLayout> buf{smem, lay};
  const float4* ks = kspec + static_cast<int64_t>(pair) * half;
  const int64_t off = (static_cast<int64_t>(blockIdx.y) * C + c) * L;
  short_fft<kLogN, false>(PairRowsIn<T>{u + off, nullptr, L, has2, 0.f, 0.f}, buf, buf, log_n, 1);
  for (int f = threadIdx.x; f <= half; f += blockDim.x) {
    const int fm = (n - f) & (n - 1);
    float2 u0, u1, k0, k1;
    split_pair(smem[lay(0, f)], smem[lay(0, fm)], u0, u1);
    packed_at(ks, f, half, k0, k1);
    const float2 p0 = cmul(u0, k0), p1 = cmul(u1, k1);
    smem[lay(0, f)] = join_pair(p0, p1);
    smem[lay(0, fm)] = join_pair_mirror(p0, p1);  // f == -f: the same value
  }
  __syncthreads();
  short_fft<kLogN, true>(buf, PairRowsOut<T>{y + off, L, has2, 1.0f / static_cast<float>(n), nullptr},
                         buf, log_n, 1);
}

// Kernel C's launch 1: pair blockIdx.x, batch slice blockIdx.y (rows
// [blockIdx.y rows, + rows)); dk's partial spectrum of the slice to
// part + (slice pairs + pair) n.
template <typename T, int kLogN>
__global__ void __launch_bounds__(kShortBound<kLogN, grad_seqs(kLogN)>) short_grad_kernel(
    const T* __restrict__ u, const T* __restrict__ dy, const float4* __restrict__ kspec,
    T* __restrict__ du, float2* __restrict__ part, int B, int C, int L, int log_n_arg, int rows) {
  extern __shared__ float2 smem[];
  const int log_n = kLogN ? kLogN : log_n_arg;
  const int n = 1 << log_n, half = n >> 1;
  const int pair = blockIdx.x, c = 2 * pair;
  const bool has2 = c + 1 < C;
  const int stride = padded(n);
  const RowLayout lay{stride};
  const SharedIO<RowLayout> buf{smem, lay};  // sequence 0: dy, 1: u
  float2* sdy = smem;
  float2* su = smem + stride;
  float2* acc = smem + 2 * stride;  // natural order, n values
  const float4* ks = kspec + static_cast<int64_t>(pair) * half;
  constexpr bool kJoint = grad_seqs(kLogN) == 2;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc[i] = make_float2(0.f, 0.f);
  const int b0 = blockIdx.y * rows, b1 = min(B, b0 + rows);
  const int64_t row_bytes = static_cast<int64_t>(has2 ? 2 : 1) * L * sizeof(T);
  const float scale = 1.0f / static_cast<float>(n);
  for (int b = b0; b < b1; ++b) {
    const int64_t off = (static_cast<int64_t>(b) * C + c) * L;
    if (b + 1 < b1) {  // the next batch row's dy and u toward L2 while this one runs
      prefetch_rows(dy + off + static_cast<int64_t>(C) * L, row_bytes);
      prefetch_rows(u + off + static_cast<int64_t>(C) * L, row_bytes);
    }
    if constexpr (kJoint) {
      short_fft<kLogN, false>(PairRowsIn<T>{dy + off, u + off, L, has2, 0.f, 0.f}, buf, buf,
                              log_n, 2);
    } else {
      const SharedIO<RowLayout> ubuf{su, lay};
      short_fft<kLogN, false>(PairRowsIn<T>{dy + off, nullptr, L, has2, 0.f, 0.f}, buf, buf,
                              log_n, 1);
      short_fft<kLogN, false>(PairRowsIn<T>{u + off, nullptr, L, has2, 0.f, 0.f}, ubuf, ubuf,
                              log_n, 1);
    }
    for (int f = threadIdx.x; f <= half; f += blockDim.x) {
      const int fm = (n - f) & (n - 1);
      const int a = lay(0, f), m = lay(0, fm);
      float2 dy0, dy1, u0, u1, k0, k1;
      split_pair(sdy[a], sdy[m], dy0, dy1);
      split_pair(su[a], su[m], u0, u1);
      packed_at(ks, f, half, k0, k1);
      const float2 p0 = cmulc(dy0, k0), p1 = cmulc(dy1, k1);  // DY conj(K + D)
      sdy[a] = join_pair(p0, p1);
      sdy[m] = join_pair_mirror(p0, p1);
      const float2 q0 = cmulc(dy0, u0), q1 = cmulc(dy1, u1);  // DY conj(U)
      const float2 w = join_pair(q0, q1), wm = join_pair_mirror(q0, q1);
      acc[f] = make_float2(acc[f].x + w.x, acc[f].y + w.y);
      if (fm != f) acc[fm] = make_float2(acc[fm].x + wm.x, acc[fm].y + wm.y);
    }
    __syncthreads();
    short_fft<kLogN, true>(buf, PairRowsOut<T>{du + off, L, has2, scale, nullptr}, buf, log_n, 1);
    __syncthreads();  // the next row's first pass writes the buffers
  }
  float2* o = part + (static_cast<int64_t>(blockIdx.y) * gridDim.x + pair) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) o[i] = acc[i];
}

// Kernel C's launch 2: pair blockIdx.x's `slices` partials summed in slice
// order, transformed back; dk's first Lk columns (in To), dD at lag 0.
template <typename To, int kLogN>
__global__ void __launch_bounds__(kShortBound<kLogN, 1>) short_dk_kernel(
    const float2* __restrict__ part, int slices, To* __restrict__ dk, float* __restrict__ dD,
    int C, int Lk, int log_n_arg) {
  extern __shared__ float2 smem[];
  const int log_n = kLogN ? kLogN : log_n_arg;
  const int n = 1 << log_n;
  const int pair = blockIdx.x, c = 2 * pair;
  const bool has2 = c + 1 < C;
  const SharedIO<RowLayout> buf{smem, RowLayout{padded(n)}};
  short_fft<kLogN, true>(
      PartialsIn{part + static_cast<int64_t>(pair) * n, static_cast<int64_t>(gridDim.x) * n, slices},
      PairRowsOut<To>{dk + static_cast<int64_t>(c) * Lk, Lk, has2, 1.0f / static_cast<float>(n),
                      dD + c},
      buf, log_n, 1);
}

// ---------------------------------------------------------------------------
// Host side.

inline bool short_path_size(int n) { return n <= (1 << kShortMaxLogN); }

// The instantiation of a short kernel for size 2^log_n: `pick` maps
// std::integral_constant<int, kLogN> to the kernel (kLogN = 0 below
// 2^kShortMinLogN).
template <int kLog = kShortMinLogN, class Pick>
inline auto short_kernel(Pick pick, int log_n) {
  if constexpr (kLog > kShortMaxLogN) {
    return pick(std::integral_constant<int, 0>{});
  } else {
    if (log_n == kLog) return pick(std::integral_constant<int, kLog>{});
    return short_kernel<kLog + 1>(pick, log_n);
  }
}

template <class Kernel, class... Args>
inline void short_launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                         Args... args) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  kernel<<<grid, threads, smem, stream>>>(args...);
}

// Shared memory of each short kernel, in bytes.
inline size_t row_smem(int log_n) { return sizeof(float2) * padded(1 << log_n); }
inline size_t grad_smem(int log_n) {
  return sizeof(float2) * (2 * padded(1 << log_n) + (1 << log_n));
}

template <typename T>
inline void launch_short_kspec(const T* k, const float* D, float4* kspec, int C, int Lk,
                               int log_n, cudaStream_t stream) {
  const int pairs = (C + 1) / 2;
  auto kernel = short_kernel(
      [](auto w) { return short_kspec_kernel<T, decltype(w)::value>; }, log_n);
  short_launch(kernel, dim3(pairs), short_threads(log_n, 1), row_smem(log_n), stream, k, D, C, Lk,
               log_n, kspec);
}

// Kernel B at n = 2^log_n <= 2^kShortMaxLogN: K + D into kspec (ceil(C/2)
// n complex64, n / 2 float4 a pair), then the conv, one block per (pair,
// batch row).
template <typename T>
inline int launch_short_fwd(const T* u, const T* k, const float* D, T* y, float2* kspec, int B,
                            int C, int L, int Lk, int log_n, cudaStream_t stream) {
  auto* ks = reinterpret_cast<float4*>(kspec);
  launch_short_kspec(k, D, ks, C, Lk, log_n, stream);
  short_launch(short_kernel([](auto w) { return short_conv_kernel<T, decltype(w)::value>; }, log_n),
               dim3((C + 1) / 2, B), short_threads(log_n, 1), row_smem(log_n), stream, u,
               static_cast<const float4*>(ks), y, C, L, log_n);
  return static_cast<int>(cudaGetLastError());
}

// Batch rows a block of kernel C's grad launch loops over (its slices:
// ceil(B / rows), the dk partials of each pair): the fewest for which the
// pairs x slices blocks fit in the card's resident blocks at once.
template <typename T>
inline int short_grad_rows(int B, int C, int log_n) {
  auto kernel = short_kernel([](auto w) { return short_grad_kernel<T, decltype(w)::value>; },
                             log_n);
  const size_t smem = grad_smem(log_n);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                short_threads(log_n, grad_seqs(log_n)), smem);
  int slices = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1) / ((C + 1) / 2);
  slices = slices < 1 ? 1 : slices > B ? B : slices;
  return (B + slices - 1) / slices;
}

// Kernel C (retransform route, with k) at n = 2^log_n <= 2^kShortMaxLogN.
// ws: K + D in its first ceil(C/2) slabs of n complex64, the S <= B dk
// partials of every pair in the next S ceil(C/2).
template <typename T>
inline int launch_short_bwd(const T* u, const T* dy, const T* k, const float* D, T* du, void* dk,
                            bool dk_f32, float* dD, float2* ws, int B, int C, int L, int Lk,
                            int log_n, cudaStream_t stream) {
  const int pairs = (C + 1) / 2, n = 1 << log_n;
  auto* ks = reinterpret_cast<float4*>(ws);
  float2* part = ws + static_cast<int64_t>(pairs) * n;
  launch_short_kspec(k, D, ks, C, Lk, log_n, stream);
  const int rows = short_grad_rows<T>(B, C, log_n);
  const int slices = (B + rows - 1) / rows;
  short_launch(short_kernel([](auto w) { return short_grad_kernel<T, decltype(w)::value>; }, log_n),
               dim3(pairs, slices), short_threads(log_n, grad_seqs(log_n)), grad_smem(log_n),
               stream, u, dy, static_cast<const float4*>(ks), du, part, B, C, L, log_n, rows);
  const int threads = short_threads(log_n, 1);
  if (dk_f32) {
    short_launch(short_kernel([](auto w) { return short_dk_kernel<float, decltype(w)::value>; },
                              log_n),
                 dim3(pairs), threads, row_smem(log_n), stream, static_cast<const float2*>(part),
                 slices, static_cast<float*>(dk), dD, C, Lk, log_n);
  } else {
    short_launch(short_kernel([](auto w) { return short_dk_kernel<T, decltype(w)::value>; },
                              log_n),
                 dim3(pairs), threads, row_smem(log_n), stream, static_cast<const float2*>(part),
                 slices, static_cast<T*>(dk), dD, C, Lk, log_n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace FFT_NS
