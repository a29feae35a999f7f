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
// What bounds it on the H100: the complex64 scratch between the four-step
// passes goes through device memory past n = 2^14 (one pair's row of 2^21 is
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
#define FFT_NS conv_bwd
#include "fft_common.cuh"
#include "wgmma.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace FFT_NS {

// Element i of row slot s at s N2 + i: the rows as the scratch holds them,
// copied in whole by cp.async. A row transform of rows_grad_kernel reads and
// writes its two ends in this layout, where a warp's accesses are
// consecutive, and runs the passes between in the padded RowLayout of the
// same buffer (a pass reads its inputs whole before it writes).
struct FlatLayout {
  int log_n2;
  __device__ __forceinline__ int operator()(int s, int i) const { return (s << log_n2) + i; }
};

// Starts copying the block's `nrows` rows of one (batch, pair) scratch into
// `buf`, flat: 16 bytes (two elements) a cp.async, committed as one group.
template <typename Rows>
__device__ __forceinline__ void rows_to_shared_async(float2* buf, const float2* a,
                                                     const Rows& rows, int nrows, int log_n2) {
  const int chunks = (nrows << log_n2) >> 1;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int e = c << 1;
    const int s = e >> log_n2, i = e & ((1 << log_n2) - 1);
    wgmma::cp_async16(wgmma::smem_u32(buf + e),
                      a + (static_cast<int64_t>(rows.row(s)) << log_n2) + i, 16);
  }
  wgmma::cp_commit();
}

// One frequency pair (f, -f) of the pointwise pass: f at index a of the
// block's own buffers, -f at index c of the mirror buffers (the block's own,
// or its cluster partner's); ga, gc their offsets in a (pair) scratch of
// rows in device memory. `own` is false for the half of a self-mirrored
// row whose pair another index owns, and past the block's pairs; `same`
// where f == -f (a and c one element).
struct Pair {
  bool own, same;
  int a, c;
  int64_t ga, gc;
};

// The pairs of a row-pair block (rows_grad_kernel): f = r0 + N1 i at the
// slot of row r0, -f = r1 + N1 m at its mirror row's slot, all in the
// block's buffers.
struct BlockPairs {
  PairRows rows;
  Plan p;
  __device__ __forceinline__ int count() const { return rows.np << p.log_n2; }
  __device__ __forceinline__ Pair at(int e) const {
    const int r0 = rows.p0 + (e >> p.log_n2), i = e & (p.n2 - 1);
    const int r1 = mirror_row(r0, p), m = mirror_index(r0, i, p);
    const int a = (rows.slot(r0, 0) << p.log_n2) + i;
    const int c = (rows.slot(r0, r0 != r1) << p.log_n2) + m;
    return {!(r0 == r1 && m < i), a == c, a, c, (static_cast<int64_t>(r0) << p.log_n2) + i,
            (static_cast<int64_t>(r1) << p.log_n2) + m};
  }
};

// The pairs of one block of a 2-CTA cluster (rows_grad_cluster_kernel),
// which owns row `row`; its partner owns the mirror row `mrow`. A row that is
// its own mirror (self) takes every pair once; otherwise the block takes the
// indices i < N2 / 2, the mirror's values in the partner's buffers.
struct ClusterPairs {
  int row, mrow;
  bool self;
  Plan p;
  __device__ __forceinline__ int count() const { return self ? p.n2 : p.n2 / 2; }
  __device__ __forceinline__ Pair at(int i) const {
    const int m = self ? mirror_index(row, i, p) : p.n2 - 1 - i;
    return {!(self && m < i), self && m == i, i, m, (static_cast<int64_t>(row) << p.log_n2) + i,
            (static_cast<int64_t>(mrow) << p.log_n2) + m};
  }
};

// A block's three buffers: dy's, u's and the third (see rows_grad_body).
struct Bufs {
  float2 *dy, *u, *x;
};

// Pass 2 (see the header), the work of one block of rows_grad_kernel or of
// rows_grad_cluster_kernel. gdy: dy's column pass in, du's rows out, (B,
// pairs, n). gu: u's column pass (u_is_spectrum == 0) or u's saved pair
// spectrum, (B, pairs, n). gk: K's rows, (pairs, n), or null in the
// dk-spectrum mode; D (C,) the skip term's weights, added to K's channels.
// gdk: dk's rows out (gk itself: each block rewrites only the rows it
// read), or the batch sum as a pair spectrum in the dk-spectrum mode. The
// block's `nrows` rows `rows` sit in `own`, three buffers: dy's, u's and a
// third, which holds K's rows at B = 1 (kSum false; dk's spectrum is then
// formed in u's buffer) and dk's batch sum at B > 1 (kSum; K is then read
// from device memory per batch row). `mirror` are the buffers that hold
// the mirror rows' values (`own`, or the cluster partner's), `pairs` the
// pointwise pass's (f, -f) pairs (BlockPairs, ClusterPairs). kCluster:
// the pointwise pass reads and writes the partner's buffers, between two
// cluster barriers. Rows arrive by cp.async in the flat layout, the next
// batch row's u while du's inverse runs.
template <int kRadix, bool kSum, bool kCluster, typename Rows, typename Pairs>
__device__ __forceinline__ void rows_grad_body(float2* gdy, const float2* __restrict__ gu,
                                               const float2* gk, const float* __restrict__ D,
                                               float2* gdk, int B, int C, int u_is_spectrum,
                                               const Plan& p, const Rows& rows, int nrows,
                                               const Pairs& pairs, Bufs own, Bufs mirror) {
  const int pair = blockIdx.y;
  const int npairs = gridDim.y;
  const bool with_du = gk != nullptr;
  const float d0 = with_du ? D[2 * pair] : 0.f;
  const float d1 = with_du && 2 * pair + 1 < C ? D[2 * pair + 1] : 0.f;
  const RowLayout lay{padded(p.n2)};
  const FlatLayout flat{p.log_n2};
  const SharedIO<RowLayout> mdy{own.dy, lay}, mu{own.u, lay}, mx{own.x, lay};
  const SharedIO<FlatLayout> fdy{own.dy, flat}, fu{own.u, flat}, fx{own.x, flat};
  const int64_t pofs = static_cast<int64_t>(pair) * p.n;
  auto slab = [&](int b) { return (static_cast<int64_t>(b) * npairs + pair) * p.n; };
  auto pair_sync = [] {
    if constexpr (kCluster) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
  };
  rows_to_shared_async(own.dy, gdy + slab(0), rows, nrows, p.log_n2);
  rows_to_shared_async(own.u, gu + slab(0), rows, nrows, p.log_n2);
  if (!kSum && with_du) rows_to_shared_async(own.x, gk + pofs, rows, nrows, p.log_n2);
  if (kSum) {
    for (int e = threadIdx.x; e < (nrows << p.log_n2); e += blockDim.x) {
      own.x[e] = make_float2(0.f, 0.f);
    }
  }
  for (int b = 0; b < B; ++b) {
    wgmma::cp_wait<0>();
    __syncthreads();
    fft<false, kRadix>(fdy, fdy, RowMap{}, mdy, p.log_n2, nrows);
    if (!u_is_spectrum) fft<false, kRadix>(fu, fu, RowMap{}, mu, p.log_n2, nrows);
    if constexpr (kCluster) pair_sync();  // the partner's row transformed too
    for (int e = threadIdx.x; e < pairs.count(); e += blockDim.x) {
      const Pair q = pairs.at(e);
      if (!q.own) continue;
      float2 dy0, dy1, u0, u1;
      split_pair(own.dy[q.a], mirror.dy[q.c], dy0, dy1);
      split_pair(own.u[q.a], mirror.u[q.c], u0, u1);
      if (with_du) {
        float2 k0, k1;
        if (kSum) {
          split_pair(gk[pofs + q.ga], gk[pofs + q.gc], k0, k1);
        } else {
          split_pair(own.x[q.a], mirror.x[q.c], k0, k1);
        }
        k0.x += d0;  // conj(K + D): the skip term dy D rides in du's spectrum
        k1.x += d1;
        const float2 p0 = cmulc(dy0, k0);
        const float2 p1 = cmulc(dy1, k1);
        own.dy[q.a] = join_pair(p0, p1);
        mirror.dy[q.c] = join_pair_mirror(p0, p1);  // f == -f: the same value
      }
      const float2 q0 = cmulc(dy0, u0);
      const float2 q1 = cmulc(dy1, u1);
      const float2 w = join_pair(q0, q1), wm = join_pair_mirror(q0, q1);
      if (kSum) {
        own.x[q.a] = make_float2(own.x[q.a].x + w.x, own.x[q.a].y + w.y);
        if (!q.same) mirror.x[q.c] = make_float2(mirror.x[q.c].x + wm.x, mirror.x[q.c].y + wm.y);
      } else if (with_du) {
        own.u[q.a] = w;
        mirror.u[q.c] = wm;
      } else {
        gdk[pofs + q.ga] = w;
        gdk[pofs + q.gc] = wm;
      }
    }
    pair_sync();  // every write of the pointwise pass done (the partner's too)
    if (kSum && b + 1 < B) rows_to_shared_async(own.u, gu + slab(b + 1), rows, nrows, p.log_n2);
    if (with_du) {
      fft<true, kRadix>(fdy, RowsIO<Rows>{gdy + slab(b), rows, p.log_n2}, RowMap{}, mdy, p.log_n2,
                        nrows);
      __syncthreads();  // the next row's copy overwrites dy's buffer
    }
    if (b + 1 < B) rows_to_shared_async(own.dy, gdy + slab(b + 1), rows, nrows, p.log_n2);
  }
  if (kSum && !with_du) {  // the dk-spectrum mode: the batch sum out as it is
    for (int e = threadIdx.x; e < (nrows << p.log_n2); e += blockDim.x) {
      gdk[pofs + (static_cast<int64_t>(rows.row(e >> p.log_n2)) << p.log_n2) +
          (e & (p.n2 - 1))] = own.x[e];
    }
  } else if (with_du) {
    fft<true, kRadix>(kSum ? fx : fu, RowsIO<Rows>{gdk + pofs, rows, p.log_n2}, RowMap{},
                      kSum ? mx : mu, p.log_n2, nrows);
  }
}

// Pass 2 at N2 <= 2048: one block per (g rows f1 and their Hermitian
// mirrors, channel pair), three buffers of its 2 g padded rows.
template <int kRadix, bool kSum>
__global__ void __launch_bounds__(kMaxThreads) rows_grad_kernel(
    float2* gdy, const float2* __restrict__ gu, const float2* gk, const float* __restrict__ D,
    float2* gdk, int B, int C, int u_is_spectrum, Plan p) {
  extern __shared__ float2 smem[];
  const PairRows rows(p, blockIdx.x);
  const int part = 2 * p.g * padded(p.n2);
  const Bufs own{smem, smem + part, smem + 2 * part};
  rows_grad_body<kRadix, kSum, false>(gdy, gu, gk, D, gdk, B, C, u_is_spectrum, p, rows,
                                      rows.nrows, BlockPairs{rows, p}, own, own);
}

// Pass 2 at N2 = 4096 (g = 1), where rows_grad_kernel's row pair and three
// buffers fill an SM with one block: the pair split over a cluster of two
// blocks of 256 threads, one row each (rows 0 and N1 / 2, each its own
// mirror, share cluster 0), so two blocks run on an SM and one block's
// loads and barriers overlap the other's FFT passes. The same work and
// buffers per row; the pointwise pass reads and writes the mirror row's
// values in the other block's shared memory (distributed shared memory),
// each block taking the pairs whose own index i < N2 / 2, with a cluster
// barrier before it (both rows transformed) and after it (both blocks'
// writes done).
template <int kRadix, bool kSum>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kMaxThreads / 2, 2)
    rows_grad_cluster_kernel(float2* gdy, const float2* __restrict__ gu, const float2* gk,
                             const float* __restrict__ D, float2* gdk, int B, int C,
                             int u_is_spectrum, Plan p) {
  extern __shared__ float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x >> 1;
  const bool self = cid == 0;
  const int row = self ? rank * (p.n1 / 2) : (rank ? p.n1 - cid : cid);
  const int mrow = self ? row : (rank ? cid : p.n1 - cid);
  const int part = padded(p.n2);
  const Bufs own{smem, smem + part, smem + 2 * part};
  const Bufs mirror = self ? own
                           : Bufs{cluster.map_shared_rank(own.dy, rank ^ 1),
                                  cluster.map_shared_rank(own.u, rank ^ 1),
                                  cluster.map_shared_rank(own.x, rank ^ 1)};
  rows_grad_body<kRadix, kSum, true>(gdy, gu, gk, D, gdk, B, C, u_is_spectrum, p, NextRows{row},
                                     1, ClusterPairs{row, mrow, self, p}, own, mirror);
}

// Pass 1 of k, dy and u: kernel B's column pass, held to 80 registers so
// that three blocks of up to 256 threads share an SM (faster than two blocks
// of 128 registers for C's three forward column passes; the inverse ones
// spill at 80).
template <typename T, int kRadix>
__global__ void __launch_bounds__(256, 3) cols_in_kernel(
    const T* __restrict__ x, int C, int len, Plan p, float2* __restrict__ out) {
  cols_fwd_body<kRadix>(PairSource<T>{x}, C, len, p, out);
}

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
  const bool sum = B > 1;
  const float2* gu = su != nullptr ? static_cast<const float2*>(su) : uspec;
  const float2* gk = with_du ? static_cast<const float2*>(sk) : nullptr;
  float2* gdk = with_du ? sk : static_cast<float2*>(dk);
  if (p.n2 == 4096) {  // g = 1: the row pair over a cluster of two blocks
    launch(
        [sum](auto) {  // N2 = 4096 is in the radix-16 class
          return sum ? rows_grad_cluster_kernel<16, true> : rows_grad_cluster_kernel<16, false>;
        },
        wr, dim3(p.n1, pairs, 1), threads_for(p.n2), 3 * sizeof(float2) * padded(p.n2), stream,
        sdy, gu, gk, D, gdk, B, C, su != nullptr ? 0 : 1, p);
  } else {
    launch(
        [sum](auto w) {
          return sum ? rows_grad_kernel<decltype(w)::value, true>
                     : rows_grad_kernel<decltype(w)::value, false>;
        },
        wr, pair_rows_grid(p, pairs, 1), pair_threads(p), 3 * rows_smem_bytes(p), stream, sdy, gu,
        gk, D, gdk, B, C, su != nullptr ? 0 : 1, p);
  }
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
// the kernel refuses.
extern "C" int hyena_fftconv_bwd_ws_slabs(int B, int C, int retransform, int with_k) {
  if (B < 1 || C < 1 || B > 65535 || (C + 1) / 2 > 65535) return -1;
  const int64_t slabs = FFT_NS::ws_slabs(B, C, retransform != 0, with_k != 0);
  return slabs > 0x7fffffff ? -1 : static_cast<int>(slabs);
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
  const Plan p = make_plan(n);
  auto* us = static_cast<const float2*>(uspec);
  auto* w = static_cast<float2*>(ws);
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
