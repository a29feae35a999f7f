// The pieces of kernel C's design (fftconv_bwd.cu) that kernels E and E'
// (fftconv_gated{,_bwd}.cu) run too: the gradient row pass, one body for C
// and E' (rows_grad_body: dy's and u's rows staged by cp.async, du's and
// dk's products and their inverse row FFTs, K's rows on chip at B = 1, dk's
// batch sum in a fixed order at B > 1, the N2 = 4096 row pair over a 2-CTA
// cluster), the forward column passes at three blocks an SM
// (cols_in_kernel; cols_in_delta_kernel for the filter with the skip term
// folded in, K + D), the launch of the row pass (launch_rows_grad), and
// the column-pass ends of E's and E''s gate, whose reads are batched ahead
// of their stores.
// Included under each library's FFT_NS, after it, as fft_common.cuh is.
#pragma once

#include "fft_common.cuh"
#include "wgmma.cuh"

#include <cooperative_groups.h>

namespace FFT_NS {

namespace cg = cooperative_groups;

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
// dk-spectrum mode; D (C,) the skip term's weights, added to K's channels
// (kernel C), or null where K's rows already hold K + D (kernel E').
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
  const bool fold = with_du && D != nullptr;
  const float d0 = fold ? D[2 * pair] : 0.f;
  const float d1 = fold && 2 * pair + 1 < C ? D[2 * pair + 1] : 0.f;
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

// Pass 1 of k, dy and u (kernels C, E and E'): kernel B's column pass, held
// to 80 registers so that three blocks of up to 256 threads share an SM
// (faster than two blocks of 128 registers for C's three forward column
// passes; the inverse ones spill at 80).
template <typename T, int kRadix>
__global__ void __launch_bounds__(256, 3) cols_in_kernel(
    const T* __restrict__ x, int C, int len, Plan p, float2* __restrict__ out) {
  cols_fwd_body<kRadix>(PairSource<T>{x}, C, len, p, out);
}

// Column-pass ends for the gated kernels' sources and sinks, which read
// other arrays than the one the pass transforms and may store: the reads of
// kBatch outputs are all issued before any of their stores, so they are in
// flight together. Read and stored one output at a time, each read waits
// for the store before it, which the compiler must assume may alias it.
// A batched source gives `In load(t)` (reads only) and `float2 value(t,
// in)` (z at t, and any store); a batched sink `In load(t)` and `store(t,
// in, y0, y1)`.
constexpr int kBatch = 4;

template <typename Src>
struct BatchedSourceIn {  // pass 1: as ColSourceIn
  static constexpr bool kShared = false;
  Src src;
  int log_n2, col0, len;
  template <int R>
  __device__ __forceinline__ void get(int s, int base, int stride, float2 (&v)[R]) const {
    constexpr int kB = R < kBatch ? R : kBatch;
#pragma unroll
    for (int r0 = 0; r0 < R; r0 += kB) {
      typename Src::In in[kB];
#pragma unroll
      for (int r = 0; r < kB; ++r) {
        const int t = ((base + (r0 + r) * stride) << log_n2) + col0 + s;
        if (t < len) in[r] = src.load(t);
      }
#pragma unroll
      for (int r = 0; r < kB; ++r) {
        const int t = ((base + (r0 + r) * stride) << log_n2) + col0 + s;
        v[r0 + r] = t < len ? src.value(t, in[r]) : make_float2(0.f, 0.f);
      }
    }
  }
};

template <typename Sink>
struct BatchedSinkOut {  // pass 3: as ColSinkOut
  static constexpr bool kShared = false;
  Sink sink;
  int log_n2, col0, len;
  float scale;
  template <int R>
  __device__ __forceinline__ void put(int s, int base, int stride, const float2 (&v)[R]) const {
    constexpr int kB = R < kBatch ? R : kBatch;
#pragma unroll
    for (int r0 = 0; r0 < R; r0 += kB) {
      typename Sink::In in[kB];
#pragma unroll
      for (int r = 0; r < kB; ++r) {
        const int t = ((base + (r0 + r) * stride) << log_n2) + col0 + s;
        if (t < len) in[r] = sink.load(t);
      }
#pragma unroll
      for (int r = 0; r < kB; ++r) {
        const int t = ((base + (r0 + r) * stride) << log_n2) + col0 + s;
        if (t < len) sink.store(t, in[r], v[r0 + r].x * scale, v[r0 + r].y * scale);
      }
    }
  }
};

// Pass 1 source for the filter with the skip term folded in: k + D delta.
// Its transform is K + D in every bin (in the pair spectrum D_c + i D_{c+1},
// which split_pair, being linear, hands each channel as K_c + D_c): the TPU
// kernels' ks trick (hyena_dna_tpu/ops/pallas_fftconv.py:1430-1443), which
// makes inv(U (K + D)) the whole v = conv + u D and inv(DV conj(K + D)) the
// whole du = corr + dv D (n >= 2L: the delta's lags land on u's padding).
template <typename T>
struct DeltaSource {
  const T* k;
  const float* D;  // from channel c on, after begin
  int64_t row0, len;
  bool has2;
  __device__ __forceinline__ void begin(int b, int c, int C, int len_, bool has2_) {
    row0 = (static_cast<int64_t>(b) * C + c) * len_;
    len = len_;
    has2 = has2_;
    D += c;
  }
  __device__ __forceinline__ float2 operator()(int t) const {
    float re = to_f32(k[row0 + t]), im = has2 ? to_f32(k[row0 + len + t]) : 0.f;
    if (t == 0) {
      re += D[0];
      if (has2) im += D[1];
    }
    return make_float2(re, im);
  }
};

// Pass 1 of k + D delta, under cols_in_kernel's bounds.
template <typename T, int kRadix>
__global__ void __launch_bounds__(256, 3) cols_in_delta_kernel(
    const T* __restrict__ k, const float* __restrict__ D, int C, int len, Plan p,
    float2* __restrict__ out) {
  cols_fwd_body<kRadix>(DeltaSource<T>{k, D}, C, len, p, out);
}

// Pass 2 of kernels C and E' on ceil(C/2) channel pairs (see rows_grad_body
// for the arguments): rows_grad_cluster_kernel at N2 = 4096, else
// rows_grad_kernel; dk's batch sum kept in shared memory (kSum) at B > 1.
inline void launch_rows_grad(float2* gdy, const float2* gu, const float2* gk, const float* D,
                             float2* gdk, int B, int C, int u_is_spectrum, const Plan& p,
                             cudaStream_t stream) {
  const int pairs = (C + 1) / 2;
  const int wr = row_class(p);
  const bool sum = B > 1;
  if (p.n2 == 4096) {  // g = 1: the row pair over a cluster of two blocks
    launch(
        [sum](auto) {  // N2 = 4096 is in the radix-16 class
          return sum ? rows_grad_cluster_kernel<16, true> : rows_grad_cluster_kernel<16, false>;
        },
        wr, dim3(p.n1, pairs, 1), threads_for(p.n2), 3 * sizeof(float2) * padded(p.n2), stream,
        gdy, gu, gk, D, gdk, B, C, u_is_spectrum, p);
  } else {
    launch(
        [sum](auto w) {
          return sum ? rows_grad_kernel<decltype(w)::value, true>
                     : rows_grad_kernel<decltype(w)::value, false>;
        },
        wr, pair_rows_grid(p, pairs, 1), pair_threads(p), 3 * rows_smem_bytes(p), stream, gdy, gu,
        gk, D, gdk, B, C, u_is_spectrum, p);
  }
}

}  // namespace FFT_NS
