// Kernel F': the fused transformer MLP backward, for Hopper.
//
// For y = gelu_tanh(x w1 + b1) w2 + b2 and the cotangent dy (N, d_out):
//   pre = x w1 + b1,  h = gelu_tanh(pre)            (recomputed)
//   dh  = (dy w2^T) * gelu_tanh'(pre)
//   dx  = dh w1^T                                   (N, d) in x's type
//   dw1 = x^T dh,  dw2 = h^T dy,  db1 = sum_rows dh  (float32)
// db2 = sum_rows dy is the wrapper's torch reduction, as the JAX wrapper
// computes it outside its kernel (pallas_mlp.py:154).
//
// Every product rounds its inputs to bf16 where the JAX `_mm` does (x, dy,
// the weights, h, dh) and accumulates in float32; db1 sums the unrounded
// float32 dh. Float32 x and dy are rounded once, into bf16 copies, before
// the passes run.
//
// Replaces hyena_dna_tpu/ops/pallas_mlp.py::mlp_fused, backward
// (`_bwd_kernel`, pallas_call at :129).
//
// What bounds it on the H100: five products of 2 N d dh flops at the bf16
// tensor-core rate (0.35 ms at N = 131072, d = d_out = 256, dh = 1024);
// the (N, dh) hidden and its gradient never reach device memory. The TPU
// kernel accumulated dw1, dw2 and db1 across its sequential grid; CUDA
// blocks run in no order, so the work is cut in two passes and a sum, seven
// products in all (pre and g = dy w2^T twice, dx, dw1, dw2), on wgmma:
//  * row pass (grid N / 128 x slabs of dx's columns): a block keeps its x
//    and dy tiles in shared memory and walks dh in 64-wide chunks: g and
//    pre (64 x 64 a warpgroup, in registers; one fragment map, so dh = g
//    gelu'(pre + b1) is elementwise per thread), dh rounded once into the
//    warpgroup's rows of a bf16 panel, then dx += dh w1[:, chunk]^T into 64
//    x 64 P float32 accumulators. One copy of the w1 chunk is pre's B
//    (read MN-major) and dx's B (read K-major). The next w2 chunk is copied
//    under dh and dx, the next w1 chunk under the next g;
//  * weight pass (grid dh / 64 x kSplits x slabs): a block owns one dh
//    chunk, whose w1 and w2 pieces it loads once, and one of kSplits fixed
//    splits of the rows. For each 128-row tile of its split: g and pre,
//    then h and dh into bf16 panels, then warpgroup 0 adds x^T dh (as dw1^T
//    = dh^T x, 64 x 64 P) and warpgroup 1 h^T dy (dw2, 64 x 64 P): dw1 and
//    dw2 from one recompute of pre and g, whose tanh serves the GeLU and
//    its derivative. Each warpgroup then copies the next tile of its own
//    operand (x or dy). db1 sums the float32 dh in registers in a fixed
//    order. Each block writes its partial sums to a float32 workspace. The
//    dh chunk index runs fastest in the grid, so the chunk blocks of one
//    split read the same x and dy tiles from L2;
//  * a last kernel sums the splits in a fixed order: no atomics, the same
//    bits every run, as in kernels A' and D'.
// The floor at the hg38 width is L2, not the products: the row pass reads
// all of w1 and w2 per 128-row tile (1.07 GB at N = 131072, d = 256, dh =
// 1024) and the weight pass x and dy per dh chunk (2.15 GB).
// Widths past 64 P (P = 4: d or d_out > 256) are taken in 64 P chunks,
// reloaded per use, and cut into slabs (grid.y of the row pass, grid.z of
// the weight pass), each slab recomputing pre and g: at d = d_out = 512 the
// four recompute products run twice (nine in all). Shared memory at P = 4:
// row pass 208 KB (x, dy tiles 64 KB each, w1, w2 chunks 32 KB each, dh 16
// KB), weight pass 224 KB (and h).
#define MLP_NS mlp_bwd
#include "mlp_common.cuh"

namespace MLP_NS {

constexpr int kSplits = 32;  // fixed split of the rows for the weight pass's partial sums

// Byte offsets of F''s shared-memory buffers at P panels; the row pass uses
// all but h.
template <int P>
struct BwdSmem {
  static constexpr int x = 0;                       // x tile: P panels of 128 rows
  static constexpr int dy = x + P * kTilePanel;     // dy tile: the same
  static constexpr int w1 = dy + P * kTilePanel;    // w1 chunk: 64 P rows of one panel
  static constexpr int w2 = w1 + P * kChunkPanel;   // w2 chunk: P panels of 64 rows
  static constexpr int bias = w2 + P * kChunkPanel;  // two chunks of b1, 64 floats each
  static constexpr int dh = bias + wgmma::kGroupBytes;  // dh: 128 rows of one panel
  static constexpr int h = dh + kTilePanel;         // h: the same (weight pass)
  static constexpr int row_bytes = h;
  static constexpr int weight_bytes = h + kTilePanel;
  static_assert(2 * TK * 4 <= wgmma::kGroupBytes, "the panels after b1 stay 1024-byte aligned");
};

// The copies both passes start: chunk c of the x or dy tile at row0, and
// chunk c of w1[:, j:j+64] or w2[j:j+64, :].
template <int P>
struct Loader {
  const bf16 *x, *dy, *w1, *w2;
  int N, d, dh, dout;
  uint32_t base;
  static constexpr int W = 64 * P;
  using S = BwdSmem<P>;

  // chunk c of the x (dy) tile at row0, copied by every thread, or with
  // kOwnWarpgroup by the calling warpgroup alone
  template <bool kOwnWarpgroup = false>
  __device__ void x_tile(int64_t row0, int c) const {
    tile<kOwnWarpgroup>(base + S::x, x, d, row0, c);
  }
  template <bool kOwnWarpgroup = false>
  __device__ void dy_tile(int64_t row0, int c) const {
    tile<kOwnWarpgroup>(base + S::dy, dy, dout, row0, c);
  }
  __device__ void w1_chunk(int j, int c) const {
    load_panels<W, 1>(base + S::w1, 0, w1 + static_cast<int64_t>(c) * W * dh + j, dh, d - c * W,
                      TK, threadIdx.x);
  }
  __device__ void w2_chunk(int j, int c) const {
    load_panels<TK, P>(base + S::w2, kChunkPanel, w2 + static_cast<int64_t>(j) * dout + c * W,
                       dout, TK, dout - c * W, threadIdx.x);
  }

 private:
  template <bool kOwnWarpgroup>
  __device__ void tile(uint32_t dst, const bf16* m, int ld, int64_t row0, int c) const {
    load_panels<TM, P, kOwnWarpgroup ? 128 : kThreads>(
        dst, kTilePanel, m + row0 * ld + c * W, ld, tile_rows(N, row0), ld - c * W,
        kOwnWarpgroup ? threadIdx.x % 128 : threadIdx.x);
  }
};

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1) mlp_bwd_rows_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dy, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2, T* __restrict__ dx, int N, int d,
    int dh, int dout) {
  using S = BwdSmem<P>;
  constexpr int W = 64 * P;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = wgmma::aligned_smem(smem_raw);
  const Loader<P> ld{x, dy, w1, w2, N, d, dh, dout, wgmma::smem_u32(sm)};
  const uint32_t base = ld.base;
  const int tw = threadIdx.x % 128, wg = threadIdx.x / 128;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * TM;
  const int nrow = tile_rows(N, row0);
  const int z = blockIdx.y;  // dx columns z W .. z W + W - 1
  const int ncol = min(W, d - z * W);
  const int nd = (d + W - 1) / W, no = (dout + W - 1) / W;
  const bool resident = nd == 1 && no == 1;  // the x and dy tiles stay in shared memory
  const uint32_t rows_off = 64 * wg * wgmma::kRowBytes;  // this warpgroup's rows
  const uint32_t x_a = base + S::x + rows_off, dy_a = base + S::dy + rows_off;
  const uint32_t dh_a = base + S::dh + rows_off;

  const float* bias = reinterpret_cast<const float*>(sm + S::bias);  // b1(j) in slot j % 2

  float acc[W / 2];
  wgmma::zero(acc);
  if (resident) {
    ld.x_tile(row0, 0);
    ld.dy_tile(row0, 0);
    ld.w2_chunk(0, 0);
    wgmma::cp_commit();
    ld.w1_chunk(0, 0);
    load_bias(base + S::bias, b1, 0);
    wgmma::cp_commit();
  }
  for (int j = 0; j < dh; j += TK) {
    float g[32], pre[32];
    wgmma::zero(g);
    wgmma::zero(pre);
    if (resident) {
      copies_landed<true>();  // x, dy and this chunk's w2; w1 may still be in flight
      start_k_k<P>(g, dy_a, kTilePanel, base + S::w2);
      copies_landed<false>();  // this chunk's w1, while g runs
      start_k_mn<P>(pre, x_a, kTilePanel, base + S::w1);
      settle(g, pre);
    } else {
      for (int c = 0; c < no; ++c) {
        __syncthreads();  // every warpgroup is done with the previous pieces
        ld.dy_tile(row0, c);
        ld.w2_chunk(j, c);
        wgmma::cp_commit();
        copies_landed<false>();
        start_k_k<P>(g, dy_a, kTilePanel, base + S::w2);
        settle(g);
      }
      for (int i = 0; i < nd; ++i) {
        const int c = (z + 1 + i) % nd;  // ends with chunk z: its w1 rows are dx's
        __syncthreads();
        ld.x_tile(row0, c);
        ld.w1_chunk(j, c);
        if (i == 0) load_bias(base + S::bias + (j / TK % 2) * TK * 4, b1, j);
        wgmma::cp_commit();
        copies_landed<false>();
        start_k_mn<P>(pre, x_a, kTilePanel, base + S::w1);
        settle(pre);
      }
    }
    __syncthreads();  // every warpgroup is done with the w2 chunk
    if (resident) {
      if (j + TK < dh) ld.w2_chunk(j + TK, 0);
      wgmma::cp_commit();
    }
    const float* bj = bias + (j / TK % 2) * TK;
#pragma unroll
    for (int k = 0; k < 32; ++k) g[k] *= gelu_tanh_grad(pre[k] + bj[wgmma::frag_col(tw, k)]);
    put_panel(sm + S::dh, 64 * wg, tw, g);
    wgmma::fence_proxy_async();
    warpgroup_sync();  // this warpgroup's dh rows are whole
    start_wide<P, false>(acc, dh_a, base + S::w1);  // dx += dh w1[:, chunk]^T
    settle(acc);
    __syncthreads();  // every warpgroup is done with the w1 chunk and b1(j)
    if (resident) {
      if (j + TK < dh) {
        ld.w1_chunk(j + TK, 0);
        load_bias(base + S::bias + ((j / TK + 1) % 2) * TK * 4, b1, j + TK);
      }
      wgmma::cp_commit();
    }
  }

  T* dxt = dx + (row0 + 64 * wg) * d + z * W;
#pragma unroll
  for (int k = 0; k < W / 2; k += 2) {
    const int r = wgmma::frag_row(tw, k), c = wgmma::frag_col(tw, k);
    if (64 * wg + r < nrow && c < ncol) {
      store_pair(dxt + static_cast<int64_t>(r) * d + c, acc[k], acc[k + 1]);
    }
  }
}

// acc (64 x 64 P) += A^T B over the 128 rows of a tile: A a 64-wide panel of
// 128 rows (h or dh) read MN-major (M = its 64 columns, K = the rows), B P
// panels of the x or dy tile read MN-major across panels (N = the tile's
// columns): dw1^T = dh^T x or dw2 = h^T dy.
template <int P>
__device__ __forceinline__ void start_rows(float (&acc)[32 * P], uint32_t a, uint32_t b) {
  const uint64_t da = wgmma::desc_mn(a), db = wgmma::desc_mn(b, kTilePanel);
  wgmma::fence_operand(acc);
  wgmma::fence();
#pragma unroll
  for (int ks = 0; ks < TM / 16; ++ks) {
    wgmma::Mma<64 * P, 1, 1>::run(acc, advance(da, ks * 2 * wgmma::kGroupBytes),
                                  advance(db, ks * 2 * wgmma::kGroupBytes));
  }
  wgmma::commit();
}

// part: kSplits x (d dh + dh d_out + dh) floats: per split, dw1 (d, dh),
// dw2 (dh, d_out), db1 (dh).
template <int P>
__global__ void __launch_bounds__(kThreads, 1) mlp_bwd_weights_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dy, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2, float* __restrict__ part, int N,
    int d, int dh, int dout) {
  using S = BwdSmem<P>;
  constexpr int W = 64 * P;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = wgmma::aligned_smem(smem_raw);
  const Loader<P> ld{x, dy, w1, w2, N, d, dh, dout, wgmma::smem_u32(sm)};
  const uint32_t base = ld.base;
  const int tw = threadIdx.x % 128, wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int j = blockIdx.x * TK;
  const int split = blockIdx.y, z = blockIdx.z;  // slab z of dw1's rows and dw2's columns
  const int nd = (d + W - 1) / W, no = (dout + W - 1) / W;
  const bool resident = nd == 1 && no == 1;  // w1 and w2 chunks loaded once
  const int64_t tiles = (N + TM - 1) / TM;
  const int64_t t0 = tiles * split / kSplits, t1 = tiles * (split + 1) / kSplits;
  const uint32_t rows_off = 64 * wg * wgmma::kRowBytes;  // this warpgroup's rows
  const uint32_t x_a = base + S::x + rows_off, dy_a = base + S::dy + rows_off;
  // warpgroup 0 forms dw1^T = dh^T x, warpgroup 1 dw2 = h^T dy
  const uint32_t dw_a = base + (wg == 0 ? S::dh : S::h);
  const uint32_t dw_b = base + (wg == 0 ? S::x : S::dy);

  float acc[W / 2];
  wgmma::zero(acc);
  float db1[2] = {0.f, 0.f};  // columns 8 q + 2 (lane % 4) + {0, 1}, q = lane / 4
  const float* bias = reinterpret_cast<const float*>(sm + S::bias);  // b1[j .. j + 63]
  if (t0 < t1) {
    load_bias(base + S::bias, b1, j);
    if (resident) {
      ld.w1_chunk(j, 0);
      ld.w2_chunk(j, 0);
      ld.x_tile(t0 * TM, 0);
      ld.dy_tile(t0 * TM, 0);
    }
    wgmma::cp_commit();
  }
  for (int64_t t = t0; t < t1; ++t) {
    const int64_t row0 = t * TM;
    float g[32], pre[32];
    wgmma::zero(g);
    wgmma::zero(pre);
    if (resident) {
      copies_landed<false>();  // the tile (and, first, the weight chunks)
      start_k_k<P>(g, dy_a, kTilePanel, base + S::w2);
      start_k_mn<P>(pre, x_a, kTilePanel, base + S::w1);
      settle(g, pre);
    } else {
      for (int i = 0; i < no; ++i) {
        const int c = (z + 1 + i) % no;  // ends with chunk z: dw2's columns
        __syncthreads();  // every warpgroup is done with the previous pieces
        ld.dy_tile(row0, c);
        ld.w2_chunk(j, c);
        wgmma::cp_commit();
        copies_landed<false>();
        start_k_k<P>(g, dy_a, kTilePanel, base + S::w2);
        settle(g);
      }
      for (int i = 0; i < nd; ++i) {
        const int c = (z + 1 + i) % nd;  // ends with chunk z: dw1's rows
        __syncthreads();
        ld.x_tile(row0, c);
        ld.w1_chunk(j, c);
        wgmma::cp_commit();
        copies_landed<false>();
        start_k_mn<P>(pre, x_a, kTilePanel, base + S::w1);
        settle(pre);
      }
    }
#pragma unroll
    for (int k = 0; k < 32; ++k) g[k] *= gelu_tanh_and_grad(pre[k] + bias[wgmma::frag_col(tw, k)], pre[k]);
    put_panel(sm + S::h, 64 * wg, tw, pre);
    put_panel(sm + S::dh, 64 * wg, tw, g);
    // db1: this thread's 2 rows of 16 columns, then the warp's 16 rows by a
    // fixed butterfly over the 8 lanes that share the columns
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = g[4 * (i / 2) + i % 2] + g[4 * (i / 2) + i % 2 + 2];
#pragma unroll
    for (int m = 4; m < 32; m *= 2) {
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], m);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q == lane / 4) {
        db1[0] += s[2 * q];
        db1[1] += s[2 * q + 1];
      }
    }
    wgmma::fence_proxy_async();
    __syncthreads();  // h and dh are whole
    start_rows<P>(acc, dw_a, dw_b);
    settle(acc);
    if (resident && t + 1 < t1) {
      // this warpgroup alone reads its B tile: refill it for the next tile
      warpgroup_sync();
      if (wg == 0) {
        ld.template x_tile<true>(row0 + TM, 0);
      } else {
        ld.template dy_tile<true>(row0 + TM, 0);
      }
      wgmma::cp_commit();
    }
  }

  const int64_t total = static_cast<int64_t>(d) * dh + static_cast<int64_t>(dh) * dout + dh;
  float* pw1 = part + split * total;
  float* pw2 = pw1 + static_cast<int64_t>(d) * dh;
  float* pb1 = pw2 + static_cast<int64_t>(dh) * dout;
  if (wg == 0 && z < nd) {
#pragma unroll
    for (int k = 0; k < W / 2; ++k) {
      const int r = wgmma::frag_row(tw, k), c = z * W + wgmma::frag_col(tw, k);
      if (c < d) pw1[static_cast<int64_t>(c) * dh + j + r] = acc[k];
    }
  }
  if (wg == 1 && z < no) {
#pragma unroll
    for (int k = 0; k < W / 2; k += 2) {
      const int r = wgmma::frag_row(tw, k), c = z * W + wgmma::frag_col(tw, k);
      if (c < dout) store_pair(pw2 + static_cast<int64_t>(j + r) * dout + c, acc[k], acc[k + 1]);
    }
  }
  if (z == 0) {  // db1: the eight warps' sums, added in order
    __syncthreads();  // h is free
    float* red = reinterpret_cast<float*>(sm + S::h);
    const int col = 8 * (lane / 4) + 2 * (lane % 4);
    red[(threadIdx.x / 32) * TK + col] = db1[0];
    red[(threadIdx.x / 32) * TK + col + 1] = db1[1];
    __syncthreads();
    if (threadIdx.x < TK) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) sum += red[w * TK + threadIdx.x];
      pb1[j + threadIdx.x] = sum;
    }
  }
}

// out[i] = sum over s in order of part[s][i]
__global__ void __launch_bounds__(kThreads) sum_splits_kernel(const float* __restrict__ part,
                                                              float* __restrict__ out,
                                                              int64_t total) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < kSplits; ++k) s += part[k * total + i];
    out[i] = s;
  }
}

inline int64_t grads_numel(int d, int dh, int dout) {
  return static_cast<int64_t>(d) * dh + static_cast<int64_t>(dh) * dout + dh;
}

template <typename T, int P>
int launch(const bf16* x, const bf16* dy, const bf16* w1, const float* b1, const bf16* w2, T* dx,
           float* part, float* grads, int N, int d, int dh, int dout, cudaStream_t stream) {
  constexpr int W = 64 * P;
  constexpr int row_smem = BwdSmem<P>::row_bytes + 1024;  // + the swizzle alignment
  constexpr int weight_smem = BwdSmem<P>::weight_bytes + 1024;
  cudaFuncSetAttribute(mlp_bwd_rows_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       row_smem);
  cudaFuncSetAttribute(mlp_bwd_weights_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       weight_smem);
  const int nd = (d + W - 1) / W, no = (dout + W - 1) / W;
  mlp_bwd_rows_kernel<T, P><<<dim3((N + TM - 1) / TM, nd), kThreads, row_smem, stream>>>(
      x, dy, w1, b1, w2, dx, N, d, dh, dout);
  mlp_bwd_weights_kernel<P><<<dim3(dh / TK, kSplits, nd > no ? nd : no), kThreads, weight_smem,
                              stream>>>(x, dy, w1, b1, w2, part, N, d, dh, dout);
  const int64_t total = grads_numel(d, dh, dout);
  sum_splits_kernel<<<static_cast<int>((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, grads, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace MLP_NS

// Floats of the workspace `part` that hyena_mlp_bwd takes at these widths
// (kSplits partial sums of dw1, dw2 and db1); -1 if it exceeds an int.
extern "C" int hyena_mlp_bwd_ws_numel(int d, int dh, int dout) {
  const int64_t n = MLP_NS::kSplits * MLP_NS::grads_numel(d, dh, dout);
  return n > 0x7fffffff ? -1 : static_cast<int>(n);
}

// x (N, d), dy (N, d_out) and dx (N, d) contiguous, all float32 (is_bf16 ==
// 0) or all bfloat16; w1 (d, dh) and w2 (dh, d_out) contiguous bfloat16; b1
// (dh,) float32. xb, dyb: N d and N d_out bfloat16 values of scratch for
// float32 x and dy (null for bfloat16 ones); part: hyena_mlp_bwd_ws_numel
// floats of workspace; grads receives (d dh + dh d_out + dh) floats: dw1
// (d, dh), dw2 (dh, d_out), db1 (dh); every pointer 16-byte aligned. N, d,
// dh, d_out multiples of 64. Launches on `stream`, does not synchronise;
// returns the cudaError_t of the launches (0 on success).
extern "C" int hyena_mlp_bwd(const void* x, const void* dy, const void* w1, const float* b1,
                             const void* w2, void* dx, void* xb, void* dyb, float* part,
                             float* grads, int N, int d, int dh, int dout, int is_bf16,
                             cudaStream_t stream) {
  using namespace MLP_NS;
  if (!valid_widths(N, d, dh, dout) || hyena_mlp_bwd_ws_numel(d, dh, dout) < 0 ||
      (!is_bf16 && (xb == nullptr || dyb == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* w1b = static_cast<const bf16*>(w1);
  const auto* w2b = static_cast<const bf16*>(w2);
  const bf16* xs = static_cast<const bf16*>(x);
  const bf16* dys = static_cast<const bf16*>(dy);
  if (!is_bf16) {
    int rc = round_bf16(static_cast<const float*>(x), static_cast<bf16*>(xb),
                        static_cast<int64_t>(N) * d, stream);
    if (rc == 0) {
      rc = round_bf16(static_cast<const float*>(dy), static_cast<bf16*>(dyb),
                      static_cast<int64_t>(N) * dout, stream);
    }
    if (rc != 0) return rc;
    xs = static_cast<const bf16*>(xb);
    dys = static_cast<const bf16*>(dyb);
  }
  return with_panels(d, dout, [&](auto panels) {
    constexpr int P = decltype(panels)::value;
    if (is_bf16) return launch<bf16, P>(xs, dys, w1b, b1, w2b, static_cast<bf16*>(dx), part,
                                        grads, N, d, dh, dout, stream);
    return launch<float, P>(xs, dys, w1b, b1, w2b, static_cast<float*>(dx), part, grads, N, d,
                            dh, dout, stream);
  });
}
