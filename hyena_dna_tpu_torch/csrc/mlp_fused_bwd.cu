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
// float32 dh.
//
// Replaces hyena_dna_tpu/ops/pallas_mlp.py::mlp_fused, backward
// (`_bwd_kernel`, pallas_call at :129).
//
// What bounds it on the H100: five products of 2 N d dh flops at the bf16
// tensor-core rate (0.35 ms at N = 131072, d = d_out = 256, dh = 1024);
// the (N, dh) hidden and its gradient never reach device memory. The TPU
// kernel accumulated dw1, dw2 and db1 across its sequential grid; CUDA
// blocks run in no order, so the work is cut in two passes and a sum:
//  * row pass (grid N / 64 x ceil(d / 256)): a block walks dh in 64-wide
//    chunks: pre = x w1[:, j] and dy w2[j, :]^T, each streamed through d or
//    d_out in 64-deep slabs (stream_product), dh rounded to bf16, then the
//    chunk's w1 piece for the block's 256 columns of dx (copied by cp.async
//    under dh's elementwise work) and dx += dh w1[slab, j]^T into float32
//    fragments; dx is written once;
//  * weight pass (grid dh / 64 x kSplits x (ceil(d / 256) +
//    ceil(d_out / 256))): a block owns one 64-wide dh chunk, one of the
//    fixed splits of the rows, and a 256-wide slab of dw1's rows or of
//    dw2's columns. Over its rows' tiles it recomputes pre (and dh for dw1)
//    by streamed products, loads the tile's slab of x (or dy) and
//    accumulates x^T dh or h^T dy in registers; the dw1 blocks of the first
//    slab also sum db1 in a fixed order. Each block writes its partial sums
//    to a float32 workspace;
//  * a last kernel sums the splits in a fixed order: no atomics, the same
//    bits every run, as in kernels A' and D'.
// Shared memory is fixed (79 KB): any d, dh, d_out in multiples of 64.
// Simple first: WMMA fragments, no TMA or wgmma; pre is recomputed by both
// passes (eight products where five would do) and the weights stream from
// L2 for every tile.
#define MLP_NS mlp_bwd
#include "mlp_common.cuh"

namespace MLP_NS {

// The shared-memory buffers of both passes: the streaming stage (after a
// chunk's streamed products: the row pass's w1 piece, the weight pass's
// slab of x or dy), h or dh in bf16, pre and dy w2^T (then dh) in float32.
// The row pass's float dx slab reuses the space from the start.
struct Buffers {
  bf16 *stage, *hs;
  float *pre, *dg;
  __device__ explicit Buffers(unsigned char* smem) {
    stage = reinterpret_cast<bf16*>(smem);
    hs = stage + kStage;
    pre = reinterpret_cast<float*>(hs + TM * LDC);
    dg = pre + TM * LDF;
  }
};

inline size_t bwd_smem_bytes() {
  const size_t work = sizeof(bf16) * (kStage + TM * LDC) + sizeof(float) * 2 * TM * LDF;
  const size_t dx_slab = sizeof(float) * TM * LDY;
  return work > dx_slab ? work : dx_slab;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mlp_bwd_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2, T* __restrict__ dx, int d, int dh,
    int dout) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Buffers sb(smem);
  bf16* w1c = sb.stage;  // w1[col0:col0+ncol, j:j+64], ncol x 64, after the streamed products
  float* dxs = reinterpret_cast<float*>(smem);  // epilogue only
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * TM;
  const int col0 = blockIdx.y * SLAB;
  const int ncol = min(SLAB, d - col0);

  FragC acc[8];
  zero(acc);
  for (int j = 0; j < dh; j += TK) {
    FragC pa[2], ga[2];
    zero(pa);
    zero(ga);
    stream_product<false>(pa, x + row0 * d, d, w1 + j, dh, d, sb.stage);
    stream_product<true>(ga, dy + row0 * dout, dout, w2 + static_cast<int64_t>(j) * dout, dout,
                         dout, sb.stage);
    store_chunk(sb.pre, pa);
    store_chunk(sb.dg, ga);
    copy_async(w1c, LDC, w1 + static_cast<int64_t>(col0) * dh + j, dh, ncol, TK);
    __syncthreads();  // pre and dy w2^T are whole
    for (int e = threadIdx.x; e < TM * TK; e += blockDim.x) {
      const int r = e / TK, c = e % TK;
      const float g = sb.dg[r * LDF + c] * gelu_tanh_grad(sb.pre[r * LDF + c] + b1[j + c]);
      sb.hs[r * LDC + c] = __float2bfloat16_rn(g);
    }
    wait_copies();  // w1c, and dh is whole
    // dx[:, slab] += dh w1[slab, j:j+64]^T: B[k][n] = w1c[n * LDC + k]
    slab_product<true>(acc, sb.hs, w1c, LDC, ncol);
    __syncthreads();  // the stage and hs are free
  }
  store_slab(dxs, acc, ncol);
  __syncthreads();
  const int vec = ncol / 8;
  for (int e = threadIdx.x; e < TM * vec; e += blockDim.x) {
    const int r = e / vec, c = (e % vec) * 8;
    store8(dx + (row0 + r) * d + col0 + c, dxs + r * LDY + c);
  }
}

// dw1's slab (nrow rows of d from col0 of the tile xs) x the 64-wide
// chunk: A = x^T (column-major view of the tile), B = dh. The warp owns row groups
// 2 warp + g (g < 2) and the chunk's four column groups: acc[4 g + cg].
__device__ __forceinline__ void dw1_product(FragC (&acc)[8], const bf16* xs, int ldx, int col0,
                                            int nrow, const bf16* dhs) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int kk = 0; kk < TM; kk += 16) {
    FragB fb[4];
#pragma unroll
    for (int cg = 0; cg < 4; ++cg) wmma::load_matrix_sync(fb[cg], dhs + kk * LDC + 16 * cg, LDC);
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int m0 = (2 * warp + g) * 16;
      if (m0 >= nrow) continue;
      FragAT fa;
      wmma::load_matrix_sync(fa, xs + kk * ldx + col0 + m0, ldx);
#pragma unroll
      for (int cg = 0; cg < 4; ++cg) wmma::mma_sync(acc[4 * g + cg], fa, fb[cg], acc[4 * g + cg]);
    }
  }
}

// dw2's chunk rows x slab (ncol columns of d_out from col0 of the tile
// dys): A = h^T (column-major view of h), B = dy. The warp owns row group
// warp % 4 and column groups 8 (warp / 4) + f: acc[f].
__device__ __forceinline__ void dw2_product(FragC (&acc)[8], const bf16* hs, const bf16* dys,
                                            int ldy, int col0, int ncol) {
  const int warp = threadIdx.x / 32;
  const int ar = (warp % 4) * 16, bc0 = (warp / 4) * 128;
#pragma unroll
  for (int kk = 0; kk < TM; kk += 16) {
    FragAT fa;
    wmma::load_matrix_sync(fa, hs + kk * LDC + ar, LDC);
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const int bc = bc0 + 16 * f;
      if (bc >= ncol) continue;
      FragB fb;
      wmma::load_matrix_sync(fb, dys + kk * ldy + col0 + bc, ldy);
      wmma::mma_sync(acc[f], fa, fb, acc[f]);
    }
  }
}

// part: splits x (d dh + dh d_out + dh) floats: per split, dw1 (d, dh),
// dw2 (dh, d_out), db1 (dh).
template <typename T>
__global__ void __launch_bounds__(kThreads) mlp_bwd_weights_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2, float* __restrict__ part, int N,
    int d, int dh, int dout) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Buffers sb(smem);
  bf16* tile = sb.stage;  // x[rows, slab] or dy[rows, slab], TM x LDS, after the products
  const int j = blockIdx.x * TK;
  const int split = blockIdx.y, splits = gridDim.y;
  const int nd = (d + SLAB - 1) / SLAB;
  const bool is_dw1 = static_cast<int>(blockIdx.z) < nd;
  const int col0 = (is_dw1 ? blockIdx.z : blockIdx.z - nd) * SLAB;
  const int ncol = min(SLAB, (is_dw1 ? d : dout) - col0);
  const int64_t tiles = N / TM;
  const int64_t t0 = tiles * split / splits, t1 = tiles * (split + 1) / splits;

  FragC acc[8];
  zero(acc);
  // db1 (first dw1 slab only): thread t sums column t % 64 over row quarter
  // t / 64 of every tile; the quarters are added in order at the end
  const bool sums_db1 = is_dw1 && blockIdx.z == 0;
  const int db_col = threadIdx.x % TK, db_row0 = (threadIdx.x / TK) * (TM / 4);
  float db1 = 0.f;
  for (int64_t t = t0; t < t1; ++t) {
    const int64_t row0 = t * TM;
    FragC pa[2];
    zero(pa);
    stream_product<false>(pa, x + row0 * d, d, w1 + j, dh, d, sb.stage);
    store_chunk(sb.pre, pa);
    if (is_dw1) {
      FragC ga[2];
      zero(ga);
      stream_product<true>(ga, dy + row0 * dout, dout, w2 + static_cast<int64_t>(j) * dout, dout,
                           dout, sb.stage);
      store_chunk(sb.dg, ga);
      load_tile(tile, LDS, x + row0 * d + col0, d, TM, ncol);
    } else {
      load_tile(tile, LDS, dy + row0 * dout + col0, dout, TM, ncol);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < TM * TK; e += blockDim.x) {
      const int r = e / TK, c = e % TK;
      const float p = sb.pre[r * LDF + c] + b1[j + c];
      if (is_dw1) {
        const float g = sb.dg[r * LDF + c] * gelu_tanh_grad(p);
        sb.dg[r * LDF + c] = g;
        sb.hs[r * LDC + c] = __float2bfloat16_rn(g);
      } else {
        sb.hs[r * LDC + c] = __float2bfloat16_rn(gelu_tanh(p));
      }
    }
    __syncthreads();
    if (is_dw1) {
      if (sums_db1) {
#pragma unroll
        for (int r = 0; r < TM / 4; ++r) db1 += sb.dg[(db_row0 + r) * LDF + db_col];
      }
      dw1_product(acc, tile, LDS, 0, ncol, sb.hs);
    } else {
      dw2_product(acc, sb.hs, tile, LDS, 0, ncol);
    }
    __syncthreads();  // the next tile overwrites the stage, pre, dg and hs
  }
  if (sums_db1) {
    sb.pre[threadIdx.x] = db1;  // pre is free: its last reader synchronised above
    __syncthreads();
    if (threadIdx.x < TK) {
      db1 = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) db1 += sb.pre[q * TK + threadIdx.x];
    }
  }

  const int64_t total = static_cast<int64_t>(d) * dh + static_cast<int64_t>(dh) * dout + dh;
  float* pw1 = part + split * total;
  float* pw2 = pw1 + static_cast<int64_t>(d) * dh;
  float* pb1 = pw2 + static_cast<int64_t>(dh) * dout;
  const int warp = threadIdx.x / 32;
  if (is_dw1) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int m0 = (2 * warp + g) * 16;
      if (m0 >= ncol) continue;
#pragma unroll
      for (int cg = 0; cg < 4; ++cg) {
        wmma::store_matrix_sync(pw1 + static_cast<int64_t>(col0 + m0) * dh + j + 16 * cg,
                                acc[4 * g + cg], dh, wmma::mem_row_major);
      }
    }
    if (sums_db1 && threadIdx.x < TK) pb1[j + threadIdx.x] = db1;
  } else {
    const int ar = (warp % 4) * 16, bc0 = (warp / 4) * 128;
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const int bc = bc0 + 16 * f;
      if (bc >= ncol) continue;
      wmma::store_matrix_sync(pw2 + static_cast<int64_t>(j + ar) * dout + col0 + bc, acc[f], dout,
                              wmma::mem_row_major);
    }
  }
}

// out[i] = sum over s in order of part[s][i]
__global__ void __launch_bounds__(kThreads) sum_splits_kernel(const float* __restrict__ part,
                                                              float* __restrict__ out,
                                                              int64_t total, int splits) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[k * total + i];
    out[i] = s;
  }
}

template <typename T>
int launch(const void* x, const void* dy, const bf16* w1, const float* b1, const bf16* w2,
           void* dx, float* part, float* grads, int N, int d, int dh, int dout, int splits,
           cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes();
  cudaFuncSetAttribute(mlp_bwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  cudaFuncSetAttribute(mlp_bwd_weights_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  mlp_bwd_rows_kernel<T><<<dim3(N / TM, (d + SLAB - 1) / SLAB), kThreads, smem, stream>>>(
      xt, dyt, w1, b1, w2, static_cast<T*>(dx), d, dh, dout);
  const dim3 wgrid(dh / TK, splits, (d + SLAB - 1) / SLAB + (dout + SLAB - 1) / SLAB);
  mlp_bwd_weights_kernel<T><<<wgrid, kThreads, smem, stream>>>(xt, dyt, w1, b1, w2, part, N, d,
                                                               dh, dout);
  const int64_t total = static_cast<int64_t>(d) * dh + static_cast<int64_t>(dh) * dout + dh;
  sum_splits_kernel<<<static_cast<int>((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, grads, total, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace MLP_NS

// x (N, d), dy (N, d_out) and dx (N, d) contiguous, all float32 (is_bf16 ==
// 0) or all bfloat16; w1 (d, dh) and w2 (dh, d_out) contiguous bfloat16; b1
// (dh,) float32. part holds splits x (d dh + dh d_out + dh) floats of
// workspace; grads receives (d dh + dh d_out + dh) floats: dw1 (d, dh), dw2
// (dh, d_out), db1 (dh); every pointer 16-byte aligned. N, d, dh, d_out
// multiples of 64. Launches on `stream`, does not synchronise; returns the
// cudaError_t of the launches (0 on success).
extern "C" int hyena_mlp_bwd(const void* x, const void* dy, const void* w1, const float* b1,
                             const void* w2, void* dx, float* part, float* grads, int N, int d,
                             int dh, int dout, int splits, int is_bf16, cudaStream_t stream) {
  using namespace MLP_NS;
  if (!valid_widths(N, d, dh, dout) || splits < 1 || splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* w1b = static_cast<const bf16*>(w1);
  const auto* w2b = static_cast<const bf16*>(w2);
  if (is_bf16) {
    return launch<bf16>(x, dy, w1b, b1, w2b, dx, part, grads, N, d, dh, dout, splits, stream);
  }
  return launch<float>(x, dy, w1b, b1, w2b, dx, part, grads, N, d, dh, dout, splits, stream);
}
