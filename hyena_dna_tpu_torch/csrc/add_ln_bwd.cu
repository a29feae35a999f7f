// Kernel D': the backward of the fused residual-add + LayerNorm (kernel D,
// add_ln.cu), for Hopper.
//
//   d_total = bf16(rstd * (dy*s - mean(dy*s) - x_hat * mean(dy*s * x_hat))
//                  + dres_up)                             serves as dh and dres
//   dscale  = sum_rows dy * x_hat,  dbias = sum_rows dy   float32
//
// res_out, dy, dres_up and d_total are bfloat16 (N, d), row-major; scale,
// dscale and dbias are float32 (d). It recomputes mean and rstd from the
// stored res_out instead of saving them.
//
// Replaces hyena_dna_tpu/ops/pallas_ln.py::add_ln_fused's backward:
// _bwd_kernel (its pallas_call in _bwd).
//
// What bounds it on the H100: bytes. It reads three and writes one bf16
// (N, d) tensors, 8 bytes per element: 268 MB at N = 4 x 32768, d = 256,
// 0.080 ms at 3.35 TB/s, against ~16 float32 operations per element.
//
// Design: one warp per row (add_ln_common.cuh) on a fixed grid of P <= 1024
// blocks; warp w of block q takes rows q * 8 + w, + 8P, ... and keeps its
// lanes' dscale/dbias columns in registers. Each block sums its eight warps
// in a fixed order into a float32 partial (P, 2, d); a second kernel sums
// the P partials per column in a fixed order. No atomics: the same inputs
// give the same bits on every run. (The TPU kernel accumulated these in an
// (8, d) output block revisited by its sequential grid.)
#include "add_ln_common.cuh"

namespace {

using namespace add_ln;

template <int V, int NC>
__global__ void __launch_bounds__(kThreads) add_ln_bwd_kernel(
    const bf16* __restrict__ res_out, const bf16* __restrict__ dy, const bf16* __restrict__ dres_up,
    const float* __restrict__ scale, bf16* __restrict__ d_total, float* __restrict__ part, int n,
    float eps) {
  constexpr int D = NC * 32 * V;
  constexpr float kInvD = 1.f / D;
  __shared__ float red[kWarps][D];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float ds[NC][V], db[NC][V], s[NC][V];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      ds[c][i] = 0.f;
      db[c][i] = 0.f;
      s[c][i] = scale[col_of<V>(c, lane) + i];
    }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp; row < n; row += stride) {
    const int64_t base = row * D;
    float x[NC][V], g[NC][V];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      load_vec<V>(res_out + base + col_of<V>(c, lane), x[c]);
      load_vec<V>(dy + base + col_of<V>(c, lane), g[c]);
    }
    float mean, rstd;
    row_stats<V, NC>(x, eps, mean, rstd);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        x[c][i] = (x[c][i] - mean) * rstd;  // x_hat from here on
        const float dyw = g[c][i] * s[c][i];
        m1 += dyw;
        m2 += dyw * x[c][i];
        ds[c][i] += g[c][i] * x[c][i];
        db[c][i] += g[c][i];
      }
    m1 = warp_sum(m1) * kInvD;
    m2 = warp_sum(m2) * kInvD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = col_of<V>(c, lane);
      float up[V], out[V];
      load_vec<V>(dres_up + base + col, up);
#pragma unroll
      for (int i = 0; i < V; ++i)
        out[i] = rstd * (g[c][i] * s[c][i] - m1 - x[c][i] * m2) + up[i];
      store_vec<V>(d_total + base + col, out);
    }
  }
  // this block's partials, its warps summed in order: part[blockIdx.x][0] = dscale,
  // part[blockIdx.x][1] = dbias
  float* out = part + static_cast<int64_t>(blockIdx.x) * 2 * D;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < V; ++i) red[warp][col_of<V>(c, lane) + i] = which ? db[c][i] : ds[c][i];
    __syncthreads();
    for (int j = threadIdx.x; j < D; j += kThreads) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += red[w][j];
      out[which * D + j] = t;
    }
    __syncthreads();
  }
}

// out[j] = sum_{q < P} part[q * ncols + j], in a fixed order: 32 columns per
// block, 8 strided runs of q per column, then the 8 runs in order.
__global__ void __launch_bounds__(kThreads) add_ln_sum_kernel(const float* __restrict__ part,
                                                              int P, int ncols,
                                                              float* __restrict__ out) {
  __shared__ float red[kWarps][33];
  const int lane = threadIdx.x % 32;
  const int grp = threadIdx.x / 32;
  const int j = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (j < ncols) {
    for (int q = grp; q < P; q += kWarps) s += part[static_cast<int64_t>(q) * ncols + j];
  }
  red[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && j < ncols) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < kWarps; ++g) t += red[g][lane];
    out[j] = t;
  }
}

template <int V, int NC>
int launch_bwd(const void* res_out, const void* dy, const void* dres_up, const float* scale,
               void* d_total, float* dparams, float* part, int n, int blocks, float eps,
               cudaStream_t stream) {
  constexpr int D = NC * 32 * V;
  add_ln_bwd_kernel<V, NC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const bf16*>(res_out), static_cast<const bf16*>(dy),
      static_cast<const bf16*>(dres_up), scale, static_cast<bf16*>(d_total), part, n, eps);
  add_ln_sum_kernel<<<(2 * D + 31) / 32, kThreads, 0, stream>>>(part, blocks, 2 * D, dparams);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// res_out, dy, dres_up, d_total: bfloat16 (n, d) contiguous, 16-byte
// aligned; scale (d) float32; d in ADD_LN_DISPATCH; outputs d_total and
// dparams (2, d) float32 = [dscale; dbias]. Scratch: part (blocks * 2 * d)
// float32, 1 <= blocks <= 65535. Launches on `stream`, does not synchronise;
// returns the cudaError_t of the launches.
extern "C" int hyena_add_ln_bwd(const void* res_out, const void* dy, const void* dres_up,
                                const float* scale, void* d_total, float* dparams, float* part,
                                int n, int d, int blocks, float eps, cudaStream_t stream) {
  if (n < 1 || blocks < 1 || blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
#define BWD(V, NC) \
  launch_bwd<V, NC>(res_out, dy, dres_up, scale, d_total, dparams, part, n, blocks, eps, stream)
  ADD_LN_DISPATCH(d, BWD)
#undef BWD
}
