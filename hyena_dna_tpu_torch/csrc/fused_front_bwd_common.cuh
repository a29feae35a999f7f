// The backward of the fused Hyena front end, shared by kernel A'
// (fused_front_bwd.cu, cotangents (B, d, L)) and kernel A4'
// (fused_front4_bwd.cu, cotangents in the padded (B, d, ld) layout of the
// 4-D conv route, of which only the times t < L are read: the padded tail
// of vx and x0 is a constant zero, so its cotangents carry nothing). One
// template, so the two cannot drift.
//
// Forward: proj = u @ W + bp (B, L, 3d); conv = causal k=3 depthwise conv
// of proj over time + bc (taps wc, wc[j] multiplies proj[t - 2 + j], zero
// left padding); [x0 | x1 | v] = conv; outputs vx = v * x1 and x0.
//
// Backward, from the cotangents dvx, dx0:
//   dconv = [dx0 | dvx * v | dvx * x1]                  (B, L, 3d)
//   dproj[s] = wc[0] dconv[s+2] + wc[1] dconv[s+1] + wc[2] dconv[s]
//   du  = dproj @ W^T        dW  = u^T @ dproj          dbp = sum_s dproj[s]
//   dwc[j] = sum_t dconv[t] proj[t - 2 + j]             dbc = sum_t dconv[t]
// u, dvx, dx0 and du are float32, or all four bfloat16 (du in u's dtype as
// the Pallas kernel's); W, bp, wc, bc, dW, the bias/tap grads and the dproj
// scratch are float32. The arithmetic is float32 either way: bf16 inputs
// are widened on load and du is rounded once.
//
// Design (simple and correct first; no tensor cores yet):
//  * Pass 1, front_bwd_tile_kernel: one block per (32-channel group, time
//    tile, batch row), as kernel A. The TPU kernel walked tiles right to
//    left and carried two dconv rows; CUDA blocks run in any order, so each
//    block recomputes a 2-row halo on both sides: it projects the 64 rows
//    t0-2 .. t0+61 (the x0, x1 and v columns of its channels, a shared-
//    memory SGEMM), forms dconv at t0 .. t0+61 and emits dproj for the 60
//    times t0 .. t0+59 into a (B*L, 3d) float32 scratch. Rows before t = 0
//    are zero (the forward pads proj, bias included, with zeros) and dconv
//    past L is zero, so any L works. The block also reduces its 60 rows into
//    per-tile partials of dbp, dwc and dbc.
//  * Pass 2, du = dproj @ W^T, and pass 3, dW = u^T @ dproj: one tiled
//    SGEMM (128 x 128 block tile, 8 x 8 register tile per thread, float32
//    accumulation). dW reduces over all B*L rows across blocks: split-K
//    into per-slice partials, each slice a fixed run of rows.
//  * Pass 4: fixed-order column sums of the dW slices and the per-tile
//    partials. No atomics, so the result does not vary from run to run.
//  * The dproj round trip through device memory (12 bytes per (t, channel)
//    written, then read twice) is the price of keeping every pass a plain
//    tiled loop; fusing du and dW into pass 1 is later work.
#pragma once

#include "bf16_io.cuh"

// FRONT_NS, defined by the including source, names the kernels for profiles.
namespace FRONT_NS {

using bf16_io::from_f32;
using bf16_io::to_f32;

constexpr int kRows = 64;            // projected rows per tile: t0-2 .. t0+61
constexpr int kConvRows = kRows - 2;  // dconv rows: t0 .. t0+61
constexpr int kOut = kRows - 4;      // dproj rows (times owned): t0 .. t0+59
constexpr int kCB = 32;              // channels per block
constexpr int kCols = 3 * kCB;       // projected columns per block
constexpr int kTK = 32;              // reduction chunk of the projection
constexpr int kThreads = 256;
constexpr int kParts = 5;            // dbp, dwc[0], dwc[1], dwc[2], dbc
constexpr int kStride = kCols + 1;
constexpr int kUsSize = kTK * (kRows + 1);
constexpr int kWsSize = kTK * kCols;
constexpr size_t kTileSmem = sizeof(float) * (kUsSize + kWsSize + (kRows + kConvRows) * kStride);

template <typename T>
__global__ void __launch_bounds__(kThreads) front_bwd_tile_kernel(
    const T* __restrict__ u, const float* __restrict__ w, const float* __restrict__ bp,
    const float* __restrict__ wc, const float* __restrict__ bc, const T* __restrict__ dvx,
    const T* __restrict__ dx0, float* __restrict__ dproj, float* __restrict__ part, int L,
    int ld, int d) {
  extern __shared__ float smem[];
  auto us = reinterpret_cast<float(*)[kRows + 1]>(smem);
  auto ws = reinterpret_cast<float(*)[kCols]>(smem + kUsSize);
  auto ps = reinterpret_cast<float(*)[kStride]>(smem + kUsSize + kWsSize);
  auto dc = reinterpret_cast<float(*)[kStride]>(smem + kUsSize + kWsSize + kRows * kStride);

  const int c0 = blockIdx.x * kCB;
  const int tile = blockIdx.y;
  const int t0 = tile * kOut;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int d3 = 3 * d;
  const int trow0 = t0 - 2;  // time of projected row 0
  const T* ub = u + static_cast<int64_t>(b) * L * d;

  // projection of rows t0-2 .. t0+61, columns [x0 | x1 | v] of channels c0..c0+31
  float acc[4][6];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[r][j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kTK) {
    for (int i = tid; i < kRows * kTK; i += kThreads) {
      const int r = i / kTK, kk = i % kTK;
      const int t = trow0 + r;
      us[kk][r] = (t >= 0 && t < L && k0 + kk < d)
                      ? to_f32(ub[static_cast<int64_t>(t) * d + k0 + kk])
                      : 0.f;
    }
    for (int i = tid; i < kTK * kCols; i += kThreads) {
      const int kk = i / kCols, j = i % kCols;
      const int ch = c0 + j % kCB;
      ws[kk][j] = (k0 + kk < d && ch < d)
                      ? w[static_cast<int64_t>(k0 + kk) * d3 + (j / kCB) * d + ch]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTK; ++kk) {
      float a[4], bb[6];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = us[kk][ty * 4 + r];
#pragma unroll
      for (int j = 0; j < 6; ++j) bb[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 6; ++j) acc[r][j] = fmaf(a[r], bb[j], acc[r][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    const int t = trow0 + row;
    const bool live = t >= 0 && t < L;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int col = tx + 16 * j;
      const int ch = c0 + col % kCB;
      ps[row][col] = (live && ch < d) ? acc[r][j] + bp[(col / kCB) * d + ch] : 0.f;
    }
  }
  __syncthreads();

  // dconv at t0 .. t0+61 (zero past L)
  for (int i = tid; i < kCB * kConvRows; i += kThreads) {
    const int c = i / kConvRows, rr = i % kConvRows;
    const int t = t0 + rr;
    const int ch = c0 + c;
    float g0 = 0.f, g1 = 0.f, g2 = 0.f;
    if (t < L && ch < d) {
      float x[2];
#pragma unroll
      for (int grp = 1; grp < 3; ++grp) {
        const int col = grp * kCB + c;
        const int gc = grp * d + ch;
        x[grp - 1] = ps[rr][col] * wc[gc] + ps[rr + 1][col] * wc[d3 + gc] +
                     ps[rr + 2][col] * wc[2 * d3 + gc] + bc[gc];
      }
      const int64_t o = (static_cast<int64_t>(b) * d + ch) * ld + t;
      const float gvx = to_f32(dvx[o]);
      g0 = to_f32(dx0[o]);
      g1 = gvx * x[1];  // d x1 = dvx * v
      g2 = gvx * x[0];  // d v  = dvx * x1
    }
    dc[rr][c] = g0;
    dc[rr][kCB + c] = g1;
    dc[rr][2 * kCB + c] = g2;
  }
  __syncthreads();

  // dproj at t0 .. t0+59: the transposed conv
  for (int i = tid; i < kOut * kCols; i += kThreads) {
    const int rr = i / kCols, col = i % kCols;
    const int s = t0 + rr;
    const int ch = c0 + col % kCB;
    if (s >= L || ch >= d) continue;
    const int gc = (col / kCB) * d + ch;
    dproj[(static_cast<int64_t>(b) * L + s) * d3 + gc] =
        wc[gc] * dc[rr + 2][col] + wc[d3 + gc] * dc[rr + 1][col] + wc[2 * d3 + gc] * dc[rr][col];
  }

  // per-tile partial sums over the 60 owned times
  if (tid < kCols) {
    const int col = tid;
    const int ch = c0 + col % kCB;
    if (ch < d) {
      const int gc = (col / kCB) * d + ch;
      const float w0 = wc[gc], w1 = wc[d3 + gc], w2 = wc[2 * d3 + gc];
      float sbp = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f, sbc = 0.f;
      for (int rr = 0; rr < kOut; ++rr) {
        const float g = dc[rr][col];
        sbp += w0 * dc[rr + 2][col] + w1 * dc[rr + 1][col] + w2 * g;
        s0 += g * ps[rr][col];
        s1 += g * ps[rr + 1][col];
        s2 += g * ps[rr + 2][col];
        sbc += g;
      }
      float* pp = part + static_cast<int64_t>(b * gridDim.y + tile) * kParts * d3 + gc;
      pp[0] = sbp;
      pp[d3] = s0;
      pp[2 * d3] = s1;
      pp[3 * d3] = s2;
      pp[4 * d3] = sbc;
    }
  }
}

constexpr int kGM = 128, kGN = 128, kGK = 8, kGPad = 4;

// C[m, n] = sum_{k in this block's slice} A(m, k) B(k, n), for slice
// blockIdx.z of width k_chunk, into C + blockIdx.z * c_slice. A(m, k) is
// A[m * lda + k], or A[k * lda + m] with kAMContig; B(k, n) is
// B[k * ldb + n] with kBNContig, else B[n * ldb + k]. A is float32 or bf16
// (widened on load), B float32; C is rounded once to TC.
template <bool kAMContig, bool kBNContig, typename TA, typename TC>
__global__ void __launch_bounds__(kThreads) front_bwd_gemm_kernel(
    const TA* __restrict__ A, int64_t lda, const float* __restrict__ Bm, int64_t ldb,
    TC* __restrict__ C, int64_t ldc, int64_t c_slice, int M, int N, int K, int k_chunk) {
  __shared__ float As[kGK][kGM + kGPad];
  __shared__ float Bs[kGK][kGN + kGPad];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * kGN;
  const int m0 = blockIdx.y * kGM;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  for (int k0 = kb; k0 < ke; k0 += kGK) {
    for (int e = tid; e < kGM * kGK; e += kThreads) {
      const int mm = kAMContig ? e % kGM : e / kGK;
      const int kk = kAMContig ? e / kGM : e % kGK;
      const int gm = m0 + mm, gk = k0 + kk;
      float v = 0.f;
      if (gm < M && gk < ke) {
        v = to_f32(kAMContig ? A[static_cast<int64_t>(gk) * lda + gm]
                             : A[static_cast<int64_t>(gm) * lda + gk]);
      }
      As[kk][mm] = v;
    }
    for (int e = tid; e < kGN * kGK; e += kThreads) {
      const int nn = kBNContig ? e % kGN : e / kGK;
      const int kk = kBNContig ? e / kGN : e % kGK;
      const int gn = n0 + nn, gk = k0 + kk;
      float v = 0.f;
      if (gn < N && gk < ke) {
        v = kBNContig ? Bm[static_cast<int64_t>(gk) * ldb + gn] : Bm[static_cast<int64_t>(gn) * ldb + gk];
      }
      Bs[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK; ++kk) {
      float a[8], bb[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) a[r] = As[kk][ty + 16 * r];
#pragma unroll
      for (int j = 0; j < 8; ++j) bb[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(a[r], bb[j], acc[r][j]);
    }
    __syncthreads();
  }
  TC* out = C + blockIdx.z * c_slice;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int gm = m0 + ty + 16 * r;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[static_cast<int64_t>(gm) * ldc + gn] = from_f32<TC>(acc[r][j]);
    }
  }
}

// out[j] = sum_{q < P} part[q * ncols + j], in a fixed order: 32 columns per
// block, 8 strided runs of q per column, then the 8 runs in order.
__global__ void __launch_bounds__(kThreads) front_bwd_sum_kernel(
    const float* __restrict__ part, int P, int ncols, float* __restrict__ out) {
  __shared__ float red[8][33];
  const int lane = threadIdx.x % 32;
  const int grp = threadIdx.x / 32;
  const int j = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (j < ncols) {
    for (int q = grp; q < P; q += 8) s += part[static_cast<int64_t>(q) * ncols + j];
  }
  red[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && j < ncols) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < 8; ++g) t += red[g][lane];
    out[j] = t;
  }
}

template <typename T>
int launch(const T* u, const float* w, const float* bp, const float* wc, const float* bc,
           const T* dvx, const T* dx0, T* du, float* dw, float* dparams, float* dproj,
           float* part, float* dwpart, int B, int L, int ld, int d, int tiles, int slices,
           cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * L;
  if (B < 1 || L < 1 || d < 1 || ld < L || B > 65535 || tiles != (L + kOut - 1) / kOut ||
      tiles > 65535 || slices < 1 || slices > 65535 || (rows + kGM - 1) / kGM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int d3 = 3 * d;
  const int M = static_cast<int>(rows);
  cudaFuncSetAttribute(front_bwd_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(kTileSmem));
  front_bwd_tile_kernel<T><<<dim3((d + kCB - 1) / kCB, tiles, B), kThreads, kTileSmem, stream>>>(
      u, w, bp, wc, bc, dvx, dx0, dproj, part, L, ld, d);
  // du = dproj @ W^T: A = dproj (M, 3d), B(k, n) = W[n, k]
  front_bwd_gemm_kernel<false, false, float, T>
      <<<dim3((d + kGN - 1) / kGN, (M + kGM - 1) / kGM, 1), kThreads, 0, stream>>>(
          dproj, d3, w, d3, du, d, 0, M, d, d3, d3);
  // dW slices = u^T @ dproj over runs of rows: A(m, k) = u[k, m], B = dproj (M, 3d)
  const int k_chunk = static_cast<int>((rows + slices - 1) / slices);
  front_bwd_gemm_kernel<true, true, T, float>
      <<<dim3((d3 + kGN - 1) / kGN, (d + kGM - 1) / kGM, slices), kThreads, 0, stream>>>(
          u, d, dproj, d3, dwpart, d3, static_cast<int64_t>(d) * d3, d, d3, M, k_chunk);
  front_bwd_sum_kernel<<<(d * d3 + 31) / 32, kThreads, 0, stream>>>(dwpart, slices, d * d3, dw);
  front_bwd_sum_kernel<<<(kParts * d3 + 31) / 32, kThreads, 0, stream>>>(part, B * tiles,
                                                                         kParts * d3, dparams);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace FRONT_NS
