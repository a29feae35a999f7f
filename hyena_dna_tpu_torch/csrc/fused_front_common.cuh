// The fused Hyena front end's forward tile, shared by kernel A
// (fused_front.cu, channel-major (B, d, L) outputs) and kernel A4
// (fused_front4.cu, the same outputs in the padded (B, d, ld) layout of the
// 4-D conv route, ld >= L, with the tail t in [L, ld) written as zeros).
// One template, so the two cannot drift.
//
//   proj = u @ W + bp                                   (B, L, 3d), float32
//   conv = causal depthwise k=3 conv of proj over time, zero left padding,
//          plus the conv bias bc                        (taps wc, time-major)
//   [x0 | x1 | v] = conv split along channels
//   vx = v * x1, x0                                     both (B, d, ld)
//
// u (B, L, d), vx and x0 are float32, or all three bfloat16; W (d, 3d), bp
// (3d), wc (3, 3d) with wc[j] multiplying proj[t - 2 + j] and bc (3d) are
// float32. The arithmetic is float32 either way: bf16 u is widened on load,
// so proj stays float32 and vx, x0 are rounded once.
//
// Design (simple and correct first; no tensor cores yet):
//  * One block per (channel group of CB=32 outputs, 64-row time tile, batch
//    row). The block computes the 64 x 96 projection tile it needs -- the
//    x0, x1 and v columns of its 32 channels -- as a shared-memory tiled
//    SGEMM with a 4 x 6 register tile per thread and float32 accumulation.
//  * The TPU kernels carried the previous tile's last two projected rows in
//    scratch across a sequential grid. CUDA blocks run in any order, so each
//    tile recomputes its own 2-row halo: the 64 projected rows cover times
//    t0 - 2 .. t0 + 61 and the block emits the 62 outputs t0 .. t0 + 61.
//    Rows before t = 0 are zero (the conv pads the projection, bias
//    included, with zeros), rows past L are masked, so any L works.
//  * The grid covers ld; a tile that starts at or past L skips the product
//    and only stores zeros, so the zero tail costs its bytes and no more.
//  * Channel groups vary fastest in the grid, so the blocks that share a u
//    tile run together and read it from L2.
//  * The conv, gate and the transpose to channel-major happen in shared
//    memory; stores are coalesced along time.
#pragma once

#include "bf16_io.cuh"

// FRONT_NS, defined by the including source, names the kernel for profiles.
namespace FRONT_NS {

using bf16_io::from_f32;
using bf16_io::to_f32;

constexpr int kRows = 64;           // projected rows per block
constexpr int kOut = kRows - 2;     // output times per block
constexpr int kCB = 32;             // output channels per block
constexpr int kCols = 3 * kCB;      // projected columns per block
constexpr int kTK = 32;             // reduction chunk
constexpr int kThreads = 256;       // 16 x 16; thread owns 4 rows x 6 columns

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_front_kernel(
    const T* __restrict__ u, const float* __restrict__ w, const float* __restrict__ bp,
    const float* __restrict__ wc, const float* __restrict__ bc, T* __restrict__ vx,
    T* __restrict__ x0, int L, int ld, int d) {
  __shared__ float us[kTK][kRows + 1];
  __shared__ float ws[kTK][kCols];
  __shared__ float ps[kRows][kCols + 1];

  const int c0 = blockIdx.x * kCB;
  const int t0 = blockIdx.y * kOut;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int d3 = 3 * d;
  const int trow0 = t0 - 2;  // time of projected row 0
  const T* ub = u + static_cast<int64_t>(b) * L * d;

  if (t0 >= L) {  // wholly in the zero tail (the whole block takes this branch)
    for (int i = tid; i < kCB * kOut; i += kThreads) {
      const int c = i / kOut, t = t0 + i % kOut;
      const int ch = c0 + c;
      if (t >= ld || ch >= d) continue;
      const int64_t o = (static_cast<int64_t>(b) * d + ch) * ld + t;
      x0[o] = from_f32<T>(0.f);
      vx[o] = from_f32<T>(0.f);
    }
    return;
  }

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
    const bool live = trow0 + row >= 0;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int col = tx + 16 * j;
      const int ch = c0 + col % kCB;
      ps[row][col] = (live && ch < d) ? acc[r][j] + bp[(col / kCB) * d + ch] : 0.f;
    }
  }
  __syncthreads();

  for (int i = tid; i < kCB * kOut; i += kThreads) {
    const int c = i / kOut, rr = i % kOut;
    const int t = t0 + rr;
    const int ch = c0 + c;
    if (t >= ld || ch >= d) continue;
    const int64_t o = (static_cast<int64_t>(b) * d + ch) * ld + t;
    if (t >= L) {  // the zero tail of a tile that straddles L
      x0[o] = from_f32<T>(0.f);
      vx[o] = from_f32<T>(0.f);
      continue;
    }
    const int r = rr + 2;  // row of time t
    float g[3];
#pragma unroll
    for (int grp = 0; grp < 3; ++grp) {
      const int col = grp * kCB + c;
      const int gc = grp * d + ch;
      g[grp] = ps[r - 2][col] * wc[gc] + ps[r - 1][col] * wc[d3 + gc] +
               ps[r][col] * wc[2 * d3 + gc] + bc[gc];
    }
    x0[o] = from_f32<T>(g[0]);
    vx[o] = from_f32<T>(g[2] * g[1]);
  }
}

// vx, x0 (B, d, ld) from u (B, L, d); ld == L for kernel A.
template <typename T>
int launch(const T* u, const float* w, const float* bp, const float* wc, const float* bc, T* vx,
           T* x0, int B, int L, int ld, int d, cudaStream_t stream) {
  const int tiles = (ld + kOut - 1) / kOut;
  if (B < 1 || L < 1 || d < 1 || ld < L || tiles > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((d + kCB - 1) / kCB, tiles, B);
  fused_front_kernel<T><<<grid, kThreads, 0, stream>>>(u, w, bp, wc, bc, vx, x0, L, ld, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace FRONT_NS
