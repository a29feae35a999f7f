// The backward of the fused Hyena front end, shared by kernel A'
// (fused_front_bwd.cu, cotangents (B, d, L)) and kernel A4'
// (fused_front4_bwd.cu, cotangents in the padded (B, d, ld) layout of the
// 4-D conv route, of which only the times t < L are read: the padded tail
// of vx and x0 is a constant zero, so its cotangents carry nothing). One
// template, so the two cannot drift.
//
// Forward: proj = u @ W + bp (B, L, 3 dc); conv = causal k=3 depthwise conv
// of proj over time + bc (taps wc, wc[j] multiplies proj[t - 2 + j], zero
// left padding); [x0 | x1 | v] = conv; outputs vx = v * x1 and x0. u is
// (B, L, di), W (di, 3 dc), the outputs and their cotangents (B, dc, ld):
// the whole model runs di == dc (d); a tensor-parallel rank runs di = d and
// dc = d / M, its channel slice of each chunk, and its du is a partial sum.
//
// Backward, from the cotangents dvx, dx0:
//   dconv = [dx0 | dvx * v | dvx * x1]                  (B, L, 3 dc)
//   dproj[s] = wc[0] dconv[s+2] + wc[1] dconv[s+1] + wc[2] dconv[s]
//   du  = dproj @ W^T        dW  = u^T @ dproj          dbp = sum_s dproj[s]
//   dwc[j] = sum_t dconv[t] proj[t - 2 + j]             dbc = sum_t dconv[t]
// u, dvx, dx0 and du are float32, or all four bfloat16 (du in u's dtype as
// the Pallas kernel's); W, bp, wc, bc, dW and the bias/tap grads are
// float32. The arithmetic is float32 either way and du is rounded once.
//
// float32 u, the CUDA-core passes:
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
//
// bfloat16 u, the tensor-core passes (fused_front_tc.cuh: W split into bf16
// pairs once per call, every product on wgmma). No dproj in device memory:
// each pass recomputes proj and dconv for its tile from u, dvx and dx0.
//  * A'1, front_bwd_du_kernel: one block (two warpgroups) per (120-time
//    tile, 256-input chunk of du, batch row). The u rows t0-2 .. t0+125 stay
//    in shared memory while the block loops over the dc / 16 channel groups
//    (W panels double-buffered as in kernel A). Per group: project the x1
//    and v columns (m64n32k16), form dconv and the transposed conv in
//    registers (dproj_item: one thread per channel and 8 times), split
//    dproj into bf16 pairs in shared memory, and add dproj_group W_group^T
//    to du, 128 x 256 float32 in registers (m64n64k16 per 64 inputs, three
//    products). du is rounded once and stored time-major.
//  * A'2, front_bwd_dw_kernel: one block per (channel group, 256-input chunk
//    of dW, fixed run of 60-time tiles). The group's W panels stay in shared
//    memory; the tiles' u rows are double-buffered. Per tile: project the
//    group's 48 columns, form dproj (and the run's dbp, dwc, dbc partials),
//    then dW_group (d x 48) += u_tile^T dproj (u MN-major as A, dproj as B,
//    two products; each warpgroup takes half the input panels). Each tile's
//    product starts from zero and is added to a float32 register sum, so no
//    accumulation runs longer than one tile's 64 rows inside the tensor
//    cores. The run split depends on (B, L, d) only, so kernel A4' gives
//    A''s bits.
//  * Pass 3: the fixed-order sums of the runs' dW and parameter partials.
#pragma once

#include "bf16_io.cuh"
#include "fused_front_tc.cuh"

// FRONT_NS, defined by the including source, names the kernels for profiles.
namespace FRONT_NS {

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

__global__ void __launch_bounds__(kThreads) front_bwd_tile_kernel(
    const float* __restrict__ u, const float* __restrict__ w, const float* __restrict__ bp,
    const float* __restrict__ wc, const float* __restrict__ bc, const float* __restrict__ dvx,
    const float* __restrict__ dx0, float* __restrict__ dproj, float* __restrict__ part, int L,
    int ld, int di, int dc) {
  extern __shared__ float smem[];
  auto us = reinterpret_cast<float(*)[kRows + 1]>(smem);
  auto ws = reinterpret_cast<float(*)[kCols]>(smem + kUsSize);
  auto ps = reinterpret_cast<float(*)[kStride]>(smem + kUsSize + kWsSize);
  auto dg = reinterpret_cast<float(*)[kStride]>(smem + kUsSize + kWsSize + kRows * kStride);

  const int c0 = blockIdx.x * kCB;
  const int tile = blockIdx.y;
  const int t0 = tile * kOut;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int d3 = 3 * dc;
  const int trow0 = t0 - 2;  // time of projected row 0
  const float* ub = u + static_cast<int64_t>(b) * L * di;

  // projection of rows t0-2 .. t0+61, columns [x0 | x1 | v] of channels c0..c0+31
  float acc[4][6];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[r][j] = 0.f;
  for (int k0 = 0; k0 < di; k0 += kTK) {
    for (int i = tid; i < kRows * kTK; i += kThreads) {
      const int r = i / kTK, kk = i % kTK;
      const int t = trow0 + r;
      us[kk][r] = (t >= 0 && t < L && k0 + kk < di)
                      ? ub[static_cast<int64_t>(t) * di + k0 + kk]
                      : 0.f;
    }
    for (int i = tid; i < kTK * kCols; i += kThreads) {
      const int kk = i / kCols, j = i % kCols;
      const int ch = c0 + j % kCB;
      ws[kk][j] = (k0 + kk < di && ch < dc)
                      ? w[static_cast<int64_t>(k0 + kk) * d3 + (j / kCB) * dc + ch]
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
      ps[row][col] = (live && ch < dc) ? acc[r][j] + bp[(col / kCB) * dc + ch] : 0.f;
    }
  }
  __syncthreads();

  // dconv at t0 .. t0+61 (zero past L)
  for (int i = tid; i < kCB * kConvRows; i += kThreads) {
    const int c = i / kConvRows, rr = i % kConvRows;
    const int t = t0 + rr;
    const int ch = c0 + c;
    float g0 = 0.f, g1 = 0.f, g2 = 0.f;
    if (t < L && ch < dc) {
      float x[2];
#pragma unroll
      for (int grp = 1; grp < 3; ++grp) {
        const int col = grp * kCB + c;
        const int gc = grp * dc + ch;
        x[grp - 1] = ps[rr][col] * wc[gc] + ps[rr + 1][col] * wc[d3 + gc] +
                     ps[rr + 2][col] * wc[2 * d3 + gc] + bc[gc];
      }
      const int64_t o = (static_cast<int64_t>(b) * dc + ch) * ld + t;
      const float gvx = dvx[o];
      g0 = dx0[o];
      g1 = gvx * x[1];  // d x1 = dvx * v
      g2 = gvx * x[0];  // d v  = dvx * x1
    }
    dg[rr][c] = g0;
    dg[rr][kCB + c] = g1;
    dg[rr][2 * kCB + c] = g2;
  }
  __syncthreads();

  // dproj at t0 .. t0+59: the transposed conv
  for (int i = tid; i < kOut * kCols; i += kThreads) {
    const int rr = i / kCols, col = i % kCols;
    const int s = t0 + rr;
    const int ch = c0 + col % kCB;
    if (s >= L || ch >= dc) continue;
    const int gc = (col / kCB) * dc + ch;
    dproj[(static_cast<int64_t>(b) * L + s) * d3 + gc] =
        wc[gc] * dg[rr + 2][col] + wc[d3 + gc] * dg[rr + 1][col] + wc[2 * d3 + gc] * dg[rr][col];
  }

  // per-tile partial sums over the 60 owned times
  if (tid < kCols) {
    const int col = tid;
    const int ch = c0 + col % kCB;
    if (ch < dc) {
      const int gc = (col / kCB) * dc + ch;
      const float w0 = wc[gc], w1 = wc[d3 + gc], w2 = wc[2 * d3 + gc];
      float sbp = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f, sbc = 0.f;
      for (int rr = 0; rr < kOut; ++rr) {
        const float g = dg[rr][col];
        sbp += w0 * dg[rr + 2][col] + w1 * dg[rr + 1][col] + w2 * g;
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
// B[k * ldb + n] with kBNContig, else B[n * ldb + k]. All float32.
template <bool kAMContig, bool kBNContig>
__global__ void __launch_bounds__(kThreads) front_bwd_gemm_kernel(
    const float* __restrict__ A, int64_t lda, const float* __restrict__ Bm, int64_t ldb,
    float* __restrict__ C, int64_t ldc, int64_t c_slice, int M, int N, int K, int k_chunk) {
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
        v = kAMContig ? A[static_cast<int64_t>(gk) * lda + gm]
                      : A[static_cast<int64_t>(gm) * lda + gk];
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
  float* out = C + blockIdx.z * c_slice;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int gm = m0 + ty + 16 * r;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[static_cast<int64_t>(gm) * ldc + gn] = acc[r][j];
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

// float32 du, dw, dparams from float32 u, dvx, dx0 on the CUDA cores, through
// the dproj scratch; ld == L for kernel A'.
inline int launch(const float* u, const float* w, const float* bp, const float* wc,
                  const float* bc, const float* dvx, const float* dx0, float* du, float* dw,
                  float* dparams, float* dproj, float* part, float* dwpart, int B, int L,
                  int ld, int di, int dc, int tiles, int slices, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * L;
  if (B < 1 || L < 1 || di < 1 || dc < 1 || ld < L || B > 65535 ||
      tiles != (L + kOut - 1) / kOut ||
      tiles > 65535 || slices < 1 || slices > 65535 || (rows + kGM - 1) / kGM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int d3 = 3 * dc;
  const int M = static_cast<int>(rows);
  cudaFuncSetAttribute(front_bwd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(kTileSmem));
  front_bwd_tile_kernel<<<dim3((dc + kCB - 1) / kCB, tiles, B), kThreads, kTileSmem, stream>>>(
      u, w, bp, wc, bc, dvx, dx0, dproj, part, L, ld, di, dc);
  // du = dproj @ W^T: A = dproj (M, 3 dc), B(k, n) = W[n, k], W (di, 3 dc)
  front_bwd_gemm_kernel<false, false>
      <<<dim3((di + kGN - 1) / kGN, (M + kGM - 1) / kGM, 1), kThreads, 0, stream>>>(
          dproj, d3, w, d3, du, di, 0, M, di, d3, d3);
  // dW slices = u^T @ dproj over runs of rows: A(m, k) = u[k, m], B = dproj (M, 3 dc)
  const int k_chunk = static_cast<int>((rows + slices - 1) / slices);
  front_bwd_gemm_kernel<true, true>
      <<<dim3((d3 + kGN - 1) / kGN, (di + kGM - 1) / kGM, slices), kThreads, 0, stream>>>(
          u, di, dproj, d3, dwpart, d3, static_cast<int64_t>(di) * d3, di, d3, M, k_chunk);
  front_bwd_sum_kernel<<<(di * d3 + 31) / 32, kThreads, 0, stream>>>(dwpart, slices, di * d3,
                                                                      dw);
  front_bwd_sum_kernel<<<(kParts * d3 + 31) / 32, kThreads, 0, stream>>>(part, B * tiles,
                                                                         kParts * d3, dparams);
  return static_cast<int>(cudaGetLastError());
}


namespace tc {

constexpr int kDuRows = 128;                 // projected rows per A'1 tile
constexpr int kDuOut = 120;                  // du rows (times) per A'1 tile
constexpr int kDuPs = 34;                    // ps row stride: x1 | v columns
constexpr int kDuCot = 128;                  // cotangent times loaded per A'1 tile
constexpr int kDuCotStride = kDuCot + 8;
constexpr int kUPanelDu = kDuRows * wgmma::kRowBytes;
constexpr int kDwRows = 64;                  // projected rows per A'2 tile
constexpr int kDwOut = 60;                   // dproj rows (times) per A'2 tile
constexpr int kDwPs = 52;                    // ps row stride: x0 | x1 | v
constexpr int kDwCot = 72;                   // cotangent times loaded per A'2 tile
constexpr int kDwCotStride = kDwCot + 8;
constexpr int kDwCotBuf = 2 * kC * kDwCotStride;  // bf16 values of one tile's cotangents
constexpr int kUPanelDw = kDwRows * wgmma::kRowBytes;
constexpr int kParts = 5;                    // dbp, dwc[0], dwc[1], dwc[2], dbc

__host__ __device__ inline int du_smem_bytes(int di, int dc) {
  const Dims D(di, dc);
  return 1024 + D.Pm * kUPanelDu + 2 * D.w_bytes() + 2 * kUPanelDu + kDuRows * kDuPs * 4 +
         2 * kC * kDuCotStride * 2;
}
__host__ __device__ inline int dw_smem_bytes(int di, int dc) {
  const Dims D(di, dc);
  return 1024 + 2 * D.Pm * kUPanelDw + D.w_bytes() + 2 * kUPanelDw + kDwRows * kDwPs * 4 +
         2 * kDwCotBuf * 2;
}

template <int kP>
__global__ void __launch_bounds__(kThreads, 1) front_bwd_du_kernel(
    const bf16* __restrict__ u, const bf16* __restrict__ ws, const float* __restrict__ bp,
    const float* __restrict__ wc, const float* __restrict__ bc, const bf16* __restrict__ dvx,
    const bf16* __restrict__ dx0, bf16* __restrict__ du, int L, int ld, int di, int dc) {
  extern __shared__ uint8_t smem_raw[];
  const Dims D(di, dc);
  constexpr int kWBytes = 2 * kP * kWPanelBytes;
  const int t0 = blockIdx.x * kDuOut, nc = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128, tw = tid % 128;
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t U = wgmma::smem_u32(sm);
  const uint32_t W0 = U + kP * kUPanelDu;  // W buffer i at W0 + i * kWBytes
  uint8_t* dp_hi = sm + kP * kUPanelDu + 2 * kWBytes;
  uint8_t* dp_lo = dp_hi + kUPanelDu;
  float* ps = reinterpret_cast<float*>(dp_lo + kUPanelDu);
  bf16* cs = reinterpret_cast<bf16*>(ps + kDuRows * kDuPs);
  const bool vec_u = di % 8 == 0, vec_c = ld % 8 == 0;
  const int nsteps = D.G * D.nchunk;
  // input chunks in the order nc + 1, ..., nc: the last one's W panels are du's B
  auto chunk_of = [&](int s) { return (nc + 1 + s % D.nchunk) % D.nchunk; };

  zero_smem(dp_hi, 2 * kUPanelDu);  // rows past the 120 owned stay zero
  if (D.nchunk == 1) load_u(U, u, b, t0 - 2, kDuRows, L, di, 0, kP, vec_u);
  load_w<kP>(W0, ws, D, 0, chunk_of(0));
  cp_commit();

  float acc[kP][32];
#pragma unroll
  for (int q = 0; q < kP; ++q) wgmma::zero(acc[q]);
  float pj[16];
  float no_sums[15];  // dproj_item's partial sums, which A'1 does not take
  for (int g = 0; g < D.G; ++g) {
    wgmma::zero(pj);
    for (int sub = 0; sub < D.nchunk; ++sub) {
      const int s = g * D.nchunk + sub, ic = chunk_of(s);
      __syncthreads();  // the last step's products and dproj pass are done with U, W, cs
      if (D.nchunk > 1) {
        load_u(U, u, b, t0 - 2, kDuRows, L, di, kChunk * ic, kP, vec_u);
        cp_commit();
      }
      const bool more = s + 1 < nsteps;
      if (more) {
        load_w<kP>(W0 + ((s + 1) & 1) * kWBytes, ws, D, (s + 1) / D.nchunk, chunk_of(s + 1));
        cp_commit();
      }
      if (sub == 0) {  // this group's cotangents, waited for after the projection
        load_cot(cs, kDuCotStride, dvx, dx0, b, g, t0, kDuCot, L, ld, dc, vec_c);
        cp_commit();
      }
      if (sub == 0 && more) cp_wait<2>();
      else if (sub == 0 || more) cp_wait<1>();
      else cp_wait<0>();
      wgmma::fence_proxy_async();
      __syncthreads();
      wgmma::fence_operand(pj);
      wgmma::fence();
      proj_mma<32, kP>(pj, U, kUPanelDu, 64 * wg, W0 + (s & 1) * kWBytes, kC);
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::fence_operand(pj);
    }
    const uint32_t wb = W0 + ((g * D.nchunk + D.nchunk - 1) & 1) * kWBytes;  // chunk nc's W

    store_ps<32>(ps, kDuPs, pj, tw, 64 * wg, 0, kC, bp, g, dc, t0 - 2, L);
    cp_wait<0>();
    __syncthreads();
    {
      const int c = tid % kC, k = tid / kC;
      if (k < kDuOut / 8 && kC * g + c < dc)
        dproj_item<8, false>(ps, kDuPs, 0, cs + c * kDuCotStride, cs + (kC + c) * kDuCotStride,
                             8 * k, wc, bc, dc, g, c, dp_hi, dp_lo, 0, no_sums);
    }
    wgmma::fence_proxy_async();
    __syncthreads();
    const uint32_t hi = wgmma::smem_u32(dp_hi) + 64 * wg * wgmma::kRowBytes;
    const uint32_t lo = wgmma::smem_u32(dp_lo) + 64 * wg * wgmma::kRowBytes;
#pragma unroll
    for (int q = 0; q < kP; ++q) wgmma::fence_operand(acc[q]);
    wgmma::fence();
#pragma unroll
    for (int q = 0; q < kP; ++q) {
#pragma unroll
      for (int kk = 0; kk < 3; ++kk) {
        const uint64_t ah = wgmma::desc_k(hi + 32 * kk), al = wgmma::desc_k(lo + 32 * kk);
        const uint32_t bq = wb + q * kWPanelBytes + kk * 2 * wgmma::kGroupBytes;
        const uint64_t bh = wgmma::desc_mn(bq), bl = wgmma::desc_mn(bq + kP * kWPanelBytes);
        wgmma::Mma<64, 0, 1>::run(acc[q], ah, bh);
        wgmma::Mma<64, 0, 1>::run(acc[q], al, bh);
        wgmma::Mma<64, 0, 1>::run(acc[q], ah, bl);
      }
    }
    wgmma::commit();
    wgmma::wait<0>();
#pragma unroll
    for (int q = 0; q < kP; ++q) wgmma::fence_operand(acc[q]);
  }

  // du rows t0 .. t0 + 119 (time-major), inputs 256 nc + 64 q + column
#pragma unroll
  for (int q = 0; q < kP; ++q) {
#pragma unroll
    for (int k = 0; k < 32; k += 2) {
      const int row = 64 * wg + wgmma::frag_row(tw, k);
      const int t = t0 + row;
      const int i = kChunk * nc + 64 * q + wgmma::frag_col(tw, k);
      if (row >= kDuOut || t >= L || i >= di) continue;
      bf16* o = du + (static_cast<int64_t>(b) * L + t) * di + i;
      if (di % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(acc[q][k], acc[q][k + 1]);
      } else {
        o[0] = __float2bfloat16_rn(acc[q][k]);
        if (i + 1 < di) o[1] = __float2bfloat16_rn(acc[q][k + 1]);
      }
    }
  }
}

template <int kP>
__global__ void __launch_bounds__(kThreads, 1) front_bwd_dw_kernel(
    const bf16* __restrict__ u, const bf16* __restrict__ ws, const float* __restrict__ bp,
    const float* __restrict__ wc, const float* __restrict__ bc, const bf16* __restrict__ dvx,
    const bf16* __restrict__ dx0, float* __restrict__ part, float* __restrict__ dwpart, int L,
    int ld, int di, int dc, int n_tiles, int tiles_per_run) {
  extern __shared__ uint8_t smem_raw[];
  const Dims D(di, dc);
  constexpr int kUBytes = kP * kUPanelDw;
  // warpgroup wg takes kM0 (wg 0) or kM1 (wg 1) dW input panels from wg * kM0
  constexpr int kM0 = (kP + 1) / 2, kM1 = kP / 2;
  const int g = blockIdx.x, mc = blockIdx.y, run = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128, tw = tid % 128;
  const int tiles = (L + kDwOut - 1) / kDwOut;  // per batch row
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t U0 = wgmma::smem_u32(sm);  // u buffer i at U0 + i * kUBytes
  const uint32_t W = U0 + 2 * kUBytes;
  uint8_t* dp_hi = sm + 2 * kUBytes + 2 * kP * kWPanelBytes;
  uint8_t* dp_lo = dp_hi + kUPanelDw;
  float* ps = reinterpret_cast<float*>(dp_lo + kUPanelDw);
  bf16* cs0 = reinterpret_cast<bf16*>(ps + kDwRows * kDwPs);  // buffer i at cs0 + i * kDwCotBuf
  const bool vec_u = di % 8 == 0, vec_c = ld % 8 == 0;
  const bool resident = D.nchunk == 1;
  auto chunk_of = [&](int sub) { return (mc + 1 + sub) % D.nchunk; };
  const int q0 = run * tiles_per_run;
  const int q_end = min(n_tiles, q0 + tiles_per_run);  // the last run may be short

  // tile q -> (batch row, first owned time); the u rows start 2 before it
  auto tile_b = [&](int q) { return q / tiles; };
  auto tile_t0 = [&](int q) { return (q % tiles) * kDwOut; };
  auto load_tile = [&](int q, int buf, int ic) {
    const int t0 = tile_t0(q);
    load_cot(cs0 + buf * kDwCotBuf, kDwCotStride, dvx, dx0, tile_b(q), g, t0 & ~7, kDwCot, L, ld,
             dc, vec_c);
    load_u(U0 + buf * kUBytes, u, tile_b(q), t0 - 2, kDwRows, L, di, kChunk * ic, kP, vec_u);
  };

  zero_smem(dp_hi, 2 * kUPanelDw);  // rows 0, 1, 62, 63 (times not owned) stay zero
  if (resident) {
    load_w<kP>(W, ws, D, g, 0);
    load_tile(q0, 0, 0);
    cp_commit();
  }
  float sums[15] = {};
  float dw[2][24] = {};
  float pj[12];
  float acc[2][24];
  const int c = tid % kC, k = tid / kC;
  const bool item = k < kDwOut / 4 && kC * g + c < dc;
  for (int q = q0; q < q_end; ++q) {
    const int n = q - q0, buf = resident ? n & 1 : 0;
    const int t0 = tile_t0(q);
    const uint32_t ub = U0 + buf * kUBytes;
    const bf16* cs = cs0 + buf * kDwCotBuf;
    wgmma::zero(pj);
    for (int sub = 0; sub < D.nchunk; ++sub) {
      __syncthreads();  // the last tile's products and dproj pass are done with its buffers
      if (!resident) {
        load_w<kP>(W, ws, D, g, chunk_of(sub));
        load_tile(q, 0, chunk_of(sub));
        cp_commit();
        cp_wait<0>();
      } else if (q + 1 < q_end) {
        load_tile(q + 1, buf ^ 1, 0);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      wgmma::fence_proxy_async();
      __syncthreads();
      wgmma::fence_operand(pj);
      wgmma::fence();
      proj_mma<24, kP>(pj, ub, kUPanelDw, 0, W, 24 * wg);
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::fence_operand(pj);
    }
    store_ps<24>(ps, kDwPs, pj, tw, 0, 24 * wg, 0, bp, g, dc, t0 - 2, L);
    __syncthreads();
    if (item) {
      const int o = t0 - (t0 & ~7);  // local row 0 in the cotangent rows
      // dproj row r is time t0 - 2 + r, as u row r: the rows dW pairs
      dproj_item<4, true>(ps, kDwPs, kC, cs + c * kDwCotStride + o,
                          cs + (kC + c) * kDwCotStride + o, 4 * k, wc, bc, dc, g, c, dp_hi, dp_lo,
                          2, sums);
    }
    wgmma::fence_proxy_async();
    __syncthreads();
    // dW_group += u_tile^T dproj, from zero each tile: the tensor cores never
    // sum more than one tile's 64 rows; the running sum is float32 registers
    wgmma::zero(acc[0]);
    wgmma::zero(acc[1]);
    wgmma::fence_operand(acc[0]);
    wgmma::fence_operand(acc[1]);
    wgmma::fence();
    const uint32_t dh = wgmma::smem_u32(dp_hi), dl = wgmma::smem_u32(dp_lo);
    auto dw_mma = [&](float(&a_m)[24], int panel) {
#pragma unroll
      for (int kk = 0; kk < kDwRows / 16; ++kk) {
        const uint32_t off = kk * 2 * wgmma::kGroupBytes;
        const uint64_t a = wgmma::desc_mn(ub + panel * kUPanelDw + off);
        wgmma::Mma<48, 1, 1>::run(a_m, a, wgmma::desc_mn(dh + off));
        wgmma::Mma<48, 1, 1>::run(a_m, a, wgmma::desc_mn(dl + off));
      }
    };
    if constexpr (kM0 == kM1) {  // both warpgroups alike: no branch around the products
#pragma unroll
      for (int m = 0; m < kM0; ++m) dw_mma(acc[m], kM0 * wg + m);
    } else if (wg == 0) {
#pragma unroll
      for (int m = 0; m < kM0; ++m) dw_mma(acc[m], m);
    } else {
#pragma unroll
      for (int m = 0; m < kM1; ++m) dw_mma(acc[m], kM0 + m);
    }
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(acc[0]);
    wgmma::fence_operand(acc[1]);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 24; ++e) dw[m][e] += acc[m][e];
  }

  // this run's dW rows (inputs) 256 mc + 64 panel + row, columns of group g
  const int d3 = 3 * dc;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int panel = kM0 * wg + m;
    if (m >= (wg == 0 ? kM0 : kM1)) break;
#pragma unroll
    for (int e = 0; e < 24; ++e) {
      const int i = kChunk * mc + 64 * panel + wgmma::frag_row(tw, e);
      const int j = wgmma::frag_col(tw, e);
      const int ch = kC * g + j % kC;
      if (i < di && ch < dc)
        dwpart[(static_cast<int64_t>(run) * di + i) * d3 + (j / kC) * dc + ch] = dw[m][e];
    }
  }
  if (mc != 0) return;
  // this run's dbp, dwc, dbc of group g: the items' sums, in order of k
  __syncthreads();
  float* red = reinterpret_cast<float*>(sm);  // over the u buffers, now idle
  if (item) {
#pragma unroll
    for (int e = 0; e < 15; ++e) red[tid * 15 + e] = sums[e];
  }
  __syncthreads();
  if (tid < kParts * kJ) {
    const int quantity = tid / kJ, j = tid % kJ;
    const int p = j / kC, cc = j % kC, ch = kC * g + cc;
    if (ch < dc) {
      float t = 0.f;
      for (int kq = 0; kq < kDwOut / 4; ++kq) t += red[(kq * kC + cc) * 15 + 3 * quantity + p];
      part[(static_cast<int64_t>(run) * kParts + quantity) * d3 + p * dc + ch] = t;
    }
  }
}

}  // namespace tc

constexpr int kDwBlocks = 528;  // A'2 blocks aimed at: 4 per SM of an H100

// The A'2 pass's number of runs of 60-time tiles at (B, L, di, dc): about
// kDwBlocks blocks in all (channel groups x input chunks x runs), none
// empty. It depends on B, L, di and dc alone, never on ld, so A4' gives A''s
// bits. -1 for a size below 1.
inline int bwd_runs(int B, int L, int di, int dc) {
  if (B < 1 || L < 1 || di < 1 || dc < 1) return -1;
  const tc::Dims D(di, dc);
  const int64_t tiles = static_cast<int64_t>(B) * ((L + tc::kDwOut - 1) / tc::kDwOut);
  const int blocks = D.G * D.nchunk;
  int64_t runs = (kDwBlocks + blocks - 1) / blocks;
  if (runs > tiles) runs = tiles;
  if (runs < 1) runs = 1;
  const int64_t per_run = (tiles + runs - 1) / runs;
  return static_cast<int>((tiles + per_run - 1) / per_run);
}

// The 60-time tiles of each of the A'2 pass's `runs` runs (the last may be
// shorter).
inline int bwd_tiles_per_run(int B, int L, int runs) {
  const int n = B * ((L + tc::kDwOut - 1) / tc::kDwOut);
  return (n + runs - 1) / runs;
}

// bf16 du (B, L, di), dw (di, 3 dc), dparams (5, 3 dc) from bf16 u, dvx, dx0
// on the tensor cores. Scratch: ws (tc::ws_numel(di, dc) bf16), part (runs *
// 5 * 3 dc), dwpart (runs * di * 3 dc), runs = bwd_runs(B, L, di, dc). ld ==
// L for kernel A'.
inline int launch_bf16(const __nv_bfloat16* u, const float* w, const float* bp, const float* wc,
                       const float* bc, const __nv_bfloat16* dvx, const __nv_bfloat16* dx0,
                       __nv_bfloat16* du, float* dw, float* dparams, __nv_bfloat16* ws,
                       float* part, float* dwpart, int B, int L, int ld, int di, int dc, int runs,
                       cudaStream_t stream) {
  const tc::Dims D(di, dc);
  const int64_t n_tiles = static_cast<int64_t>(B) * ((L + tc::kDwOut - 1) / tc::kDwOut);
  if (B < 1 || L < 1 || di < 1 || dc < 1 || ld < L || B > 65535 || n_tiles > (1ll << 30) ||
      (L + tc::kDuOut - 1) / tc::kDuOut > 65535 || D.G > 65535 ||
      runs != bwd_runs(B, L, di, dc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_run = bwd_tiles_per_run(B, L, runs);
  int rc = tc::split_w(w, ws, di, dc, stream);
  if (rc != 0) return rc;
  rc = tc::with_panels(di, [&](auto kp) {
    constexpr int kP = decltype(kp)::value;
    const auto du_kernel = tc::front_bwd_du_kernel<kP>;
    const auto dw_kernel = tc::front_bwd_dw_kernel<kP>;
    const int smem_du = tc::du_smem_bytes(di, dc), smem_dw = tc::dw_smem_bytes(di, dc);
    int err = static_cast<int>(
        cudaFuncSetAttribute(du_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_du));
    if (err == 0)
      err = static_cast<int>(
          cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dw));
    if (err != 0) return err;
    du_kernel<<<dim3((L + tc::kDuOut - 1) / tc::kDuOut, D.nchunk, B), tc::kThreads, smem_du,
                stream>>>(u, ws, bp, wc, bc, dvx, dx0, du, L, ld, di, dc);
    dw_kernel<<<dim3(D.G, D.nchunk, runs), tc::kThreads, smem_dw, stream>>>(
        u, ws, bp, wc, bc, dvx, dx0, part, dwpart, L, ld, di, dc, static_cast<int>(n_tiles),
        per_run);
    return static_cast<int>(cudaGetLastError());
  });
  if (rc != 0) return rc;
  const int d3 = 3 * dc;
  front_bwd_sum_kernel<<<(di * d3 + 31) / 32, kThreads, 0, stream>>>(dwpart, runs, di * d3, dw);
  front_bwd_sum_kernel<<<(tc::kParts * d3 + 31) / 32, kThreads, 0, stream>>>(
      part, runs, tc::kParts * d3, dparams);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace FRONT_NS
