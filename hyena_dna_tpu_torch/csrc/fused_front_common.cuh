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
//   vx = v * x1, x0                                     both (B, dc, ld)
//
// u (B, L, di), vx and x0 are float32, or all three bfloat16; W (di, 3 dc),
// bp (3 dc), wc (3, 3 dc) with wc[j] multiplying proj[t - 2 + j] and bc
// (3 dc) are float32. The arithmetic is float32 either way: proj stays
// float32 and bf16 vx, x0 are rounded once. di is u's width, dc the width
// of one output chunk: the whole model runs di == dc (d); a tensor-parallel
// rank runs di = d and dc = d / M, its channel slice of each chunk.
//
// float32 u, fused_front_kernel (CUDA cores):
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
//
// bfloat16 u, front_fwd_tc_kernel (tensor cores, fused_front_tc.cuh):
//  * W is split once per call into bf16 hi / lo panels (split_w_kernel);
//    proj = u W_hi + u W_lo on wgmma, accumulated in float32 registers.
//  * One block (two warpgroups) per (120-time tile, batch row): the 128 u
//    rows t0 - 2 .. t0 + 125 are read once into shared memory (cp.async)
//    and stay there while the block loops over the dc / 16 channel groups.
//    Each group's W panels (48 KB at di = 256, from L2) are double-buffered:
//    the next group's load overlaps this group's products and epilogue.
//  * Each warpgroup projects 64 rows x the group's 48 columns (m64n48k16,
//    two products per K step) into registers, then the block writes the
//    tile to shared memory (+ bp), and each thread takes 8 consecutive
//    times of one channel through the conv and gate and stores them as one
//    16-byte vector along t (tiles start at multiples of 8 times; scalar
//    stores where ld % 8 != 0).
//  * The 2-row halo is recomputed per tile, so blocks run in any order; a
//    tile at or past L only stores zeros.
#pragma once

#include "bf16_io.cuh"
#include "fused_front_tc.cuh"

// FRONT_NS, defined by the including source, names the kernel for profiles.
namespace FRONT_NS {

constexpr int kRows = 64;           // projected rows per block
constexpr int kOut = kRows - 2;     // output times per block
constexpr int kCB = 32;             // output channels per block
constexpr int kCols = 3 * kCB;      // projected columns per block
constexpr int kTK = 32;             // reduction chunk
constexpr int kThreads = 256;       // 16 x 16; thread owns 4 rows x 6 columns

__global__ void __launch_bounds__(kThreads) fused_front_kernel(
    const float* __restrict__ u, const float* __restrict__ w, const float* __restrict__ bp,
    const float* __restrict__ wc, const float* __restrict__ bc, float* __restrict__ vx,
    float* __restrict__ x0, int L, int ld, int di, int dc) {
  __shared__ float us[kTK][kRows + 1];
  __shared__ float ws[kTK][kCols];
  __shared__ float ps[kRows][kCols + 1];

  const int c0 = blockIdx.x * kCB;
  const int t0 = blockIdx.y * kOut;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int d3 = 3 * dc;
  const int trow0 = t0 - 2;  // time of projected row 0
  const float* ub = u + static_cast<int64_t>(b) * L * di;

  if (t0 >= L) {  // wholly in the zero tail (the whole block takes this branch)
    for (int i = tid; i < kCB * kOut; i += kThreads) {
      const int c = i / kOut, t = t0 + i % kOut;
      const int ch = c0 + c;
      if (t >= ld || ch >= dc) continue;
      const int64_t o = (static_cast<int64_t>(b) * dc + ch) * ld + t;
      x0[o] = 0.f;
      vx[o] = 0.f;
    }
    return;
  }

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
    const bool live = trow0 + row >= 0;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int col = tx + 16 * j;
      const int ch = c0 + col % kCB;
      ps[row][col] = (live && ch < dc) ? acc[r][j] + bp[(col / kCB) * dc + ch] : 0.f;
    }
  }
  __syncthreads();

  for (int i = tid; i < kCB * kOut; i += kThreads) {
    const int c = i / kOut, rr = i % kOut;
    const int t = t0 + rr;
    const int ch = c0 + c;
    if (t >= ld || ch >= dc) continue;
    const int64_t o = (static_cast<int64_t>(b) * dc + ch) * ld + t;
    if (t >= L) {  // the zero tail of a tile that straddles L
      x0[o] = 0.f;
      vx[o] = 0.f;
      continue;
    }
    const int r = rr + 2;  // row of time t
    float g[3];
#pragma unroll
    for (int grp = 0; grp < 3; ++grp) {
      const int col = grp * kCB + c;
      const int gc = grp * dc + ch;
      g[grp] = ps[r - 2][col] * wc[gc] + ps[r - 1][col] * wc[d3 + gc] +
               ps[r][col] * wc[2 * d3 + gc] + bc[gc];
    }
    x0[o] = g[0];
    vx[o] = g[2] * g[1];
  }
}

// float32 vx, x0 (B, dc, ld) from float32 u (B, L, di) on the CUDA cores; ld
// == L for kernel A.
inline int launch(const float* u, const float* w, const float* bp, const float* wc,
                  const float* bc, float* vx, float* x0, int B, int L, int ld, int di, int dc,
                  cudaStream_t stream) {
  const int tiles = (ld + kOut - 1) / kOut;
  if (B < 1 || L < 1 || di < 1 || dc < 1 || ld < L || tiles > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((dc + kCB - 1) / kCB, tiles, B);
  fused_front_kernel<<<grid, kThreads, 0, stream>>>(u, w, bp, wc, bc, vx, x0, L, ld, di, dc);
  return static_cast<int>(cudaGetLastError());
}


namespace tc {

constexpr int kFwdRows = 128;                 // projected rows per tile
constexpr int kFwdOut = 120;                  // output times per tile (multiple of 8)
constexpr int kFwdPs = 50;                    // floats per ps row (conflict-free reads)
constexpr int kUPanelFwd = kFwdRows * wgmma::kRowBytes;

__host__ __device__ inline int fwd_smem_bytes(int di, int dc) {
  const Dims D(di, dc);
  return 1024 + D.Pm * kUPanelFwd + 2 * D.w_bytes() + kFwdRows * kFwdPs * 4;
}

// Stores 8 times t .. t + 7 of one (batch, channel) row at o; vec: ld % 8
// == 0 (o is then 16-byte aligned); times at or past ld are not stored.
__device__ __forceinline__ void store8(bf16* out, int64_t o, int t, int ld, bool vec,
                                       const float (&v)[8]) {
  if (vec && t + 8 <= ld) {
    bf16_io::store_vec<8>(out + o, v);
  } else {
#pragma unroll
    for (int m = 0; m < 8; ++m)
      if (t + m < ld) out[o + m] = __float2bfloat16_rn(v[m]);
  }
}

template <int kP>
__global__ void __launch_bounds__(kThreads, 1) front_fwd_tc_kernel(
    const bf16* __restrict__ u, const bf16* __restrict__ ws, const float* __restrict__ bp,
    const float* __restrict__ wc, const float* __restrict__ bc, bf16* __restrict__ vx,
    bf16* __restrict__ x0, int L, int ld, int di, int dc) {
  extern __shared__ uint8_t smem_raw[];
  const Dims D(di, dc);
  constexpr int kWBytes = 2 * kP * kWPanelBytes;
  const int t0 = blockIdx.x * kFwdOut, b = blockIdx.y;
  const int tid = threadIdx.x, wg = tid / 128, tw = tid % 128;
  const bool vec_out = ld % 8 == 0;

  if (t0 >= L) {  // wholly in the zero tail (the whole block takes this branch)
    const float zeros[8] = {};
    for (int q = tid; q < dc * (kFwdOut / 8); q += kThreads) {
      const int ch = q / (kFwdOut / 8), t = t0 + 8 * (q % (kFwdOut / 8));
      if (t >= ld) continue;
      const int64_t o = (static_cast<int64_t>(b) * dc + ch) * ld + t;
      store8(x0, o, t, ld, vec_out, zeros);
      store8(vx, o, t, ld, vec_out, zeros);
    }
    return;
  }

  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t U = wgmma::smem_u32(sm);
  const uint32_t W0 = U + kP * kUPanelFwd;  // W buffer i at W0 + i * kWBytes
  float* ps = reinterpret_cast<float*>(sm + kP * kUPanelFwd + 2 * kWBytes);
  const bool vec_u = di % 8 == 0;
  const int nsteps = D.G * D.nchunk;  // (group, input chunk) steps, W double-buffered

  if (D.nchunk == 1) load_u(U, u, b, t0 - 2, kFwdRows, L, di, 0, kP, vec_u);
  load_w<kP>(W0, ws, D, 0, 0);
  cp_commit();
  float acc[24];
  for (int g = 0; g < D.G; ++g) {
    wgmma::zero(acc);
    for (int ic = 0; ic < D.nchunk; ++ic) {
      const int s = g * D.nchunk + ic;
      __syncthreads();  // the last step's products and epilogue are done with U, W, ps
      if (D.nchunk > 1) {
        load_u(U, u, b, t0 - 2, kFwdRows, L, di, kChunk * ic, kP, vec_u);
        cp_commit();
      }
      if (s + 1 < nsteps) {
        load_w<kP>(W0 + ((s + 1) & 1) * kWBytes, ws, D, (s + 1) / D.nchunk, (s + 1) % D.nchunk);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      wgmma::fence_proxy_async();
      __syncthreads();
      wgmma::fence_operand(acc);
      wgmma::fence();
      proj_mma<48, kP>(acc, U, kUPanelFwd, 64 * wg, W0 + (s & 1) * kWBytes, 0);
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::fence_operand(acc);
    }

    store_ps<48>(ps, kFwdPs, acc, tw, 64 * wg, 0, 0, bp, g, dc, t0 - 2, L);
    __syncthreads();
    // conv + gate: thread = (8-time chunk k, channel c); ps row tau + 2 is time t0 + tau
    const int c = tid % kC, k = tid / kC, ch = kC * g + c;
    if (k < kFwdOut / 8 && ch < dc) {
      const int d3 = 3 * dc;
      float out0[8], outv[8];
      float cv[3][8];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int gc = p * dc + ch;
        const float w0 = wc[gc], w1 = wc[d3 + gc], w2 = wc[2 * d3 + gc], bb = bc[gc];
        const float* col = ps + p * kC + c;
        float a = col[(8 * k) * kFwdPs], bq = col[(8 * k + 1) * kFwdPs];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float cq = col[(8 * k + m + 2) * kFwdPs];
          cv[p][m] = a * w0 + bq * w1 + cq * w2 + bb;
          a = bq;
          bq = cq;
        }
      }
      const int t = t0 + 8 * k;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const bool live = t + m < L;  // the zero tail of a tile that straddles L
        out0[m] = live ? cv[0][m] : 0.f;
        outv[m] = live ? cv[2][m] * cv[1][m] : 0.f;
      }
      const int64_t o = (static_cast<int64_t>(b) * dc + ch) * ld + t;
      store8(x0, o, t, ld, vec_out, out0);
      store8(vx, o, t, ld, vec_out, outv);
    }
  }
}

}  // namespace tc

// bf16 vx, x0 (B, dc, ld) from bf16 u (B, L, di) on the tensor cores; ws: the
// split-W scratch (tc::ws_numel(di, dc) bf16). ld == L for kernel A.
inline int launch_bf16(const __nv_bfloat16* u, const float* w, const float* bp, const float* wc,
                       const float* bc, __nv_bfloat16* vx, __nv_bfloat16* x0, __nv_bfloat16* ws,
                       int B, int L, int ld, int di, int dc, cudaStream_t stream) {
  const int tiles = (ld + tc::kFwdOut - 1) / tc::kFwdOut;
  if (B < 1 || L < 1 || di < 1 || dc < 1 || ld < L || tiles > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rc = tc::split_w(w, ws, di, dc, stream);
  if (rc != 0) return rc;
  return tc::with_panels(di, [&](auto kp) {
    const auto kernel = tc::front_fwd_tc_kernel<decltype(kp)::value>;
    const int smem = tc::fwd_smem_bytes(di, dc);
    const int err = static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (err != 0) return err;
    kernel<<<dim3(tiles, B), tc::kThreads, smem, stream>>>(u, ws, bp, wc, bc, vx, x0, L, ld, di,
                                                           dc);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace FRONT_NS
