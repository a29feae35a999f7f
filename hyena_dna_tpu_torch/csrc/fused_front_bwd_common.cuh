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
// Both types run the same tensor-core passes (fused_front_tc.cuh: W split
// into bf16 pairs once per call, every product on wgmma as the pair
// products chosen there; float32 u split as its tile is loaded). No dproj
// in device memory: each pass recomputes proj and dconv for its tile from
// u, dvx and dx0. The TPU kernel walked tiles right to left and carried two
// dconv rows across a sequential grid; CUDA blocks run in any order, so each
// tile recomputes its halo: rows before t = 0 are zero (the forward pads
// proj, bias included, with zeros) and dconv past L is zero, so any L works.
//  * A'1, front_bwd_du_kernel: one block (two warpgroups) per (120-time
//    tile, 256-input chunk of du, batch row). The u rows t0-2 .. t0+125 stay
//    in shared memory while the block loops over the dc / 16 channel groups.
//    Per group: project the x1 and v columns (m64n32k16), form dconv and
//    the transposed conv in registers (dproj_item: one thread per channel
//    and 8 times), split dproj into bf16 pairs in shared memory, and add
//    dproj_group W_group^T to du, 128 x 256 float32 in registers (m64n64k16
//    per 64 inputs, three products). du is rounded once (bf16) and stored
//    time-major. bf16 u double-buffers the W panels as kernel A and stages
//    the cotangents in shared memory (223,744 bytes at di = 256); float32
//    u's hi and lo tile takes 64 KB more, so it single-buffers W (the next
//    group's load waits for this group's du products) and reads the
//    cotangents from device memory (231,424 bytes, of 232,448).
//  * A'2, front_bwd_dw_kernel: one block per (channel group, 256-input chunk
//    of dW, fixed run of 60-time tiles). The group's W panels stay in shared
//    memory; the tiles' u rows are double-buffered: bf16 u's next tile
//    (cp.async, with its staged cotangents) loads during this tile's
//    products; float32 u's next tile is read, split and stored while this
//    tile's dW products run on the tensor cores (155,648 and 210,944 bytes
//    at di = 256). Per tile: project the group's 48 columns, form dproj (and
//    the run's dbp, dwc, dbc partials), then dW_group (d x 48) +=
//    u_tile^T dproj (u MN-major as A, dproj as B, two or three products;
//    each warpgroup takes half the input panels). Each tile's product starts
//    from zero and is added to a float32 register sum, so no accumulation
//    runs longer than one tile's 64 rows inside the tensor cores. The run
//    split depends on (B, L, d) only, so kernel A4' gives A''s bits.
//  * front_bwd_sum_kernel: the fixed-order sums of the runs' dW and
//    parameter partials. No atomics, so the result does not vary from run
//    to run.
#pragma once

#include "bf16_io.cuh"
#include "fused_front_tc.cuh"

// FRONT_NS, defined by the including source, names the kernels for profiles.
namespace FRONT_NS {

// out[j] = sum_{q < P} part[q * ncols + j], in a fixed order: 32 columns per
// block, 8 strided runs of q per column, then the 8 runs in order.
__global__ void __launch_bounds__(tc::kThreads) front_bwd_sum_kernel(
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

// bf16 u: W double-buffered, cotangents staged; float32 u: hi and lo u
// panels, W single-buffered, cotangents from device memory (see above)
template <typename T>
__host__ __device__ inline int du_smem_bytes(int di, int dc) {
  const Dims D(di, dc);
  if (kUParts<T> == 2)
    return 1024 + 2 * D.Pm * kUPanelDu + D.w_bytes() + 2 * kUPanelDu + kDuRows * kDuPs * 4;
  return 1024 + D.Pm * kUPanelDu + 2 * D.w_bytes() + 2 * kUPanelDu + kDuRows * kDuPs * 4 +
         2 * kC * kDuCotStride * 2;
}
template <typename T>
__host__ __device__ inline int dw_smem_bytes(int di, int dc) {
  const Dims D(di, dc);
  const int cot = kUParts<T> == 2 ? 0 : 2 * kDwCotBuf * 2;
  return 1024 + 2 * kUParts<T> * D.Pm * kUPanelDw + D.w_bytes() + 2 * kUPanelDw +
         kDwRows * kDwPs * 4 + cot;
}

// du (bf16 pairs, or float32 pairs of values) at o: columns i, i + 1
__device__ __forceinline__ void store_du2(bf16* o, int i, int di, float a, float b) {
  if (di % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
  } else {
    o[0] = __float2bfloat16_rn(a);
    if (i + 1 < di) o[1] = __float2bfloat16_rn(b);
  }
}
__device__ __forceinline__ void store_du2(float* o, int i, int di, float a, float b) {
  if (di % 2 == 0) {
    *reinterpret_cast<float2*>(o) = make_float2(a, b);
  } else {
    o[0] = a;
    if (i + 1 < di) o[1] = b;
  }
}

template <typename T, int kP>
__global__ void __launch_bounds__(kThreads, 1) front_bwd_du_kernel(
    const T* __restrict__ u, const bf16* __restrict__ ws, const float* __restrict__ bp,
    const float* __restrict__ wc, const float* __restrict__ bc, const T* __restrict__ dvx,
    const T* __restrict__ dx0, T* __restrict__ du, int L, int ld, int di, int dc) {
  extern __shared__ uint8_t smem_raw[];
  const Dims D(di, dc);
  constexpr bool kF32 = kUParts<T> == 2;
  constexpr int kWBufs = kF32 ? 1 : 2;
  constexpr int kWBytes = 2 * kP * kWPanelBytes;
  constexpr int kUBytes = kUParts<T> * kP * kUPanelDu;
  const int t0 = blockIdx.x * kDuOut, nc = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128, tw = tid % 128;
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t U = wgmma::smem_u32(sm);
  const uint32_t W0 = U + kUBytes;  // W buffer i at W0 + i * kWBytes
  uint8_t* dp_hi = sm + kUBytes + kWBufs * kWBytes;
  uint8_t* dp_lo = dp_hi + kUPanelDu;
  float* ps = reinterpret_cast<float*>(dp_lo + kUPanelDu);
  bf16* cs = reinterpret_cast<bf16*>(ps + kDuRows * kDuPs);  // bf16 u only
  const bool vec_u = di % 8 == 0, vec_c = ld % 8 == 0;
  const int nsteps = D.G * D.nchunk;
  // input chunks in the order nc + 1, ..., nc: the last one's W panels are du's B
  auto chunk_of = [&](int s) { return (nc + 1 + s % D.nchunk) % D.nchunk; };
  auto w_buf = [&](int s) { return kWBufs == 2 ? W0 + (s & 1) * kWBytes : W0; };

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
      if constexpr (!kF32) {
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
      } else {
        if (s > 0) {  // the one W buffer is free: the last step's products are done
          load_w<kP>(W0, ws, D, g, ic);
          cp_commit();
        }
        cp_wait<0>();
      }
      wgmma::fence_proxy_async();
      __syncthreads();
      wgmma::fence_operand(pj);
      wgmma::fence();
      proj_mma<32, kP, kF32>(pj, U, kUPanelDu, 64 * wg, w_buf(s), kC);
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::fence_operand(pj);
    }
    const uint32_t wb = w_buf(g * D.nchunk + D.nchunk - 1);  // chunk nc's W

    store_ps<32>(ps, kDuPs, pj, tw, 64 * wg, 0, kC, bp, g, dc, t0 - 2, L);
    cp_wait<0>();
    __syncthreads();
    {
      const int c = tid % kC, k = tid / kC, ch = kC * g + c;
      if (k < kDuOut / 8 && ch < dc) {
        if constexpr (kF32) {
          const int64_t row = (static_cast<int64_t>(b) * dc + ch) * ld + t0;
          dproj_item<8, false>(ps, kDuPs, 0, dvx + row, dx0 + row, 8 * k, wc, bc, dc, g, c,
                               dp_hi, dp_lo, 0, no_sums, L - t0);
        } else {
          dproj_item<8, false>(ps, kDuPs, 0, cs + c * kDuCotStride, cs + (kC + c) * kDuCotStride,
                               8 * k, wc, bc, dc, g, c, dp_hi, dp_lo, 0, no_sums);
        }
      }
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
      store_du2(du + (static_cast<int64_t>(b) * L + t) * di + i, i, di, acc[q][k], acc[q][k + 1]);
    }
  }
}

template <typename T, int kP>
__global__ void __launch_bounds__(kThreads, 1) front_bwd_dw_kernel(
    const T* __restrict__ u, const bf16* __restrict__ ws, const float* __restrict__ bp,
    const float* __restrict__ wc, const float* __restrict__ bc, const T* __restrict__ dvx,
    const T* __restrict__ dx0, float* __restrict__ part, float* __restrict__ dwpart, int L,
    int ld, int di, int dc, int n_tiles, int tiles_per_run) {
  extern __shared__ uint8_t smem_raw[];
  const Dims D(di, dc);
  constexpr bool kF32 = kUParts<T> == 2;
  constexpr int kUBytes = kUParts<T> * kP * kUPanelDw;
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
    if constexpr (!kF32)
      load_cot(cs0 + buf * kDwCotBuf, kDwCotStride, dvx, dx0, tile_b(q), g, t0 & ~7, kDwCot, L,
               ld, dc, vec_c);
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
      } else if (!kF32 && q + 1 < q_end) {
        load_tile(q + 1, buf ^ 1, 0);
        cp_commit();
        cp_wait<1>();
      } else {  // float32 u loads the next tile during this tile's dW products
        cp_wait<0>();
      }
      wgmma::fence_proxy_async();
      __syncthreads();
      wgmma::fence_operand(pj);
      wgmma::fence();
      proj_mma<24, kP, kF32>(pj, ub, kUPanelDw, 0, W, 24 * wg);
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::fence_operand(pj);
    }
    store_ps<24>(ps, kDwPs, pj, tw, 0, 24 * wg, 0, bp, g, dc, t0 - 2, L);
    __syncthreads();
    if (item) {
      // dproj row r is time t0 - 2 + r, as u row r: the rows dW pairs
      if constexpr (kF32) {
        const int64_t row = (static_cast<int64_t>(tile_b(q)) * dc + kC * g + c) * ld + t0;
        dproj_item<4, true>(ps, kDwPs, kC, dvx + row, dx0 + row, 4 * k, wc, bc, dc, g, c, dp_hi,
                            dp_lo, 2, sums, L - t0);
      } else {
        const int o = t0 - (t0 & ~7);  // local row 0 in the cotangent rows
        dproj_item<4, true>(ps, kDwPs, kC, cs + c * kDwCotStride + o,
                            cs + (kC + c) * kDwCotStride + o, 4 * k, wc, bc, dc, g, c, dp_hi,
                            dp_lo, 2, sums);
      }
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
        if constexpr (kF32)  // u_lo^T dproj_hi: u's lo panels follow its kP hi panels
          wgmma::Mma<48, 1, 1>::run(a_m, wgmma::desc_mn(ub + (kP + panel) * kUPanelDw + off),
                                    wgmma::desc_mn(dh + off));
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
    if constexpr (kF32) {  // the other buffer is free: the last tile is done with it
      if (resident && q + 1 < q_end) load_tile(q + 1, buf ^ 1, 0);
    }
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
// empty. It depends on B, L, di and dc alone, never on ld or u's type, so
// A4' gives A''s bits. -1 for a size below 1.
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

// du (B, L, di), dw (di, 3 dc), dparams (5, 3 dc) from u, dvx, dx0, all
// float32 or all bfloat16 (du in their type), on the tensor cores. Scratch:
// ws (tc::ws_numel(di, dc) bf16), part (runs * 5 * 3 dc), dwpart (runs * di
// * 3 dc), runs = bwd_runs(B, L, di, dc). ld == L for kernel A'.
template <typename T>
inline int launch(const T* u, const float* w, const float* bp, const float* wc, const float* bc,
                  const T* dvx, const T* dx0, T* du, float* dw, float* dparams,
                  __nv_bfloat16* ws, float* part, float* dwpart, int B, int L, int ld, int di,
                  int dc, int runs, cudaStream_t stream) {
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
    const auto du_kernel = tc::front_bwd_du_kernel<T, kP>;
    const auto dw_kernel = tc::front_bwd_dw_kernel<T, kP>;
    const int smem_du = tc::du_smem_bytes<T>(di, dc), smem_dw = tc::dw_smem_bytes<T>(di, dc);
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
  front_bwd_sum_kernel<<<(di * d3 + 31) / 32, tc::kThreads, 0, stream>>>(dwpart, runs, di * d3,
                                                                          dw);
  front_bwd_sum_kernel<<<(tc::kParts * d3 + 31) / 32, tc::kThreads, 0, stream>>>(
      part, runs, tc::kParts * d3, dparams);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace FRONT_NS
