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
// front_fwd_tc_kernel<T, kP> (tensor cores, fused_front_tc.cuh), one body
// for both types of u:
//  * W is split once per call into bf16 hi / lo panels (split_w_kernel);
//    proj is the sum of the pair products of fused_front_tc.cuh (two for
//    bf16 u, three for float32 u, split as its tile is loaded) on wgmma,
//    accumulated in float32 registers.
//  * One block (two warpgroups) per (120-time tile, batch row): the 128 u
//    rows t0 - 2 .. t0 + 125 are read once into shared memory and stay
//    there while the block loops over the dc / 16 channel groups. Each
//    group's W panels (48 KB at di = 256, from L2): bf16 u double-buffers
//    them, the next group's load overlapping this group's products and
//    epilogue; float32 u, whose hi and lo u panels take the second buffer's
//    room, single-buffers them, the next group's load overlapping this
//    group's epilogue. Shared memory at di = 256: bf16 190,464 bytes (u 64
//    KB, W 2 x 48 KB, ps 25 KB), float32 206,848 (u 128 KB, W 48 KB, ps 25
//    KB), of the 232,448 a block may hold.
//  * Each warpgroup projects 64 rows x the group's 48 columns (m64n48k16,
//    two or three products per K step) into registers, then the block
//    writes the tile to shared memory (+ bp), and each thread takes 8
//    consecutive times of one channel through the conv and gate and stores
//    them as one 16-byte (bf16) or two 16-byte (float32) vectors along t
//    (tiles start at multiples of 8 times; scalar stores where ld % 8 != 0).
//  * The TPU kernels carried the previous tile's last two projected rows in
//    scratch across a sequential grid. CUDA blocks run in any order, so each
//    tile recomputes its own 2-row halo; rows before t = 0 are zero (the
//    conv pads the projection, bias included, with zeros), rows past L are
//    masked, so any L works. A tile at or past L only stores zeros, so the
//    zero tail costs its bytes and no more.
#pragma once

#include "bf16_io.cuh"
#include "fused_front_tc.cuh"

// FRONT_NS, defined by the including source, names the kernel for profiles.
namespace FRONT_NS {
namespace tc {

constexpr int kFwdRows = 128;                 // projected rows per tile
constexpr int kFwdOut = 120;                  // output times per tile (multiple of 8)
constexpr int kFwdPs = 50;                    // floats per ps row (conflict-free reads)
constexpr int kUPanelFwd = kFwdRows * wgmma::kRowBytes;

// W buffers of the forward: two for bf16 u, one for float32 u (see above)
template <typename T>
constexpr int kFwdWBufs = kUParts<T> == 1 ? 2 : 1;

template <typename T>
__host__ __device__ inline int fwd_smem_bytes(int di, int dc) {
  const Dims D(di, dc);
  return 1024 + kUParts<T> * D.Pm * kUPanelFwd + kFwdWBufs<T> * D.w_bytes() +
         kFwdRows * kFwdPs * 4;
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
__device__ __forceinline__ void store8(float* out, int64_t o, int t, int ld, bool vec,
                                       const float (&v)[8]) {
  if (vec && t + 8 <= ld) {
    float4* p = reinterpret_cast<float4*>(out + o);
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int m = 0; m < 8; ++m)
      if (t + m < ld) out[o + m] = v[m];
  }
}

template <typename T, int kP>
__global__ void __launch_bounds__(kThreads, 1) front_fwd_tc_kernel(
    const T* __restrict__ u, const bf16* __restrict__ ws, const float* __restrict__ bp,
    const float* __restrict__ wc, const float* __restrict__ bc, T* __restrict__ vx,
    T* __restrict__ x0, int L, int ld, int di, int dc) {
  extern __shared__ uint8_t smem_raw[];
  const Dims D(di, dc);
  constexpr int kWBytes = 2 * kP * kWPanelBytes;
  constexpr int kWBufs = kFwdWBufs<T>;
  constexpr int kUBytes = kUParts<T> * kP * kUPanelFwd;
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
  const uint32_t W0 = U + kUBytes;  // W buffer i at W0 + i * kWBytes
  float* ps = reinterpret_cast<float*>(sm + kUBytes + kWBufs * kWBytes);
  const bool vec_u = di % 8 == 0;
  const int nsteps = D.G * D.nchunk;  // (group, input chunk) steps

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
      if constexpr (kWBufs == 2) {
        if (s + 1 < nsteps) {
          load_w<kP>(W0 + ((s + 1) & 1) * kWBytes, ws, D, (s + 1) / D.nchunk,
                     (s + 1) % D.nchunk);
          cp_commit();
          cp_wait<1>();
        } else {
          cp_wait<0>();
        }
      } else {
        if (ic > 0) {  // a group's first chunk was loaded during the last epilogue
          load_w<kP>(W0, ws, D, g, ic);
          cp_commit();
        }
        cp_wait<0>();
      }
      wgmma::fence_proxy_async();
      __syncthreads();
      wgmma::fence_operand(acc);
      wgmma::fence();
      proj_mma<48, kP, (kUParts<T> == 2)>(acc, U, kUPanelFwd, 64 * wg,
                                          kWBufs == 2 ? W0 + (s & 1) * kWBytes : W0, 0);
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::fence_operand(acc);
    }

    store_ps<48>(ps, kFwdPs, acc, tw, 64 * wg, 0, 0, bp, g, dc, t0 - 2, L);
    __syncthreads();
    if constexpr (kWBufs == 1) {  // both warpgroups' products are done with W
      if (g + 1 < D.G) {
        load_w<kP>(W0, ws, D, g + 1, 0);
        cp_commit();
      }
    }
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

// vx, x0 (B, dc, ld) from u (B, L, di), all float32 or all bfloat16, on the
// tensor cores; ws: the split-W scratch (tc::ws_numel(di, dc) bf16). ld ==
// L for kernel A.
template <typename T>
inline int launch(const T* u, const float* w, const float* bp, const float* wc, const float* bc,
                  T* vx, T* x0, __nv_bfloat16* ws, int B, int L, int ld, int di, int dc,
                  cudaStream_t stream) {
  const int tiles = (ld + tc::kFwdOut - 1) / tc::kFwdOut;
  if (B < 1 || L < 1 || di < 1 || dc < 1 || ld < L || tiles > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rc = tc::split_w(w, ws, di, dc, stream);
  if (rc != 0) return rc;
  return tc::with_panels(di, [&](auto kp) {
    const auto kernel = tc::front_fwd_tc_kernel<T, decltype(kp)::value>;
    const int smem = tc::fwd_smem_bytes<T>(di, dc);
    const int err = static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (err != 0) return err;
    kernel<<<dim3(tiles, B), tc::kThreads, smem, stream>>>(u, ws, bp, wc, bc, vx, x0, L, ld, di,
                                                           dc);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace FRONT_NS
