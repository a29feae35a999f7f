// The tensor-core pieces of kernels A, A', A4 and A4', for float32 and
// bfloat16 u alike: the split of W into bf16 pairs, the tile loads, the
// projection on wgmma, and the dproj pass of the backward. Included by
// fused_front_common.cuh (forward) and fused_front_bwd_common.cuh
// (backward) inside their FRONT_NS. Each kernel is one template on u's
// type T (float or __nv_bfloat16) and the panel count.
//
// Precision. bf16 u, dvx and dx0 enter the products exactly. W, dproj and
// float32 u are split into hi = bf16(x), lo = bf16(x - hi), so
// |x - hi - lo| <= 2^-17 |x|, and a product is the float32 sum of the wgmma
// products of the pairs:
//   bf16 u:    proj = u W_hi + u W_lo,             dW = u^T dproj_hi + u^T dproj_lo
//   float32 u: proj = u_hi W_hi + u_hi W_lo + u_lo W_hi,
//              dW = u_hi^T dproj_hi + u_hi^T dproj_lo + u_lo^T dproj_hi
//   both:      du = dproj_hi W_hi^T + dproj_lo W_hi^T + dproj_hi W_lo^T.
// ops/fused_front.py's emulation chose them (tests/test_torch_port_front_split.py):
// bf16 u: a single rounding of W, or of dproj, misses the float32 tolerance
// of dW by 3-17x; two products for du reach 0.7-0.8 of its bf16 tolerance,
// three 0.002. float32 u: the nine products keep every output within 0.06
// of the float32 tolerance, and leaving out any one of them misses it by
// 11-18x; so float32 u costs one product more in the projection and in dW.
//
// Layouts (wgmma.cuh's 128-byte swizzle panels of 64 values a row):
//  * u tile: rows = times, panels along the d input channels i; the
//    projection's A (K-major) and dW's A (MN-major, M = i, K = t). float32
//    u: the hi panels, then the lo panels. bf16 u is copied with cp.async;
//    float32 u is read into registers, split and stored (cp.async cannot
//    convert), several 32-byte loads in flight a thread.
//  * W group: the 48 projected columns j of a group of 16 channels
//    (x0 | x1 | v) as rows, panels along i, hi panels then lo panels; the
//    projection's B (K-major, N = j) and du's B (MN-major, K = j, N = i).
//    split_w_kernel writes it once per call into a scratch, (G, 2, P, 48,
//    64) bf16, already swizzled, so a block copies it as it is.
//  * dproj: rows = times, one panel along j (48 of 64 used), hi and lo;
//    du's A (K-major, K = j) and dW's B (MN-major, K = t, N = j).
//  * cotangents: bf16 dvx, dx0 are staged in shared memory (cp.async);
//    float32 ones, whose staging would not fit beside the float32 u tile,
//    are read by the dproj pass straight from device memory.
// Two widths: di, u's width (the products' K for the projection, du's N
// and dW's M), and dc, the width of one output chunk (vx and x0 are
// (B, dc, L); W is (di, 3 dc), bp, wc and bc 3 dc wide). The whole model
// runs di == dc; under tensor parallelism a rank projects the whole u onto
// its dc = d / M channels of each chunk. Input panels follow di, channel
// groups dc.
// di <= 256 fits one chunk of 4 panels: the u tile and a group's W stay in
// shared memory across the loops. Wider di is taken in chunks of 256
// inputs, reloaded per step (correct, slower; no hg38 config is wider).
#pragma once

#include <type_traits>

#include "bf16_io.cuh"
#include "wgmma.cuh"

namespace FRONT_NS {
namespace tc {

using bf16 = __nv_bfloat16;
using bf16_io::to_f32;

constexpr int kThreads = 256;                         // two warpgroups
constexpr int kC = 16;                                // channels per group
constexpr int kJ = 3 * kC;                            // projected columns per group
constexpr int kChunkPanels = 4;                       // panels per input chunk
constexpr int kChunk = wgmma::kPanelCols * kChunkPanels;  // 256 inputs
constexpr int kWPanelBytes = kJ * wgmma::kRowBytes;   // 6144
constexpr int kWPanelElems = kWPanelBytes / 2;

// u panels a tile holds per input panel: bf16 u 1, float32 u 2 (hi, lo)
template <typename T>
constexpr int kUParts = std::is_same<T, float>::value ? 2 : 1;

// Sizes that follow from di and dc, the same on host and device.
struct Dims {
  int P, G, nchunk, Pm;  // P: input panels (di); G: channel groups (dc); Pm: the kernels' kP
  __host__ __device__ Dims(int di, int dc)
      : P((di + 63) / 64),
        G((dc + kC - 1) / kC),
        nchunk((P + kChunkPanels - 1) / kChunkPanels),
        Pm(P < kChunkPanels ? P : kChunkPanels) {}
  // panels of input chunk ic
  __device__ int panels(int ic) const {
    const int left = P - kChunkPanels * ic;
    return left < kChunkPanels ? left : kChunkPanels;
  }
  // bytes of one W group buffer (hi and lo panels of one chunk)
  __host__ __device__ int w_bytes() const { return 2 * Pm * kWPanelBytes; }
};

using wgmma::cp_async16;
using wgmma::cp_commit;
using wgmma::cp_wait;

// W (di, 3 dc) float32 -> the (G, 2, P, 48, 64) bf16 hi / lo panels; one
// thread per 8-value chunk of a panel row. Row j of group g is W's column
// (j / 16) * dc + 16 g + j % 16; values past di or dc are zero.
__global__ void __launch_bounds__(kThreads) split_w_kernel(const float* __restrict__ w,
                                                           bf16* __restrict__ ws, int di, int dc) {
  const Dims D(di, dc);
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<int64_t>(D.G) * D.P * kJ * 8) return;
  const int c = idx % 8;
  const int j = (idx / 8) % kJ;
  const int p = (idx / (8 * kJ)) % D.P;
  const int g = idx / (8 * kJ * D.P);
  const int ch = kC * g + j % kC;
  const int col = (j / kC) * dc + ch;
  float hi[8], lo[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int i = 64 * p + 8 * c + e;
    const float x = (i < di && ch < dc) ? w[static_cast<int64_t>(i) * 3 * dc + col] : 0.f;
    const bf16 h = __float2bfloat16_rn(x);
    hi[e] = __bfloat162float(h);
    lo[e] = x - hi[e];
  }
  bf16* hi_at = ws + (static_cast<int64_t>(g) * 2 * D.P + p) * kWPanelElems +  // panel (g, 0, p)
                wgmma::chunk_offset(j, c) / 2;
  bf16_io::store_vec<8>(hi_at, hi);
  bf16_io::store_vec<8>(hi_at + static_cast<int64_t>(D.P) * kWPanelElems, lo);  // (g, 1, p)
}

// Group g's W panels of input chunk ic -> dst: kP hi panels, then kP lo
// panels; panels past di (the last chunk of a wide di) are zero-filled.
template <int kP>
__device__ __forceinline__ void load_w(uint32_t dst, const bf16* ws, const Dims& D, int g, int ic) {
  constexpr int n = kP * (kWPanelBytes / 16);
  const int live = D.panels(ic) * (kWPanelBytes / 16);
  for (int q = threadIdx.x; q < 2 * n; q += kThreads) {
    const int h = q / n, r = q % n;
    const bf16* src =
        ws + ((static_cast<int64_t>(g) * 2 + h) * D.P + kChunkPanels * ic) * kWPanelElems + 8 * r;
    cp_async16(dst + h * kP * kWPanelBytes + 16 * r, r < live ? src : ws, r < live ? 16 : 0);
  }
}

// u rows t_base .. t_base + rows - 1 of batch row b, inputs i0 .. i0 + 64 pc
// - 1, into `pc` panels of `rows` rows at dst; zero outside [0, L) x [0, di).
// vec: di % 8 == 0, so a row's 8-value chunks are 16-byte aligned.
__device__ __forceinline__ void load_u(uint32_t dst, const bf16* u, int b, int t_base, int rows,
                                       int L, int di, int i0, int pc, bool vec) {
  const int n = rows * pc * 8;
  for (int q = threadIdx.x; q < n; q += kThreads) {
    const int c = q % 8, r = (q / 8) % rows, p = q / (8 * rows);
    const int t = t_base + r;
    const int i = i0 + 64 * p + 8 * c;
    const uint32_t a = dst + p * rows * wgmma::kRowBytes + wgmma::chunk_offset(r, c);
    const bool row_ok = t >= 0 && t < L;
    const bf16* src = u + (static_cast<int64_t>(b) * L + (row_ok ? t : 0)) * di;
    if (vec) {
      const bool ok = row_ok && i < di;
      cp_async16(a, ok ? src + i : u, ok ? 16 : 0);
    } else {
      __align__(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = (row_ok && i + e < di) ? src[i + e] : __float2bfloat16_rn(0.f);
      const uint4 raw = *reinterpret_cast<const uint4*>(v);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(raw.x), "r"(raw.y),
                   "r"(raw.z), "r"(raw.w)
                   : "memory");
    }
  }
}

// As load_u for float32 u, split into bf16 pairs: the hi panels at dst,
// the lo panels pc panels after them. Each thread loads kBatch chunks of 8
// values (two 16-byte reads each when vec) before it splits and stores
// them, so its loads are in flight together.
__device__ __forceinline__ void load_u(uint32_t dst, const float* u, int b, int t_base, int rows,
                                       int L, int di, int i0, int pc, bool vec) {
  constexpr int kBatch = 4;
  const int n = rows * pc * 8;
  const uint32_t lo_off = pc * rows * wgmma::kRowBytes;
  for (int q0 = threadIdx.x; q0 < n; q0 += kBatch * kThreads) {
    float v[kBatch][8];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int q = q0 + j * kThreads;
      const int c = q % 8, r = (q / 8) % rows, p = q / (8 * rows);
      const int t = t_base + r;
      const int i = i0 + 64 * p + 8 * c;
      const bool row_ok = q < n && t >= 0 && t < L;
      const float* src = u + (static_cast<int64_t>(b) * L + (row_ok ? t : 0)) * di + i;
      if (vec && row_ok && i < di) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(src));
        const float4 y = __ldg(reinterpret_cast<const float4*>(src) + 1);
        v[j][0] = x.x, v[j][1] = x.y, v[j][2] = x.z, v[j][3] = x.w;
        v[j][4] = y.x, v[j][5] = y.y, v[j][6] = y.z, v[j][7] = y.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[j][e] = (row_ok && i + e < di) ? src[e] : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int q = q0 + j * kThreads;
      if (q >= n) break;
      const int c = q % 8, r = (q / 8) % rows, p = q / (8 * rows);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[j][2 * e], v[j][2 * e + 1]);
        const float2 hf = __bfloat1622float2(h);
        const __nv_bfloat162 l =
            __floats2bfloat162_rn(v[j][2 * e] - hf.x, v[j][2 * e + 1] - hf.y);
        hi[e] = *reinterpret_cast<const uint32_t*>(&h);
        lo[e] = *reinterpret_cast<const uint32_t*>(&l);
      }
      const uint32_t a = dst + p * rows * wgmma::kRowBytes + wgmma::chunk_offset(r, c);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(hi[0]), "r"(hi[1]),
                   "r"(hi[2]), "r"(hi[3])
                   : "memory");
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a + lo_off), "r"(lo[0]),
                   "r"(lo[1]), "r"(lo[2]), "r"(lo[3])
                   : "memory");
    }
  }
}

// The cotangents of group g's 16 channels at times tb .. tb + ct - 1 (tb a
// multiple of 8): dvx rows at cs[c * stride], dx0 rows at cs[(16 + c) *
// stride]; zero past L and past dc. vec: ld % 8 == 0.
__device__ __forceinline__ void load_cot(bf16* cs, int stride, const bf16* dvx, const bf16* dx0,
                                         int b, int g, int tb, int ct, int L, int ld, int dc,
                                         bool vec) {
  const int per_row = ct / 8;
  const int n = 2 * kC * per_row;
  for (int q = threadIdx.x; q < n; q += kThreads) {
    const int k = q % per_row, row = q / per_row;  // row: which * 16 + c
    const int c = row % kC, ch = kC * g + c;
    const int t = tb + 8 * k;
    const int valid = ch < dc ? max(0, min(8, L - t)) : 0;
    const bf16* base = row < kC ? dvx : dx0;
    const bf16* src = base + (static_cast<int64_t>(b) * dc + (ch < dc ? ch : 0)) * ld + t;
    bf16* dst = cs + row * stride + 8 * k;
    if (vec) {
      cp_async16(wgmma::smem_u32(dst), valid > 0 ? src : base, 2 * valid);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = e < valid ? src[e] : __float2bfloat16_rn(0.f);
    }
  }
}

// acc (u rows urow0 .. urow0 + 63, W group rows wrow0 .. wrow0 + N - 1) +=
// the projection over one input chunk: kP panels of u at ub (panel stride
// upanel bytes; with kULo, u's lo panels follow its kP hi panels) and of W
// at wb, hi and lo (zero past di). No branch between the products, so
// ptxas keeps them asynchronous.
template <int N, int kP, bool kULo = false>
__device__ __forceinline__ void proj_mma(float (&acc)[N / 2], uint32_t ub, int upanel, int urow0,
                                         uint32_t wb, int wrow0) {
#pragma unroll
  for (int p = 0; p < kP; ++p) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a = ub + p * upanel + urow0 * wgmma::kRowBytes + 32 * kk;
      const uint32_t h = wb + p * kWPanelBytes + wrow0 * wgmma::kRowBytes + 32 * kk;
      const uint32_t l = h + kP * kWPanelBytes;
      wgmma::Mma<N, 0, 0>::run(acc, wgmma::desc_k(a), wgmma::desc_k(h));
      wgmma::Mma<N, 0, 0>::run(acc, wgmma::desc_k(a), wgmma::desc_k(l));
      if constexpr (kULo)
        wgmma::Mma<N, 0, 0>::run(acc, wgmma::desc_k(a + kP * upanel), wgmma::desc_k(h));
    }
  }
}

// The projection accumulator (rows row0.., W group rows j0 + col) plus bp into
// ps[row][col] (stride floats a row); rows at times outside [0, L) are zero
// (the conv pads proj, bias included, with zeros). tw: thread in warpgroup.
template <int N>
__device__ __forceinline__ void store_ps(float* ps, int stride, const float (&acc)[N / 2], int tw,
                                         int row0, int col0, int j0, const float* bp, int g,
                                         int dc, int t_first, int L) {
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const int row = row0 + wgmma::frag_row(tw, k);
    const int col = col0 + wgmma::frag_col(tw, k);
    const int j = j0 + col;
    const int ch = kC * g + j % kC;
    const int t = t_first + row;
    ps[row * stride + col] =
        (t >= 0 && t < L && ch < dc) ? acc[k] + bp[(j / kC) * dc + ch] : 0.f;
  }
}

// Stores x as a bf16 pair (hi, lo) at row, column j of the dproj panels.
__device__ __forceinline__ void put_split(uint8_t* hi, uint8_t* lo, int row, int j, float x) {
  const bf16 h = __float2bfloat16_rn(x);
  const uint32_t off = wgmma::elem_offset(row, j);
  *reinterpret_cast<bf16*>(hi + off) = h;
  *reinterpret_cast<bf16*>(lo + off) = __float2bfloat16_rn(x - __bfloat162float(h));
}

// The cotangent at local row s: bf16 rows from shared memory, which load_cot
// zero-filled past L; float32 rows straight from device memory, zero from
// local row s_end (time L) on.
__device__ __forceinline__ float cot_at(const bf16* p, int s, int) { return to_f32(p[s]); }
__device__ __forceinline__ float cot_at(const float* p, int s, int s_end) {
  return s < s_end ? __ldg(p + s) : 0.f;
}

// One item of the dproj pass: channel c of group g, local rows s0 .. s0 + kR -
// 1 (local row s is time t0 + s; ps row s + 2 is proj at that time).
//   conv at s from ps rows s .. s + 2, dconv = [dx0 | dvx v | dvx x1] at s,
//   dproj[s] = wc0 dconv[s + 2] + wc1 dconv[s + 1] + wc2 dconv[s]
// into the dproj panels (row dp_row0 + s, column part * 16 + c), split hi /
// lo. ps columns of channel c: x1 at px1 + c and v at px1 + 16 + c (x0 at
// px1 - 16 + c when kPartials).
// cvx / cx0 point at the cotangent rows of channel c at local row 0 (for
// float32, in device memory, s_end the local row of time L; see cot_at).
// With kPartials, sums[] gains this item's dbp, dwc[0..2] and dbc (5 x 3
// parts).
template <int kR, bool kPartials, typename T>
__device__ __forceinline__ void dproj_item(const float* ps, int stride, int px1, const T* cvx,
                                           const T* cx0, int s0, const float* wc,
                                           const float* bc, int dc, int g, int c, uint8_t* dp_hi,
                                           uint8_t* dp_lo, int dp_row0, float (&sums)[15],
                                           int s_end = 0) {
  const int d3 = 3 * dc, ch = kC * g + c;
  float w0[3], w1[3], w2[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const int gc = p * dc + ch;
    w0[p] = wc[gc];
    w1[p] = wc[d3 + gc];
    w2[p] = wc[2 * d3 + gc];
  }
  const float bc1 = bc[dc + ch], bcv = bc[2 * dc + ch];
  const float* r1 = ps + px1 + c;
  const float* rv = r1 + kC;
  const float* r0 = r1 - kC;  // read only when kPartials
  float a1 = r1[s0 * stride], b1 = r1[(s0 + 1) * stride];
  float av = rv[s0 * stride], bv = rv[(s0 + 1) * stride];
  float a0 = 0.f, b0 = 0.f;
  if (kPartials) {
    a0 = r0[s0 * stride];
    b0 = r0[(s0 + 1) * stride];
  }
  float dg[3][3] = {};  // [part][age]: dconv at s, s - 1, s - 2
#pragma unroll
  for (int m = 0; m < kR + 2; ++m) {
    const int s = s0 + m;
    const float c1 = r1[(s + 2) * stride], cv = rv[(s + 2) * stride];
    const float x1 = a1 * w0[1] + b1 * w1[1] + c1 * w2[1] + bc1;
    const float v = av * w0[2] + bv * w1[2] + cv * w2[2] + bcv;
    const float gvx = cot_at(cvx, s, s_end);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      dg[p][2] = dg[p][1];
      dg[p][1] = dg[p][0];
    }
    dg[0][0] = cot_at(cx0, s, s_end);
    dg[1][0] = gvx * v;   // d x1 = dvx * v
    dg[2][0] = gvx * x1;  // d v  = dvx * x1
    if (kPartials && m < kR) {
      const float c0 = r0[(s + 2) * stride];
      const float win[3][3] = {{a0, b0, c0}, {a1, b1, c1}, {av, bv, cv}};
#pragma unroll
      for (int p = 0; p < 3; ++p) {
#pragma unroll
        for (int j = 0; j < 3; ++j) sums[3 + 3 * j + p] += dg[p][0] * win[p][j];
        sums[12 + p] += dg[p][0];
      }
      a0 = b0;
      b0 = c0;
    }
    if (m >= 2) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const float dp = w0[p] * dg[p][0] + w1[p] * dg[p][1] + w2[p] * dg[p][2];
        if (kPartials) sums[p] += dp;
        put_split(dp_hi, dp_lo, dp_row0 + s - 2, p * kC + c, dp);
      }
    }
    a1 = b1;
    b1 = c1;
    av = bv;
    bv = cv;
  }
}

// Zero `bytes` (a multiple of 16) of shared memory at p.
__device__ __forceinline__ void zero_smem(uint8_t* p, int bytes) {
  for (int q = threadIdx.x; q < bytes / 16; q += kThreads)
    reinterpret_cast<uint4*>(p)[q] = make_uint4(0, 0, 0, 0);
}

using wgmma::aligned_smem;

// Calls f(std::integral_constant<int, Pm>) for Pm = Dims(di, .).Pm (1 to 4):
// each kernel is instantiated per panel count so its product loops unroll.
template <typename F>
inline int with_panels(int di, F f) {
  switch (Dims(di, 1).Pm) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    default: return f(std::integral_constant<int, 4>());
  }
}

// bf16 values of the split-W scratch at widths (di, dc), laid out as
// split_w_kernel writes it: (G groups, hi/lo, P panels, kJ x 64); -1 past
// the int range.
inline int ws_numel(int di, int dc) {
  const Dims D(di, dc);
  const int64_t n = static_cast<int64_t>(D.G) * 2 * D.P * kWPanelElems;
  return n > 0x7fffffff ? -1 : static_cast<int>(n);
}

inline int split_w(const float* w, bf16* ws, int di, int dc, cudaStream_t stream) {
  const Dims D(di, dc);
  const int64_t n = static_cast<int64_t>(D.G) * D.P * kJ * 8;
  split_w_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      w, ws, di, dc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace FRONT_NS
