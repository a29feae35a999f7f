// Pieces shared by kernels F (mlp_fused.cu, the fused MLP forward) and F'
// (mlp_fused_bwd.cu, its backward). The including file defines MLP_NS so
// the two libraries' kernels carry different names in a profiler trace.
//
// Products are bf16 wgmma products with float32 accumulators (wgmma.cuh),
// issued by two warpgroups of 128 threads. Operands are rounded to bf16
// exactly where the JAX kernel's `_mm` rounds them
// (hyena_dna_tpu/ops/pallas_mlp.py:38-43): float32 x and dy once per call,
// into a bf16 copy (round_bf16), the weights by the wrapper, h and dh in
// registers before they are stored as a product's operand. Everything else
// (the bias adds, the GeLU and its derivative, dh itself) stays float32.
//
// Tiles (wgmma.cuh's panels): a block owns TM = 128 rows of x (and dy),
// warpgroup g rows 64 g .. 64 g + 63, and walks the hidden dimension dh in
// TK = 64-wide chunks. A chunk of the other widths (d, d_out) is P panels
// (P = 1..4, 64 P values: the kernels are instantiated per P, so every
// product loop unrolls branch-free); a width wider than 64 P is taken in
// chunks of 64 P, the last zero-padded. Every operand keeps one layout,
// read K-major or MN-major as each product needs:
//  * the x (dy) tile: P panels of 128 rows: pre's (g's) A, K-major; F''s
//    dw1^T (dw2) B, MN-major across panels (K = the rows);
//  * a w1 chunk, rows k of w1[:, j:j+64]: one panel of 64 P rows: pre's B,
//    MN-major (K = d), and dx's B, K-major (N = d);
//  * a w2 chunk, rows w2[j:j+64, :] as P panels of 64 rows: F's y B,
//    MN-major across panels (K = dh), and g's B, K-major (N = dh);
//  * h and dh: one panel of 128 rows, each warpgroup writing its own 64:
//    A of y and dx (K-major, K = dh) and of dw1^T and dw2 (MN-major, K =
//    the rows).
// Rows past N are zero-filled on load and masked on store (N is a multiple
// of 64, so a last tile may hold 64 rows).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bf16_io.cuh"
#include "wgmma.cuh"

#ifndef MLP_NS
#error "define MLP_NS before including mlp_common.cuh"
#endif

namespace MLP_NS {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;                            // two warpgroups
constexpr int TM = 128;                                  // rows of a block's tile
constexpr int TK = 64;                                   // dh chunk width; the unit of every width
constexpr int kMaxPanels = 4;                            // P: panels of a width chunk, at most
constexpr int kTilePanel = TM * wgmma::kRowBytes;        // one panel of a 128-row tile (16 KB)
constexpr int kChunkPanel = TK * wgmma::kRowBytes;       // one panel of 64 rows (8 KB)

constexpr float kC0 = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kC1 = 0.044715f;

// The tanh-approximate GeLU and its derivative (pallas_mlp.py::_gelu_tanh,
// _gelu_tanh_grad) through s = sigmoid(2u) = (1 + tanh(u)) / 2, u = kC0 (x +
// kC1 x^3): gelu = x s, gelu' = s + 2 x s (1 - s) u'. The same functions;
// e^(-2u) on the special-function unit (exp2) and one fast reciprocal, no
// cancellation for negative x, and a few instructions instead of tanhf's
// branches and IEEE division. e^(-2u) = inf gives s = 0, 0 gives s = 1.
__device__ __forceinline__ float sigmoid_2u(float x) {
  constexpr float kA = -2.0f * 1.4426950408889634f * kC0;  // -2 log2(e) kC0
  return __fdividef(1.0f, 1.0f + exp2f(x * (kA + kA * kC1 * x * x)));
}

__device__ __forceinline__ float gelu_tanh(float x) { return x * sigmoid_2u(x); }

__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float s = sigmoid_2u(x);
  return s + 2.0f * x * s * (1.0f - s) * kC0 * (1.0f + 3.0f * kC1 * x * x);
}

// Both at once: h = gelu_tanh(x), returns gelu_tanh'(x).
__device__ __forceinline__ float gelu_tanh_and_grad(float x, float& h) {
  const float s = sigmoid_2u(x);
  h = x * s;
  return s + 2.0f * x * s * (1.0f - s) * kC0 * (1.0f + 3.0f * kC1 * x * x);
}

// dst = src rounded to bf16 (nearest even), n a multiple of 8, 16-byte aligned.
__global__ void __launch_bounds__(kThreads) round_bf16_kernel(const float* __restrict__ src,
                                                              bf16* __restrict__ dst, int64_t n) {
  for (int64_t i = 8 * (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x); i < n;
       i += 8 * static_cast<int64_t>(gridDim.x) * kThreads) {
    const float4 a = *reinterpret_cast<const float4*>(src + i);
    const float4 b = *reinterpret_cast<const float4*>(src + i + 4);
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    bf16_io::store_vec<8>(dst + i, v);
  }
}

inline int round_bf16(const float* src, bf16* dst, int64_t n, cudaStream_t stream) {
  round_bf16_kernel<<<1024, kThreads, 0, stream>>>(src, dst, n);
  return static_cast<int>(cudaGetLastError());
}

// Starts the copy of rows [0, R) x columns [0, 64 P) of a bf16 matrix
// (`src` its row 0, column 0; row stride ld) into P panels of R rows at
// shared address dst, `panel_bytes` apart; rows >= nrow and columns >= ncol
// are zero-filled. NT threads take part, the caller their t-th: thread t
// copies the 16 bytes c = t % 8 of rows t / 8 + k NT / 8, which all share
// one swizzle, so each copy is a few instructions from two base addresses.
template <int R, int P, int NT = kThreads>
__device__ __forceinline__ void load_panels(uint32_t dst, int panel_bytes, const bf16* src,
                                            int64_t ld, int nrow, int ncol, int t) {
  constexpr int kRowStep = NT / 8;
  static_assert(R % kRowStep == 0, "whole rounds of copies");
  const int c = t % 8, r0 = t / 8;
  const uint32_t d0 = dst + r0 * wgmma::kRowBytes + ((c ^ (r0 & 7)) << 4);
  const bf16* s0 = src + r0 * ld + 8 * c;
  const int64_t step = kRowStep * ld;
#pragma unroll 1
  for (int p = 0; p < P; ++p) {
    const bool col_ok = 64 * p + 8 * c < ncol;
#pragma unroll
    for (int h = 0; h < R / kRowStep; ++h) {
      const bool ok = col_ok && r0 + h * kRowStep < nrow;
      wgmma::cp_async16(d0 + p * panel_bytes + h * kRowStep * wgmma::kRowBytes,
                        ok ? s0 + h * step + 64 * p : src, ok ? 16 : 0);
    }
  }
}

// The copies this thread started are done (all but the newest group with
// kNewestPending), and every thread's are visible to the block's wgmma.
template <bool kNewestPending>
__device__ __forceinline__ void copies_landed() {
  if constexpr (kNewestPending) {
    wgmma::cp_wait<1>();
  } else {
    wgmma::cp_wait<0>();
  }
  wgmma::fence_proxy_async();
  __syncthreads();
}

// Barrier of the calling warpgroup alone (barrier 1 + g; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + static_cast<int>(threadIdx.x) / 128) : "memory");
}

// The accumulator values 2 i, 2 i + 1 of a 64 x 64 product (`v`, 32 a
// thread) as bf16 pairs into rows row0 .. row0 + 63 of a 64-wide panel.
__device__ __forceinline__ void put_panel(uint8_t* panel, int row0, int tw, const float (&v)[32]) {
#pragma unroll
  for (int k = 0; k < 32; k += 2) {
    *reinterpret_cast<__nv_bfloat162*>(
        panel + wgmma::elem_offset(row0 + wgmma::frag_row(tw, k), wgmma::frag_col(tw, k))) =
        __floats2bfloat162_rn(v[k], v[k + 1]);
  }
}

// Two consecutive values of a row of y or dx, rounded once to its type.
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The descriptor of an operand `bytes` (a multiple of 16) further on: the
// start address is the descriptor's low field, and shared memory's 18-bit
// addresses never carry out of it.
__device__ __forceinline__ uint64_t advance(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// The products below start asynchronously and commit one wgmma group each;
// `settle` waits for them. No branch sits inside a chain, so ptxas keeps
// the products asynchronous.

// acc (the warpgroup's 64 rows x 64) += A (P K-major panels of a tile,
// `a_panel` bytes apart, `a` at the warpgroup's first row) . B (one panel of
// 64 P K rows, MN-major): pre = x w1[:, chunk] over one chunk of d.
template <int P>
__device__ __forceinline__ void start_k_mn(float (&acc)[32], uint32_t a, int a_panel, uint32_t b) {
  const uint64_t da = wgmma::desc_k(a), db = wgmma::desc_mn(b);
  wgmma::fence_operand(acc);
  wgmma::fence();
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma::Mma<64, 0, 1>::run(acc, advance(da, p * a_panel + 32 * kk),
                                advance(db, (64 * p + 16 * kk) * wgmma::kRowBytes));
    }
  }
  wgmma::commit();
}

// acc (64 rows x 64) += A (P K-major panels of a tile, `a_panel` bytes
// apart, at the warpgroup's first row) . B (P K-major panels of 64 rows, 8 KB
// apart, N = the rows): g = dy w2[chunk, :]^T over one chunk of d_out.
template <int P>
__device__ __forceinline__ void start_k_k(float (&acc)[32], uint32_t a, int a_panel, uint32_t b) {
  const uint64_t da = wgmma::desc_k(a), db = wgmma::desc_k(b);
  wgmma::fence_operand(acc);
  wgmma::fence();
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma::Mma<64, 0, 0>::run(acc, advance(da, p * a_panel + 32 * kk),
                                advance(db, p * kChunkPanel + 32 * kk));
    }
  }
  wgmma::commit();
}

// acc (64 rows x 64 P) += A (64 x 64 K-major: `a` at the warpgroup's rows of
// the h or dh panel) . B (64 K = dh values): kMN, B MN-major as P panels of
// 64 K rows 8 KB apart (F's y += h w2[chunk, :]); else B K-major, 64 P rows
// of one panel (F''s dx += dh w1[:, chunk]^T).
template <int P, bool kMN>
__device__ __forceinline__ void start_wide(float (&acc)[32 * P], uint32_t a, uint32_t b) {
  const uint64_t da = wgmma::desc_k(a);
  const uint64_t db = kMN ? wgmma::desc_mn(b, kChunkPanel) : wgmma::desc_k(b);
  wgmma::fence_operand(acc);
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma::Mma<64 * P, 0, kMN ? 1 : 0>::run(
        acc, advance(da, 32 * kk), advance(db, kMN ? 16 * kk * wgmma::kRowBytes : 32 * kk));
  }
  wgmma::commit();
}

// b1[j .. j + 63] (float32, 16-byte aligned) into shared memory at dst, by
// threads 0 .. 15: the GeLU reads its biases there, not from L1.
__device__ __forceinline__ void load_bias(uint32_t dst, const float* b1, int j) {
  if (threadIdx.x < TK / 4) wgmma::cp_async16(dst + 16 * threadIdx.x, b1 + j + 4 * threadIdx.x, 16);
}

// Waits for every product this warpgroup started; their accumulators may
// then be read.
template <int R>
__device__ __forceinline__ void settle(float (&a)[R]) {
  wgmma::wait<0>();
  wgmma::fence_operand(a);
}
template <int R1, int R2>
__device__ __forceinline__ void settle(float (&a)[R1], float (&b)[R2]) {
  settle(a);
  wgmma::fence_operand(b);
}

// Calls f(std::integral_constant<int, P>) for P = min(4, max(d, d_out) / 64):
// each kernel is instantiated per panel count.
template <typename F>
inline int with_panels(int d, int dout, F f) {
  const int widest = (d > dout ? d : dout) / TK;
  switch (widest < kMaxPanels ? widest : kMaxPanels) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    default: return f(std::integral_constant<int, 4>());
  }
}

// Rows of the tile at row0 that lie inside the N rows.
__device__ __forceinline__ int tile_rows(int N, int64_t row0) {
  const int64_t left = N - row0;
  return left < TM ? static_cast<int>(left) : TM;
}

inline bool valid_widths(int N, int d, int dh, int dout) {
  return N > 0 && N % TK == 0 && d > 0 && d % TK == 0 && dh > 0 && dh % TK == 0 && dout > 0 &&
         dout % TK == 0;
}

}  // namespace MLP_NS
