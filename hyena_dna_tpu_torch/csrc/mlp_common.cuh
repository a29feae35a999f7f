// Pieces shared by kernels F (mlp_fused.cu, the fused MLP forward) and F'
// (mlp_fused_bwd.cu, its backward). The including file defines MLP_NS so
// the two libraries' kernels carry different names in a profiler trace.
//
// Products are bf16 tensor-core products with float32 accumulators, through
// WMMA 16 x 16 x 16 fragments (mma.sync underneath); eight warps share a
// block. Operands are rounded to bf16 exactly where the JAX kernel's `_mm`
// rounds them (hyena_dna_tpu/ops/pallas_mlp.py:38-43): x, dy and the
// weights on load, h and dh before their products. Everything else (the
// bias adds, the GeLU and its derivative, dh itself) stays float32.
//
// Shapes: a block works on tiles of TM = 64 rows; the hidden dimension dh
// is walked in chunks of TK = 64. A product over d or d_out (x w1[:, chunk],
// dy w2[chunk, :]^T) streams its depth through a fixed stage of shared
// memory in 64-deep slabs, double-buffered with 16-byte asynchronous copies
// (cp.async; a float32 operand is rounded on its way in), so shared memory
// does not grow with d or d_out and every width the JAX rule takes runs. A
// block accumulates at most SLAB = 256 output columns in registers
// (slab_product): a warp owns a 16-row, 128-column strip, eight fragments;
// that product's 64-deep weight piece (or the slab of x or dy the weight
// pass needs) is copied into the stage once the streamed products are done.
// Rows are padded by 16 bytes in shared memory, which keeps every fragment
// pointer 32-byte aligned as WMMA requires.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "bf16_io.cuh"

#ifndef MLP_NS
#error "define MLP_NS before including mlp_common.cuh"
#endif

namespace MLP_NS {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;      // eight warps
constexpr int TM = 64;             // rows of x in a tile
constexpr int TK = 64;             // dh chunk width, and depth of a streamed weight chunk
constexpr int SLAB = 256;          // output columns a block accumulates
constexpr int PAD = 8;             // bf16 row padding
constexpr int FPAD = 4;            // float row padding
constexpr int LDC = TK + PAD;      // a bf16 row of a 64-wide chunk
constexpr int LDF = TK + FPAD;     // a float row of a 64-wide chunk
constexpr int LDS = SLAB + PAD;    // a bf16 row of a slab
constexpr int LDY = SLAB + FPAD;   // a float row of a slab
// the streaming stage: A and B slabs (TM x LDC bf16) of two 64-deep steps;
// also holds a 64 x SLAB or SLAB x 64 bf16 piece once the streaming is done
constexpr int kStage = 4 * TM * LDC;
static_assert(kStage >= TK * LDS && kStage >= SLAB * LDC, "the stage holds a slab piece");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr float kC0 = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kC1 = 0.044715f;

// tanh-approximate GeLU and its derivative (pallas_mlp.py::_gelu_tanh, _gelu_tanh_grad)
__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.0f + tanhf(kC0 * (x + kC1 * x * x * x)));
}

__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float t = tanhf(kC0 * (x + kC1 * x * x * x));
  return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * kC0 * (1.0f + 3.0f * kC1 * x * x);
}

// Eight float32 values to a 16-byte aligned row, in its type.
__device__ __forceinline__ void store8(bf16* p, const float* v) { bf16_io::store_vec<8>(p, v); }
__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// Eight consecutive values of a row as loaded (bf16: one 16-byte load,
// float32: two), kept raw in registers until `put` rounds them to bf16.
template <typename T>
struct Vec8;
template <>
struct Vec8<bf16> {
  uint4 raw;
  __device__ __forceinline__ void load(const bf16* p) { raw = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void put(bf16* p) const { *reinterpret_cast<uint4*>(p) = raw; }
};
template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void put(bf16* p) const {
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    store8(p, v);
  }
};

// rows x cols (cols a multiple of 8) of src (row stride lds, float32 or
// bf16) into dst (row stride ldd) as bf16, rounded once to nearest even;
// 16-byte accesses, up to eight loads in flight per thread before their
// stores.
template <typename T>
__device__ __forceinline__ void load_tile(bf16* dst, int ldd, const T* src, int64_t lds,
                                          int rows, int cols) {
  constexpr int kBatch = 8;
  const int vec = cols / 8, total = rows * vec;
  for (int base = threadIdx.x; base < total; base += kBatch * blockDim.x) {
    Vec8<T> buf[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = base + i * blockDim.x;
      if (e < total) buf[i].load(src + (e / vec) * lds + (e % vec) * 8);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = base + i * blockDim.x;
      if (e < total) buf[i].put(dst + (e / vec) * ldd + (e % vec) * 8);
    }
  }
}

// Starts 16-byte asynchronous copies of rows x cols (cols a multiple of 8)
// of a bf16 matrix (row stride lds) into shared memory (row stride ldd);
// copy_async also commits them as one batch. wait_copies() then waits for
// every batch, or with `newest_pending` for all but the newest one.
__device__ __forceinline__ void issue_async(bf16* dst, int ldd, const bf16* src, int64_t lds,
                                            int rows, int cols) {
  const int vec = cols / 8;
  for (int e = threadIdx.x; e < rows * vec; e += blockDim.x) {
    const int r = e / vec, c = (e % vec) * 8;
    __pipeline_memcpy_async(dst + r * ldd + c, src + r * lds + c, 16);
  }
}

__device__ __forceinline__ void copy_async(bf16* dst, int ldd, const bf16* src, int64_t lds,
                                           int rows, int cols) {
  issue_async(dst, ldd, src, lds, rows, cols);
  __pipeline_commit();
}

// The copies started (all but the newest batch, with `newest_pending`) are
// done and visible to the whole block.
__device__ __forceinline__ void wait_copies(bool newest_pending = false) {
  if (newest_pending) {
    __pipeline_wait_prior(1);
  } else {
    __pipeline_wait_prior(0);
  }
  __syncthreads();
}

template <int kCount>
__device__ __forceinline__ void zero(FragC (&acc)[kCount]) {
#pragma unroll
  for (int f = 0; f < kCount; ++f) wmma::fill_fragment(acc[f], 0.0f);
}

// acc += A (64 x K, bf16 in shared memory, row stride lda) times B (K x 64,
// bf16 in shared memory): B[k][n] at b[k * ldb + n], or with kTrans at
// b[n * ldb + k]. The warp's 16 x 32 of the 64 x 64 result: rows
// 16 (warp / 2), columns 32 (warp % 2) + 16 f.
template <bool kTrans>
__device__ __forceinline__ void chunk_product(FragC (&acc)[2], const bf16* a, int lda,
                                              const bf16* b, int ldb, int K) {
  const int warp = threadIdx.x / 32;
  const int ar = (warp / 2) * 16, bc = (warp % 2) * 32;
#pragma unroll 4
  for (int kk = 0; kk < K; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + ar * lda + kk, lda);
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      if constexpr (kTrans) {
        FragBT fb;
        wmma::load_matrix_sync(fb, b + (bc + 16 * f) * ldb + kk, ldb);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      } else {
        FragB fb;
        wmma::load_matrix_sync(fb, b + kk * ldb + bc + 16 * f, ldb);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
  }
}

// The A slab of one streamed step: 64 rows x 64 columns of a bf16 operand
// by cp.async, of a float32 one rounded to bf16 through registers.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int64_t lds) {
  issue_async(dst, LDC, src, lds, TM, TK);
}
__device__ __forceinline__ void stage_rows(bf16* dst, const float* src, int64_t lds) {
  load_tile(dst, LDC, src, lds, TM, TK);
}

// acc += A (64 x K: row r at a + r lda, float32 or bf16) times B (K x 64,
// bf16): B[k][n] at b[k * ldb + n], or with kTrans at b[n * ldb + k]. K (a
// multiple of 64) streams through `stage` (kStage bf16) in 64-deep slabs,
// double-buffered: slab s + 1 is copied while slab s is multiplied, and the
// sum runs over k in order. Every thread of the block calls it, with no
// copy pending; it ends with the stage free (a barrier).
template <bool kTrans, typename T>
__device__ __forceinline__ void stream_product(FragC (&acc)[2], const T* a, int64_t lda,
                                               const bf16* b, int64_t ldb, int K, bf16* stage) {
  const int slabs = K / TK;
  auto load = [&](int s) {
    bf16* sa = stage + (s & 1) * 2 * TM * LDC;
    const int64_t k0 = static_cast<int64_t>(s) * TK;
    issue_async(sa + TM * LDC, LDC, kTrans ? b + k0 : b + k0 * ldb, ldb, TK, TK);
    stage_rows(sa, a + k0, lda);
    __pipeline_commit();
  };
  load(0);
  for (int s = 0; s < slabs; ++s) {
    if (s + 1 < slabs) load(s + 1);
    wait_copies(s + 1 < slabs);  // slab s is in (and, for a float32 A, visible)
    const bf16* sa = stage + (s & 1) * 2 * TM * LDC;
    chunk_product<kTrans>(acc, sa, LDC, sa + TM * LDC, LDC, TK);
    __syncthreads();  // slab s's buffers are free for slab s + 2
  }
}

// The warp's part of a 64 x 64 chunk product into dst (TM x LDF floats).
__device__ __forceinline__ void store_chunk(float* dst, FragC (&acc)[2]) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    wmma::store_matrix_sync(dst + (warp / 2) * 16 * LDF + (warp % 2) * 32 + 16 * f, acc[f], LDF,
                            wmma::mem_row_major);
  }
}

// acc += A (64 x 64 bf16 chunk, row stride LDC) times B (64 x ncol, bf16 in
// shared memory): B[k][n] at b[k * ldb + n], or with kTrans at
// b[n * ldb + k]. The warp owns rows 16 (warp % 4) and columns
// 128 (warp / 4) + 16 f of the 64 x SLAB result; columns past ncol are
// skipped (ncol is a multiple of 16).
template <bool kTrans>
__device__ __forceinline__ void slab_product(FragC (&acc)[8], const bf16* a, const bf16* b,
                                             int ldb, int ncol) {
  const int warp = threadIdx.x / 32;
  const int ar = (warp % 4) * 16, bc0 = (warp / 4) * 128;
#pragma unroll
  for (int kk = 0; kk < TK; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + ar * LDC + kk, LDC);
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const int bc = bc0 + 16 * f;
      if (bc >= ncol) continue;
      if constexpr (kTrans) {
        FragBT fb;
        wmma::load_matrix_sync(fb, b + bc * ldb + kk, ldb);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      } else {
        FragB fb;
        wmma::load_matrix_sync(fb, b + kk * ldb + bc, ldb);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
  }
}

// The warp's part of a 64 x SLAB slab into dst (TM x LDY floats).
__device__ __forceinline__ void store_slab(float* dst, FragC (&acc)[8], int ncol) {
  const int warp = threadIdx.x / 32;
  const int ar = (warp % 4) * 16, bc0 = (warp / 4) * 128;
#pragma unroll
  for (int f = 0; f < 8; ++f) {
    const int bc = bc0 + 16 * f;
    if (bc < ncol) wmma::store_matrix_sync(dst + ar * LDY + bc, acc[f], LDY, wmma::mem_row_major);
  }
}

inline bool valid_widths(int N, int d, int dh, int dout) {
  return N > 0 && N % TM == 0 && d > 0 && d % TK == 0 && dh > 0 && dh % TK == 0 && dout > 0 &&
         dout % TK == 0 && N / TM <= 2147483647;
}

}  // namespace MLP_NS
