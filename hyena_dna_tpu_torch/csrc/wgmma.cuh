// Hopper warpgroup matrix multiply (wgmma) for bf16 operands with float32
// accumulation, in inline PTX for sm_90a: shared-memory tile layout,
// matrix descriptors, the fence / commit / wait instructions, the
// m64nNk16 products at the widths the kernels use, and the accumulator
// fragment's (row, column) map. No CUTLASS: the build keeps its plain nvcc
// line (_cuda.NVCC_FLAGS).
//
// Tile layout. Every operand lives in "panels": R rows of 64 bf16 values
// (128 bytes), each row's eight 16-byte chunks swizzled as chunk ^ (row % 8)
// (the 128-byte swizzle), a panel starting on a 1024-byte boundary. A panel
// row is one row of the matrix in its K-major form (rows = M or N, the 64
// values along K) or one K row in its MN-major form (the 64 values along M
// or N). Descriptors:
//   * K-major: start at row r0, column k0 (a multiple of 16) of the panel:
//     base + r0 * 128 + k0 * 2; the 8-row groups of M or N 1024 bytes apart
//     (SBO); LBO unused (the 16 K values of one product lie in one row).
//   * MN-major: start at K row k0 (a multiple of 16): base + k0 * 128; the
//     8-row groups of K 1024 bytes apart. One product here never spans more
//     than the 64 M or N values of one panel, so the stride between panels
//     is never read: both offset fields hold the K-group stride, whichever
//     one the hardware takes for it.
// wgmma_probe (fused_front.cu) checks each form against torch.matmul.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace wgmma {

constexpr int kPanelCols = 64;      // bf16 values in one panel row
constexpr int kRowBytes = 128;      // bytes in one panel row
constexpr int kGroupBytes = 1024;   // 8 panel rows: the swizzle's period

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset, inside a panel, of the 16-byte chunk `chunk` of row `row`.
__device__ __forceinline__ uint32_t chunk_offset(int row, int chunk) {
  return row * kRowBytes + ((chunk ^ (row & 7)) << 4);
}

// Byte offset, inside a panel, of value `col` (0..63) of row `row`.
__device__ __forceinline__ uint32_t elem_offset(int row, int col) {
  return chunk_offset(row, col >> 3) + ((col & 7) << 1);
}

__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t desc = (addr & 0x3FFFF) >> 4;
  desc |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  desc |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  desc |= 1ull << 62;  // 128-byte swizzle
  return desc;
}

// K-major operand starting at shared address `addr` (see above).
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return descriptor(addr, 16, kGroupBytes);
}

// MN-major operand starting at shared address `addr` (see above).
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return descriptor(addr, kGroupBytes, kGroupBytes);
}

// Orders this warpgroup's register and shared-memory accesses before the
// wgmma instructions that follow.
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's generic-proxy shared-memory writes (st.shared,
// cp.async) visible to wgmma's reads; a barrier then publishes them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of an accumulator register across
// the asynchronous products that write it.
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// d (64 x N, float32, in registers) += A (64 x 16) . B (16 x N), both bf16 in
// shared memory; TA / TB: 0 for a K-major operand, 1 for an MN-major one.
// The accumulator holds N / 2 values a thread (see frag_row / frag_col).
template <int N, int TA, int TB>
struct Mma;

template <int TA, int TB>
struct Mma<24, TA, TB> {
  __device__ __forceinline__ static void run(float (&d)[12], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11},"
        " %12, %13, p, 1, 1, %15, %16;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Mma<32, TA, TB> {
  __device__ __forceinline__ static void run(float (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Mma<48, TA, TB> {
  __device__ __forceinline__ static void run(float (&d)[24], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23},"
        " %24, %25, p, 1, 1, %27, %28;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Mma<64, TA, TB> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};


// Row (0..63) and column (0..N-1) of accumulator value k of the calling
// thread, for `tid` its index in the warpgroup (0..127): warp w owns rows
// 16 w .. 16 w + 15; value k lies in the 8-column block k / 4.
__device__ __forceinline__ int frag_row(int tid, int k) {
  return 16 * (tid >> 5) + ((tid & 31) >> 2) + 8 * ((k >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int tid, int k) {
  return 8 * (k >> 2) + 2 * (tid & 3) + (k & 1);
}

}  // namespace wgmma
