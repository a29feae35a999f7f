// Kernel F: the fused transformer MLP forward, for Hopper.
//
//   y = gelu_tanh(x w1 + b1) w2 + b2
//
// x (N, d) and y (N, d_out) float32 or bfloat16 (one type for both); w1
// (d, dh) and w2 (dh, d_out) in bf16 (the wrapper rounds the float32
// parameters once, as the JAX kernel's `_mm` rounds every product's
// inputs); b1, b2 float32. Products run on the bf16 tensor cores with
// float32 accumulators; h = gelu_tanh(pre) is rounded to bf16 before its
// product, pre and the bias adds stay float32.
//
// Replaces hyena_dna_tpu/ops/pallas_mlp.py::mlp_fused, forward
// (`_fwd_kernel`, pallas_call at :104).
//
// What bounds it on the H100: the two products, 4 N d dh flops at the bf16
// tensor-core rate (N = 131072, d = d_out = 256, dh = 1024: 0.14 ms); its
// bytes are x and y only. The TPU kernel's point is that the (N, dh) hidden
// never reaches device memory, and that holds here:
//  * a block owns TM = 64 rows and walks dh in 64-wide chunks: pre =
//    x w1[:, chunk] with x and w1 streamed through d in 64-deep slabs
//    (stream_product), + b1, GeLU, h rounded to bf16 in shared memory, then
//    y += h w2[chunk, :] into float32 fragments held in registers;
//  * the chunk's w2 piece is copied by cp.async under the GeLU;
//  * y's columns are cut into slabs of 256 (grid.y), each with its own
//    recompute of h, so any d_out is taken (d_out <= 256: one slab);
//  * the epilogue adds b2 and rounds y once to its type.
// Shared memory is fixed (66.5 KB): any d, dh, d_out in multiples of 64.
// Simple first: WMMA fragments, no TMA or wgmma; x and the weights stream
// from L2 for every tile and chunk.
#define MLP_NS mlp_fwd
#include "mlp_common.cuh"

namespace MLP_NS {

// the streaming stage (the chunk's w2 piece once pre is done), h and pre;
// the epilogue's float y slab reuses the space from the start
inline size_t fwd_smem_bytes() {
  const size_t work = sizeof(bf16) * (kStage + TM * LDC) + sizeof(float) * TM * LDF;
  const size_t y_slab = sizeof(float) * TM * LDY;
  return work > y_slab ? work : y_slab;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mlp_fwd_kernel(
    const T* __restrict__ x, const bf16* __restrict__ w1, const float* __restrict__ b1,
    const bf16* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ y, int d, int dh,
    int dout) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stage = reinterpret_cast<bf16*>(smem);
  bf16* w2c = stage;  // w2[j:j+64, slab], 64 x ncol, once pre(j) is done
  bf16* hs = stage + kStage;
  float* pre = reinterpret_cast<float*>(hs + TM * LDC);
  float* ys = reinterpret_cast<float*>(smem);  // epilogue only
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * TM;
  const int col0 = blockIdx.y * SLAB;
  const int ncol = min(SLAB, dout - col0);

  FragC acc[8];
  zero(acc);
  for (int j = 0; j < dh; j += TK) {
    FragC pa[2];
    zero(pa);
    stream_product<false>(pa, x + row0 * d, d, w1 + j, dh, d, stage);
    store_chunk(pre, pa);
    copy_async(w2c, LDS, w2 + static_cast<int64_t>(j) * dout + col0, dout, TK, ncol);
    __syncthreads();  // pre is whole
    for (int e = threadIdx.x; e < TM * TK; e += blockDim.x) {
      const int r = e / TK, c = e % TK;
      hs[r * LDC + c] = __float2bfloat16_rn(gelu_tanh(pre[r * LDF + c] + b1[j + c]));
    }
    wait_copies();  // w2c, and h is whole
    slab_product<false>(acc, hs, w2c, LDS, ncol);
    __syncthreads();  // the stage and hs are free
  }
  store_slab(ys, acc, ncol);
  __syncthreads();
  const int vec = ncol / 8;
  for (int e = threadIdx.x; e < TM * vec; e += blockDim.x) {
    const int r = e / vec, c = (e % vec) * 8;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = ys[r * LDY + c + i] + b2[col0 + c + i];
    store8(y + (row0 + r) * dout + col0 + c, v);
  }
}

template <typename T>
int launch(const void* x, const bf16* w1, const float* b1, const bf16* w2, const float* b2,
           void* y, int N, int d, int dh, int dout, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes();
  cudaFuncSetAttribute(mlp_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const dim3 grid(N / TM, (dout + SLAB - 1) / SLAB);
  mlp_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), w1, b1, w2, b2,
                                                      static_cast<T*>(y), d, dh, dout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace MLP_NS

// x (N, d) and y (N, d_out) contiguous, both float32 (is_bf16 == 0) or both
// bfloat16; w1 (d, dh) and w2 (dh, d_out) contiguous bfloat16; b1 (dh,),
// b2 (d_out,) float32; every pointer 16-byte aligned. N, d, dh, d_out
// multiples of 64. Launches on `stream`, does not synchronise; returns the
// cudaError_t of the launch (0 on success).
extern "C" int hyena_mlp_fwd(const void* x, const void* w1, const float* b1, const void* w2,
                             const float* b2, void* y, int N, int d, int dh, int dout,
                             int is_bf16, cudaStream_t stream) {
  using namespace MLP_NS;
  if (!valid_widths(N, d, dh, dout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* w1b = static_cast<const bf16*>(w1);
  const auto* w2b = static_cast<const bf16*>(w2);
  if (is_bf16) return launch<bf16>(x, w1b, b1, w2b, b2, y, N, d, dh, dout, stream);
  return launch<float>(x, w1b, b1, w2b, b2, y, N, d, dh, dout, stream);
}
