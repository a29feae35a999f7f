// Kernel D: the fused residual-add + LayerNorm of the prenorm block,
// forward, for Hopper (kernel D', its backward, is add_ln_bwd.cu).
//
//   res_out = bf16(f32(h) + f32(res))                    one rounding
//   y       = bf16(LN_f32stats(res_out) * scale + bias)  statistics from the
//                                                         ROUNDED res_out
//
// h, res, res_out and y are bfloat16 (N, d), row-major; scale and bias are
// float32 (d).
//
// Replaces hyena_dna_tpu/ops/pallas_ln.py::add_ln_fused's forward:
// _fwd_kernel (its pallas_call in _fwd), which the JAX dispatcher takes for
// a bfloat16 residual stream with bfloat16 output.
//
// What bounds it on the H100: bytes. It reads two and writes two bf16 (N, d)
// tensors, 8 bytes per element: 268 MB at N = 4 x 32768, d = 256, 0.080 ms
// at 3.35 TB/s, against ~12 float32 operations per element.
//
// Design: one warp per row (add_ln_common.cuh), eight rows per block; any N.
#include "add_ln_common.cuh"

namespace {

using namespace add_ln;

template <int V, int NC>
__global__ void __launch_bounds__(kThreads) add_ln_fwd_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ res, const float* __restrict__ scale,
    const float* __restrict__ bias, bf16* __restrict__ y, bf16* __restrict__ res_out, int n,
    float eps) {
  constexpr int D = NC * 32 * V;
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= n) return;
  const int64_t base = row * D;
  float x[NC][V];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = col_of<V>(c, lane);
    float a[V], b[V];
    load_vec<V>(h + base + col, a);
    load_vec<V>(res + base + col, b);
#pragma unroll
    for (int i = 0; i < V; ++i) a[i] += b[i];
    store_vec<V>(res_out + base + col, a);
    // the statistics read the rounded residual, as the stored res_out
#pragma unroll
    for (int i = 0; i < V; ++i) x[c][i] = __bfloat162float(__float2bfloat16_rn(a[i]));
  }
  float mean, rstd;
  row_stats<V, NC>(x, eps, mean, rstd);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = col_of<V>(c, lane);
    float out[V];
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = ((x[c][i] - mean) * rstd) * scale[col + i] + bias[col + i];
    store_vec<V>(y + base + col, out);
  }
}

template <int V, int NC>
int launch_fwd(const void* h, const void* res, const float* scale, const float* bias, void* y,
               void* res_out, int n, float eps, cudaStream_t stream) {
  const int blocks = (n + kWarps - 1) / kWarps;
  add_ln_fwd_kernel<V, NC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(res), scale, bias,
      static_cast<bf16*>(y), static_cast<bf16*>(res_out), n, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h, res, y, res_out: bfloat16 (n, d) contiguous, 16-byte aligned; scale,
// bias: float32 (d); d in ADD_LN_DISPATCH. Launches on `stream`, does not
// synchronise; returns the cudaError_t of the launch.
extern "C" int hyena_add_ln_fwd(const void* h, const void* res, const float* scale,
                                const float* bias, void* y, void* res_out, int n, int d,
                                float eps, cudaStream_t stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
#define FWD(V, NC) launch_fwd<V, NC>(h, res, scale, bias, y, res_out, n, eps, stream)
  ADD_LN_DISPATCH(d, FWD)
#undef FWD
}
