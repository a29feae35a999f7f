// Kernel A: the fused Hyena front end, for Hopper.
//
//   proj = u @ W + bp                                   (B, L, 3d), float32
//   conv = causal depthwise k=3 conv of proj over time, zero left padding,
//          plus the conv bias bc                        (taps wc, time-major)
//   [x0 | x1 | v] = conv split along channels
//   vx = v * x1, x0                                     both (B, dc, L)
//
// u (B, L, di), vx and x0 are float32, or all three bfloat16 (the bf16
// model: vx and x0 in u's dtype, as the Pallas kernel's out_dtype =
// u.dtype); W (di, 3 dc), bp (3 dc), wc (3, 3 dc) with wc[j] multiplying
// proj[t - 2 + j] and bc (3 dc) are float32. di is u's width and dc the
// width of one output chunk: di == dc == d in the whole model; a
// tensor-parallel rank projects u onto its dc = d / M channels of each
// chunk [x0 | x1 | v]. The arithmetic is float32 either
// way: bf16 u is widened on load, so proj stays float32 and vx, x0 are
// rounded once.
//
// Replaces hyena_dna_tpu/ops/pallas_hyena.py::fused_proj_conv_gate
// (_kernel / _fwd_pallas), the front end of every order-2 Hyena layer.
//
// What bounds it on the H100: the bytes, 8 (bf16) or 16 (float32) per
// (t, channel) of u, vx and x0: 0.06 or 0.12 ms at 3.35 TB/s for B=4,
// L=32768, d=256, against 0.05 ms of tensor-core time for one bf16 product
// of the projection, 2 * L * d * 3d flops per batch row at 989 TFLOP/s.
// The kernel issues the projection as two (bf16 u: u W_hi + u W_lo) or
// three (float32 u: u_hi W_hi + u_hi W_lo + u_lo W_hi) bf16 pair products
// on wgmma, W split into bf16 pairs once per call and float32 u as its tile
// is loaded, which keeps the float32 result within the float32 tolerance.
//
// The tile body, its design notes and the launcher are in
// fused_front_common.cuh and fused_front_tc.cuh, shared with kernel A4
// (fused_front4.cu).
#define FRONT_NS front_fwd
#include "fused_front_common.cuh"

// All pointers to contiguous device memory: u (B, L, di), vx and x0 (B, dc,
// L) float32, the parameters float32; ws: scratch for W's bf16 pairs,
// hyena_front_ws_numel(di, dc) bf16 values. Launches on `stream`, does not
// synchronise; returns the cudaError_t of the launches.
extern "C" int hyena_fused_front_fwd(const float* u, const float* w, const float* bp,
                                     const float* wc, const float* bc, float* vx, float* x0,
                                     __nv_bfloat16* ws, int B, int L, int di, int dc,
                                     cudaStream_t stream) {
  return FRONT_NS::launch(u, w, bp, wc, bc, vx, x0, ws, B, L, L, di, dc, stream);
}

// As hyena_fused_front_fwd with u, vx and x0 bfloat16.
extern "C" int hyena_fused_front_fwd_bf16(const __nv_bfloat16* u, const float* w,
                                          const float* bp, const float* wc, const float* bc,
                                          __nv_bfloat16* vx, __nv_bfloat16* x0,
                                          __nv_bfloat16* ws, int B, int L, int di, int dc,
                                          cudaStream_t stream) {
  return FRONT_NS::launch(u, w, bp, wc, bc, vx, x0, ws, B, L, L, di, dc, stream);
}

// bf16 values of the split-W scratch `ws` the entries take at widths
// (di, dc) (-1 if it exceeds an int); the wrapper sizes the scratch by it.
extern "C" int hyena_front_ws_numel(int di, int dc) { return FRONT_NS::tc::ws_numel(di, dc); }

// A check of wgmma.cuh alone, for the tests: one warpgroup computes
// c (64 x N) = a (64 x 64) . b (64 x N) with a (64, 64) and b (64, 64)
// row-major bf16, c row-major float32, loading both into shared memory in
// the layout and descriptor form the kernels use for that product:
//   form 0: a K-major, b K-major, b's rows starting at panel row `off`
//           (the projection; off 16 and 24 as kernels A'1 and A'2 read W)
//   form 1: a K-major, b MN-major (du)
//   form 2: a MN-major, b MN-major (dW)
template <int N, int TA, int TB>
__global__ void __launch_bounds__(128) wgmma_probe_kernel(const __nv_bfloat16* __restrict__ a,
                                                           const __nv_bfloat16* __restrict__ b,
                                                           float* __restrict__ c, int off) {
  __shared__ __align__(1024) uint8_t sa[64 * wgmma::kRowBytes];
  __shared__ __align__(1024) uint8_t sb[128 * wgmma::kRowBytes];
  const int tid = threadIdx.x;
  for (int q = tid; q < 64 * 64; q += 128) {
    const int r = q / 64, e = q % 64;  // a[r][e]: row m, column k
    *reinterpret_cast<__nv_bfloat16*>(sa + (TA ? wgmma::elem_offset(e, r)
                                               : wgmma::elem_offset(r, e))) = a[q];
    // b[r][e]: row k, column n
    if (e < N)
      *reinterpret_cast<__nv_bfloat16*>(sb + (TB ? wgmma::elem_offset(r, e)
                                                 : wgmma::elem_offset(off + e, r))) = b[q];
  }
  wgmma::fence_proxy_async();
  __syncthreads();
  float acc[N / 2];
  wgmma::zero(acc);
  wgmma::fence_operand(acc);
  wgmma::fence();
  const uint32_t ua = wgmma::smem_u32(sa), ub = wgmma::smem_u32(sb);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = TA ? wgmma::desc_mn(ua + kk * 2 * wgmma::kGroupBytes)
                           : wgmma::desc_k(ua + 32 * kk);
    const uint64_t db = TB ? wgmma::desc_mn(ub + kk * 2 * wgmma::kGroupBytes)
                           : wgmma::desc_k(ub + off * wgmma::kRowBytes + 32 * kk);
    wgmma::Mma<N, TA, TB>::run(acc, da, db);
  }
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(acc);
#pragma unroll
  for (int k = 0; k < N / 2; ++k)
    c[wgmma::frag_row(tid, k) * N + wgmma::frag_col(tid, k)] = acc[k];
}

// mode: 0-2 form 0 with N = 48, 32, 24 (off 0, 16, 24); 3 form 1, N = 64;
// 4 form 2, N = 48. c holds 64 x N floats. Returns the launch's cudaError_t.
extern "C" int hyena_front_wgmma_probe(const __nv_bfloat16* a, const __nv_bfloat16* b, float* c,
                                       int mode, cudaStream_t stream) {
  switch (mode) {
    case 0: wgmma_probe_kernel<48, 0, 0><<<1, 128, 0, stream>>>(a, b, c, 0); break;
    case 1: wgmma_probe_kernel<32, 0, 0><<<1, 128, 0, stream>>>(a, b, c, 16); break;
    case 2: wgmma_probe_kernel<24, 0, 0><<<1, 128, 0, stream>>>(a, b, c, 24); break;
    case 3: wgmma_probe_kernel<64, 0, 1><<<1, 128, 0, stream>>>(a, b, c, 0); break;
    case 4: wgmma_probe_kernel<48, 1, 1><<<1, 128, 0, stream>>>(a, b, c, 0); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
