// Kernel F: the fused transformer MLP forward, for Hopper.
//
//   y = gelu_tanh(x w1 + b1) w2 + b2
//
// x (N, d) and y (N, d_out) float32 or bfloat16 (one type for both); w1
// (d, dh) and w2 (dh, d_out) in bf16 (the wrapper rounds the float32
// parameters once, as the JAX kernel's `_mm` rounds every product's
// inputs); b1, b2 float32. Float32 x is rounded to bf16 once, into a copy,
// before the kernel runs. Products run on the bf16 tensor cores (wgmma)
// with float32 accumulators; h = gelu_tanh(pre) is rounded to bf16 before
// its product, pre and the bias adds stay float32.
//
// Replaces hyena_dna_tpu/ops/pallas_mlp.py::mlp_fused, forward
// (`_fwd_kernel`, pallas_call at :104).
//
// What bounds it on the H100: the two products, 4 N d dh flops at the bf16
// tensor-core rate (N = 131072, d = d_out = 256, dh = 1024: 0.14 ms); its
// bytes are x and y only. The (N, dh) hidden never reaches device memory:
//  * a block owns TM = 128 rows (two warpgroups of 64) of one 64 P-wide
//    slab of y's columns, and keeps the x tile in shared memory while it
//    walks dh in 64-wide chunks: pre = x w1[:, chunk] (64 x 64 a warpgroup,
//    in registers), + b1 and the GeLU in registers, h rounded once into the
//    warpgroup's rows of a bf16 panel, then y += h w2[chunk, :] into 64 x
//    64 P float32 accumulators held in registers;
//  * the chunks of w1, w2 and b1 are double-buffered: step j starts
//    pre(j + 1), then the copies (cp.async) of w1(j + 2) and w2(j + 1),
//    before the GeLU of pre(j), so the GeLU and the copies run under that
//    product; one barrier a step;
//  * y's columns past 64 P (d_out > 256) are cut into slabs (grid.y), each
//    recomputing pre; d > 64 P streams x and w1 in 64 P-deep chunks, x
//    reloaded per dh chunk (correct, slower: at d = d_out = 512 the first
//    product is computed twice and x read from L2 2 dh / 64 times);
//  * the epilogue adds b2 and rounds y once to its type.
// Shared memory at P = 4: x 64 KB, two w1 and two w2 chunks 32 KB each, h
// 16 KB, b1 0.5 KB. Every block reads all of w1 and w2 from L2 (1 MB at d = 256, dh =
// 1024; 1.07 GB at N = 131072): the L2 reads, not the products, are the
// floor at the hg38 width.
#define MLP_NS mlp_fwd
#include "mlp_common.cuh"

namespace MLP_NS {

// Byte offsets of kernel F's shared-memory buffers at P panels.
template <int P>
struct FwdSmem {
  static constexpr int x = 0;                          // x tile: P panels of 128 rows
  static constexpr int w1 = x + P * kTilePanel;        // two w1 chunks: 64 P rows of a panel
  static constexpr int w2 = w1 + 2 * P * kChunkPanel;  // two w2 chunks: P panels of 64 rows
  static constexpr int h = w2 + 2 * P * kChunkPanel;   // h: 128 rows of one panel
  static constexpr int bias = h + kTilePanel;          // two chunks of b1: 64 floats each
  static constexpr int bytes = bias + 2 * TK * 4;
  static constexpr int chunk = P * kChunkPanel;        // bytes of one w1 or w2 chunk
};

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1) mlp_fwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1, const float* __restrict__ b1,
    const bf16* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ y, int N, int d,
    int dh, int dout) {
  using S = FwdSmem<P>;
  constexpr int W = 64 * P;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = wgmma::aligned_smem(smem_raw);
  const uint32_t base = wgmma::smem_u32(sm);
  const int tw = threadIdx.x % 128, wg = threadIdx.x / 128;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * TM;
  const int nrow = tile_rows(N, row0);
  const int col0 = blockIdx.y * W, ncol = min(W, dout - col0);
  const int nd = (d + W - 1) / W;  // chunks of d: the x tile stays resident when 1
  const uint32_t xa = base + S::x + 64 * wg * wgmma::kRowBytes;  // this warpgroup's rows
  const uint32_t ha = base + S::h + 64 * wg * wgmma::kRowBytes;
  auto load_x = [&](int c) {
    load_panels<TM, P>(base + S::x, kTilePanel, x + row0 * d + c * W, d, nrow, d - c * W,
                       threadIdx.x);
  };
  // chunk c of w1[:, j:j+64], chunk j of w2's rows, into buffer buf
  auto load_w1 = [&](int j, int c, int buf) {
    load_panels<W, 1>(base + S::w1 + buf * S::chunk, 0, w1 + static_cast<int64_t>(c) * W * dh + j,
                      dh, d - c * W, TK, threadIdx.x);
  };
  auto load_w2 = [&](int j, int buf) {
    load_panels<TK, P>(base + S::w2 + buf * S::chunk, kChunkPanel,
                       w2 + static_cast<int64_t>(j) * dout + col0, dout, TK, ncol, threadIdx.x);
  };
  // h = gelu(pre + b1) in bf16 (b1's chunk in bias slot `slot`), into this
  // warpgroup's rows of the h panel
  const float* bias = reinterpret_cast<const float*>(sm + S::bias);
  auto put_h = [&](int slot, float (&pre)[32]) {
#pragma unroll
    for (int k = 0; k < 32; ++k) pre[k] = gelu_tanh(pre[k] + bias[TK * slot + wgmma::frag_col(tw, k)]);
    put_panel(sm + S::h, 64 * wg, tw, pre);
    wgmma::fence_proxy_async();
    warpgroup_sync();
  };

  float acc[W / 2];
  wgmma::zero(acc);
  if (nd == 1) {
    // x stays; chunk j of w1, w2 and b1 in buffer j % 2. Step j starts
    // pre(j + 1) before the GeLU of pre(j), so the GeLU runs under that
    // product.
    load_x(0);
    load_w1(0, 0, 0);
    load_w2(0, 0);
    load_bias(base + S::bias, b1, 0);
    wgmma::cp_commit();
    if (TK < dh) load_w1(TK, 0, 1);
    wgmma::cp_commit();
    copies_landed<false>();
    float pa[32], pb[32];
    wgmma::zero(pa);
    start_k_mn<P>(pa, xa, kTilePanel, base + S::w1);
    settle(pa);
    auto step = [&](int j, float (&cur)[32], float (&nxt)[32]) {
      const int b = (j / TK) & 1;
      // w1(j + 1), w2(j) and b1(j) have landed, and every warpgroup is done
      // with pre(j) and y(j - 1): w1[b], w2[b ^ 1], b1[b ^ 1] and h are free
      copies_landed<false>();
      // pre(j + 1); after the last chunk a spare product on a stale buffer,
      // so the chain has no branch
      wgmma::zero(nxt);
      start_k_mn<P>(nxt, xa, kTilePanel, base + S::w1 + (b ^ 1) * S::chunk);
      if (j + 2 * TK < dh) load_w1(j + 2 * TK, 0, b);
      if (j + TK < dh) {
        load_w2(j + TK, b ^ 1);
        load_bias(base + S::bias + (b ^ 1) * TK * 4, b1, j + TK);
      }
      wgmma::cp_commit();
      put_h(b, cur);
      start_wide<P, true>(acc, ha, base + S::w2 + b * S::chunk);  // y += h w2[chunk, :]
      settle(nxt, acc);
    };
    for (int j = 0; j < dh; j += 2 * TK) {
      step(j, pa, pb);
      if (j + TK < dh) step(j + TK, pb, pa);
    }
  } else {
    // d wider than one chunk: x and w1 streamed chunk by chunk, in buffer 0
    for (int j = 0; j < dh; j += TK) {
      float pre[32];
      wgmma::zero(pre);
      for (int c = 0; c < nd; ++c) {
        __syncthreads();  // every warpgroup is done with the previous pieces
        load_x(c);
        load_w1(j, c, 0);
        if (c == 0) {
          load_w2(j, 0);
          load_bias(base + S::bias, b1, j);
        }
        wgmma::cp_commit();
        copies_landed<false>();
        start_k_mn<P>(pre, xa, kTilePanel, base + S::w1);
        settle(pre);
      }
      put_h(0, pre);
      start_wide<P, true>(acc, ha, base + S::w2);
      settle(acc);
    }
  }

  T* yt = y + (row0 + 64 * wg) * dout + col0;
#pragma unroll
  for (int k = 0; k < W / 2; k += 2) {
    const int r = wgmma::frag_row(tw, k), c = wgmma::frag_col(tw, k);
    if (64 * wg + r < nrow && c < ncol) {
      store_pair(yt + static_cast<int64_t>(r) * dout + c, acc[k] + b2[col0 + c],
                 acc[k + 1] + b2[col0 + c + 1]);
    }
  }
}

template <typename T, int P>
int launch(const bf16* x, const bf16* w1, const float* b1, const bf16* w2, const float* b2, T* y,
           int N, int d, int dh, int dout, cudaStream_t stream) {
  constexpr int smem = FwdSmem<P>::bytes + 1024;  // + the swizzle alignment
  cudaFuncSetAttribute(mlp_fwd_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((N + TM - 1) / TM, (dout + 64 * P - 1) / (64 * P));
  mlp_fwd_kernel<T, P><<<grid, kThreads, smem, stream>>>(x, w1, b1, w2, b2, y, N, d, dh, dout);
  return static_cast<int>(cudaGetLastError());
}

// A check of the product forms kernels F and F' add to wgmma.cuh, for the
// tests: one warpgroup computes c (64 x N) = a (64 x 64) . b[:, :N] with a
// (64, 64) and b (64, 256) row-major bf16, c row-major float32, loading
// both into shared memory in the layout and descriptor form the kernels use
// for that product:
//   form 0: a K-major, b MN-major across N / 64 panels (F's y += h w2)
//   form 1: a K-major, b K-major, N rows of one panel (F''s dx += dh w1^T)
//   form 2: a MN-major, b MN-major across panels (F''s dw1^T, dw2)
// b's MN-major panels lie kTilePanel (16 KB) apart, so the panel stride the
// descriptor names is read.
template <int N, int TA, int TB>
__global__ void __launch_bounds__(128) wgmma_probe_kernel(const bf16* __restrict__ a,
                                                           const bf16* __restrict__ b,
                                                           float* __restrict__ c) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = wgmma::aligned_smem(smem_raw);
  uint8_t* sb = sa + kChunkPanel;
  const int tid = threadIdx.x;
  for (int q = tid; q < 64 * 64; q += 128) {
    const int m = q / 64, k = q % 64;
    *reinterpret_cast<bf16*>(sa + (TA ? wgmma::elem_offset(k, m) : wgmma::elem_offset(m, k))) =
        a[q];
  }
  for (int q = tid; q < 64 * N; q += 128) {
    const int k = q / N, n = q % N;
    const uint32_t off = TB ? (n / 64) * kTilePanel + wgmma::elem_offset(k, n % 64)
                            : wgmma::elem_offset(n, k);
    *reinterpret_cast<bf16*>(sb + off) = b[k * 256 + n];
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
    const uint64_t db = TB ? wgmma::desc_mn(ub + kk * 2 * wgmma::kGroupBytes, kTilePanel)
                           : wgmma::desc_k(ub + 32 * kk);
    wgmma::Mma<N, TA, TB>::run(acc, da, db);
  }
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(acc);
#pragma unroll
  for (int k = 0; k < N / 2; ++k)
    c[wgmma::frag_row(tid, k) * N + wgmma::frag_col(tid, k)] = acc[k];
}

template <int N, int TA, int TB>
int probe(const bf16* a, const bf16* b, float* c, cudaStream_t stream) {
  constexpr int smem = 1024 + kChunkPanel + 4 * kTilePanel;
  cudaFuncSetAttribute(wgmma_probe_kernel<N, TA, TB>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  wgmma_probe_kernel<N, TA, TB><<<1, 128, smem, stream>>>(a, b, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace MLP_NS

// x (N, d) and y (N, d_out) contiguous, both float32 (is_bf16 == 0) or both
// bfloat16; w1 (d, dh) and w2 (dh, d_out) contiguous bfloat16; b1 (dh,),
// b2 (d_out,) float32; xb: N d bfloat16 values of scratch for float32 x
// (null for bfloat16 x); every pointer 16-byte aligned. N, d, dh, d_out
// multiples of 64. Launches on `stream`, does not synchronise; returns the
// cudaError_t of the launches (0 on success).
extern "C" int hyena_mlp_fwd(const void* x, const void* w1, const float* b1, const void* w2,
                             const float* b2, void* y, void* xb, int N, int d, int dh, int dout,
                             int is_bf16, cudaStream_t stream) {
  using namespace MLP_NS;
  if (!valid_widths(N, d, dh, dout) || (!is_bf16 && xb == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* w1b = static_cast<const bf16*>(w1);
  const auto* w2b = static_cast<const bf16*>(w2);
  const bf16* xs = static_cast<const bf16*>(x);
  if (!is_bf16) {
    const int rc = round_bf16(static_cast<const float*>(x), static_cast<bf16*>(xb),
                              static_cast<int64_t>(N) * d, stream);
    if (rc != 0) return rc;
    xs = static_cast<const bf16*>(xb);
  }
  return with_panels(d, dout, [&](auto panels) {
    constexpr int P = decltype(panels)::value;
    if (is_bf16) return launch<bf16, P>(xs, w1b, b1, w2b, b2, static_cast<bf16*>(y), N, d, dh,
                                        dout, stream);
    return launch<float, P>(xs, w1b, b1, w2b, b2, static_cast<float*>(y), N, d, dh, dout,
                            stream);
  });
}

// mode m: form m / 3 (above) at N = 64 (2 + m % 3), m = 0..8. a (64, 64) and
// b (64, 256) bfloat16, c holds 64 x N floats. Returns the launch's
// cudaError_t.
extern "C" int hyena_mlp_wgmma_probe(const __nv_bfloat16* a, const __nv_bfloat16* b, float* c,
                                     int mode, cudaStream_t stream) {
  using namespace MLP_NS;
  switch (mode) {
    case 0: return probe<128, 0, 1>(a, b, c, stream);
    case 1: return probe<192, 0, 1>(a, b, c, stream);
    case 2: return probe<256, 0, 1>(a, b, c, stream);
    case 3: return probe<128, 0, 0>(a, b, c, stream);
    case 4: return probe<192, 0, 0>(a, b, c, stream);
    case 5: return probe<256, 0, 0>(a, b, c, stream);
    case 6: return probe<128, 1, 1>(a, b, c, stream);
    case 7: return probe<192, 1, 1>(a, b, c, stream);
    case 8: return probe<256, 1, 1>(a, b, c, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
