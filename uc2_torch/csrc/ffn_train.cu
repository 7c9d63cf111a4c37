// Training FFN block with output dropout, forward (#9):
//   y = LayerNorm(dropout(gelu_erf(x . W1^T + b1) . W2^T + b2) + x) * gamma + beta
//
// Replaces the TPU kernel uc2_tpu/ops/ffn_train.py _fwd_kernel (launched
// by _ffn_train_fwd / fused_ffn_block_train), which every encoder layer
// runs in training under use_pallas_attention="pallas-train" with
// UC2_FFN_TRAIN=1. Its backward (#10) is ffn_train_bwd.cu.
//
// Dropout: the keep bit of output (row, col) is Philox4x32-10 of its
// global index (philox.cuh ffn_keep_bits4), never of a tile, so the
// forward and the backward draw the same mask though they tile differently
// (the TPU kernels had to share one row tile, _pick_tile, for that).
//
// The mma.sync weight walk (ffn_block.cuh, shared with #8), then y2 = keep
// ? (acc + b2) / (1 - rate) : 0 before the residual and the LayerNorm.
// Bound by operations: 4 rows H F (196 GFLOP at B = 128, L = 162: 0.198 ms
// at 989 TFLOP/s) against 73 MB.
#include "ffn_block.cuh"
#include "philox.cuh"

namespace uc2 {

struct FfnDropout {
  uint32_t seed;    // Philox key word 0
  uint32_t thresh;  // keep when bits >= thresh
  float scale;      // 1 / (1 - rate)
};

// keep bits of columns col, col + 1 (col even) of global row `row`: bits 0, 1
__device__ __forceinline__ uint32_t keep2(const FfnDropout& dr, int row, int col) {
  return (ffn_keep_bits4(dr.seed, dr.thresh, (uint32_t)col >> 2, (uint32_t)row) >>
          (col & 3)) & 3u;
}

// acc := dropout(acc + b2), acc[m][j] holding rows r0 + m*16 + g (+8) and
// columns out_col(warp, j) + 2t (+1) of the output
template <bool DROP>
__device__ __forceinline__ void bias_dropout(float (&acc)[2][12][4],
                                             const float* __restrict__ b2, int r0,
                                             const FfnDropout& dr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int col = out_col(warp, j) + t * 2;
      const float c0 = b2[col], c1 = b2[col + 1];
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float v0 = acc[m][j][2 * hi] + c0, v1 = acc[m][j][2 * hi + 1] + c1;
        if constexpr (DROP) {
          const uint32_t k = keep2(dr, r0 + m * 16 + g + 8 * hi, col);
          v0 = (k & 1u) ? v0 * dr.scale : 0.f;
          v1 = (k & 2u) ? v1 * dr.scale : 0.f;
        }
        acc[m][j][2 * hi] = v0;
        acc[m][j][2 * hi + 1] = v1;
      }
    }
}

// ------------------------------------------------------------ forward (#9)
template <bool DROP>
__global__ void __launch_bounds__(FFN_THREADS)
    ffn_train_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                         const float* __restrict__ b1, const bf16* __restrict__ w2,
                         const float* __restrict__ b2, const float* __restrict__ gamma,
                         const float* __restrict__ beta, bf16* __restrict__ out,
                         int n_rows, int F, float eps, FfnDropout dr) {
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* hs = xs + FFN_ROWS * ROW_STRIDE;
  bf16* ring = hs + FFN_ROWS * H_STRIDE;
  float* red = reinterpret_cast<float*>(ring + STAGES * STAGE_ELEMS);
  const int r0 = blockIdx.x * FFN_ROWS;
  const int rows = min(FFN_ROWS, n_rows - r0);

  ffn_walk_prologue(ring, w1, w2, F);
  stage_rows(xs, x, r0, rows);
  float acc[2][12][4];
  ffn_forward_walk(xs, hs, ring, w1, b1, w2, F, acc);
  bf16* o = out + (size_t)r0 * HIDDEN;
  if constexpr (DROP) {
    bias_dropout<true>(acc, b2, r0, dr);
    residual_layernorm<false>(acc, b2, xs, ROW_STRIDE, gamma, beta, eps, o, rows, red);
  } else {
    residual_layernorm(acc, b2, xs, ROW_STRIDE, gamma, beta, eps, o, rows, red);
  }
}

}  // namespace uc2

// x, out: [rows, 768] bf16; w1 [F, 768] and w2 [768, F] bf16 ([out, in]),
// F a multiple of 128; b1 [F], b2, gamma, beta [768] fp32. drop = 0 skips
// the mask (rate 0). Returns cudaGetLastError().
extern "C" int uc2_ffn_train_fwd(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* gamma,
                                 const void* beta, void* out, int rows, int F, float eps,
                                 unsigned seed, unsigned thresh, float keep_scale, int drop,
                                 void* stream) {
  using namespace uc2;
  const FfnDropout dr{seed, thresh, keep_scale};
  auto run = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FFN_SMEM);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(rows + FFN_ROWS - 1) / FFN_ROWS, FFN_THREADS, FFN_SMEM,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
        static_cast<const float*>(b1), static_cast<const bf16*>(w2),
        static_cast<const float*>(b2), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<bf16*>(out), rows, F, eps, dr);
    return (int)cudaGetLastError();
  };
  return drop ? run(ffn_train_fwd_kernel<true>) : run(ffn_train_fwd_kernel<false>);
}
