// Fused FFN block for inference:
//   out = LayerNorm(gelu_erf(x . W1^T + b1) . W2^T + b2 + x) * gamma + beta
//
// Replaces the TPU kernel uc2_tpu/ops/fused_block.py:_ffn_kernel (launched
// by fused_ffn_block), which the encoder runs in every layer at every
// joint length.
//
// What bounds it on an H100: operations. At B = 64, L = 162, H = 768,
// F = 3072 the two products are 98 GFLOP against 41 MB of x, weights and
// output: about 99 us of bf16 tensor work versus 12 us at 3.35 TB/s. The
// property kept from the TPU kernel is that the [rows, 3072] intermediate
// never reaches device memory. One block of 8 warps per tile of 32 rows
// keeps x in shared memory and walks F in chunks of 64: the chunk's
// x . W1^T (mma.sync, fp32) gets b1 and the exact erf GELU, is rounded to
// bf16 (where the TPU kernel rounds) into a [32, 64] shared tile, and is
// multiplied at once by the chunk's columns of W2 into fp32 accumulators
// that stay in registers (96 output columns per warp) for the whole walk.
// b2, the residual and the LayerNorm are applied from those registers.
// The weights stream through shared memory as a sequence of 16 KB tiles
// (per chunk: six [64 x 128] slices of W1, then six [128 x 64] slices of
// W2) in a ring of STAGES buffers filled by cp.async, so that the loads of
// the next tiles overlap the products on this one and every warp reads
// each tile. Each block still streams all of W1 and W2 (9.4 MB) from L2;
// the 32-row tile is what the register-resident [32, 768] accumulator
// allows, and a larger one (wgmma, accumulators split across warpgroups
// or clusters sharing tiles) is the next step for speed. The walk itself is
// in ffn_block.cuh, shared with the training FFN kernels (ffn_train.cu).
#include "ffn_block.cuh"

namespace uc2 {

__global__ void __launch_bounds__(FFN_THREADS)
    fused_ffn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                     const float* __restrict__ b1, const bf16* __restrict__ w2,
                     const float* __restrict__ b2, const float* __restrict__ gamma,
                     const float* __restrict__ beta, bf16* __restrict__ out,
                     int n_rows, int F, float eps) {
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* hs = xs + FFN_ROWS * ROW_STRIDE;
  bf16* ring = hs + FFN_ROWS * H_STRIDE;
  float* red = reinterpret_cast<float*>(ring + STAGES * STAGE_ELEMS);
  const int r0 = blockIdx.x * FFN_ROWS;
  const int rows = min(FFN_ROWS, n_rows - r0);

  // the first STAGES - 1 weight tiles start loading while x is staged
  ffn_walk_prologue(ring, w1, w2, F);
  stage_rows(xs, x, r0, rows);
  float acc[2][12][4];
  ffn_forward_walk<false>(xs, hs, ring, w1, b1, w2, F, acc, nullptr, 0);
  residual_layernorm(acc, b2, xs, ROW_STRIDE, gamma, beta, eps,
                     out + (size_t)r0 * HIDDEN, rows, red);
}

}  // namespace uc2

// x, out: [rows, 768] bf16; w1 [F, 768] and w2 [768, F] bf16 as nn.Linear
// stores them ([out, in]), F a multiple of 64; b1 [F], b2, gamma, beta
// [768] fp32. Returns cudaGetLastError().
extern "C" int uc2_fused_ffn_block(const void* x, const void* w1, const void* b1,
                                   const void* w2, const void* b2, const void* gamma,
                                   const void* beta, void* out, int rows, int F,
                                   float eps, void* stream) {
  using namespace uc2;
  cudaError_t err = cudaFuncSetAttribute(
      fused_ffn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FFN_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((rows + FFN_ROWS - 1) / FFN_ROWS);
  fused_ffn_kernel<<<grid, FFN_THREADS, FFN_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(out), rows, F, eps);
  return (int)cudaGetLastError();
}
