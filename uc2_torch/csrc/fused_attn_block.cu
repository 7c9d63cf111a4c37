// Fused attention block for inference:
//   out = LayerNorm(x + attention(q, k, v, bias) . Wo^T + bo) * gamma + beta
//
// Replaces the TPU kernel uc2_tpu/ops/fused_block.py:_block_kernel
// (launched by fused_attn_block), which the encoder runs at joint length
// L >= 128 (the L = 128 and L = 162 retrieval buckets at uc2-base).
//
// What bounds it on an H100: bytes. At B = 64, L = 162, H = 768 it reads
// q, k, v and x and writes the output, 81 MB, against 17 GFLOP of products:
// about 24 us at 3.35 TB/s versus 18 us of bf16 tensor work. The design
// keeps the [rows, 768] context, the pre-LayerNorm sum and its statistics
// out of device memory. One block of 8 warps per (tile of 32 query rows,
// batch row) loops over the 12 heads: for each, attend_head (common.cuh)
// stages K and V^T in shared memory and writes the bf16 context of the head
// into a [32, 768] tile in shared memory. Then every warp multiplies the
// tile by its 96 rows of Wo (read from global memory; 1.2 MB, resident
// in L2) with mma.sync, keeps the fp32 sums in registers, adds bo and the
// residual x, and normalises each row with fp32 two-pass statistics reduced
// across the block. Each block re-reads K, V and Wo from L2; larger tiles
// or a cluster that shares them is the next step for speed.
#include "common.cuh"

namespace uc2 {

constexpr int BLOCK_WARPS = 8;
constexpr int BLOCK_ROWS = 32;

template <int NC>
__global__ void __launch_bounds__(BLOCK_WARPS * 32)
    fused_attn_block_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const float* __restrict__ bias,
                            const bf16* __restrict__ x, const bf16* __restrict__ wo,
                            const float* __restrict__ bo, const float* __restrict__ gamma,
                            const float* __restrict__ beta, bf16* __restrict__ out,
                            int L, int n, int rs, float scale, float eps) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int q0 = blockIdx.x * BLOCK_ROWS, b = blockIdx.y;
  const int rows = min(BLOCK_ROWS, L - q0);
  const size_t attend_bytes = attend_smem_bytes(BLOCK_ROWS, L);
  bf16* ctx = reinterpret_cast<bf16*>(smem + attend_bytes);
  float* red = reinterpret_cast<float*>(ctx + BLOCK_ROWS * ROW_STRIDE);
  const size_t base = (size_t)b * L * rs;
  for (int h = 0; h < n; ++h) {
    const size_t hb = base + (size_t)h * HEAD_DIM;
    attend_head<BLOCK_WARPS, BLOCK_ROWS, NC>(q + hb, k + hb, v + hb, rs,
                                         bias + (size_t)b * L, L, q0, scale, smem,
                                         ctx + h * HEAD_DIM, ROW_STRIDE, BLOCK_ROWS);
  }
  __syncthreads();

  // y = ctx . Wo^T: this warp's 96 output columns (out_col) for all 32 rows
  float acc[2][12][4];
  ctx_out_projection(ctx, wo, acc);
  const size_t row0 = (size_t)b * L + q0;
  residual_layernorm(acc, bo, x + row0 * HIDDEN, HIDDEN, gamma, beta, eps,
                     out + row0 * HIDDEN, rows, red);
}

}  // namespace uc2

// q, k, v: [B, L, n, 64] bf16, tokens rs elements apart (n * 64 == 768);
// bias [B, L] fp32; x, out [B, L, 768] bf16; wo [768, 768] bf16 as
// nn.Linear stores it ([out, in]); bo, gamma, beta [768] fp32.
// Returns cudaGetLastError().
extern "C" int uc2_fused_attn_block(const void* q, const void* k, const void* v,
                                    const void* bias, const void* x, const void* wo,
                                    const void* bo, const void* gamma,
                                    const void* beta, void* out, int B, int L,
                                    int n, int rs, float scale, float eps,
                                    void* stream) {
  using namespace uc2;
  const size_t smem = attend_smem_bytes(BLOCK_ROWS, L) +
                      (size_t)BLOCK_ROWS * ROW_STRIDE * 2 + BLOCK_WARPS * 32 * 4;
  return with_score_chunks(L, [&](auto nc) {
    constexpr int NC = decltype(nc)::value;
    auto kernel = fused_attn_block_kernel<NC>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((L + BLOCK_ROWS - 1) / BLOCK_ROWS, B);
    kernel<<<grid, BLOCK_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const float*>(bias),
        static_cast<const bf16*>(x), static_cast<const bf16*>(wo),
        static_cast<const float*>(bo), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<bf16*>(out), L, n, rs, scale, eps);
    return (int)cudaGetLastError();
  });
}
