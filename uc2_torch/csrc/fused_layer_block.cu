// One whole post-LN encoder layer for inference, from the projected heads:
//   x2  = LayerNorm1(x + attention(q, k, v, bias) . Wo^T + bo)       (fp32)
//   out = LayerNorm2(gelu_erf(bf16(x2) . W1^T + b1) . W2^T + b2 + x2)
//
// Replaces the TPU kernel uc2_tpu/ops/fused_block.py:_layer_kernel
// (launched by fused_layer_block), which the reference runs only from its
// kernel lab (scripts/kernel_lab.py --mode layer): its gate,
// fused_layer_profitable, is always off. Rounding is the TPU kernel's: P
// rounded to bf16 after normalising, the context to Wo's dtype, the FFN's
// input bf16(x2), the GELU output to bf16, and the FFN's residual is x2 in
// fp32 (not the bf16 output of the attention block, as in #2 -> #3).
//
// What bounds it on an H100: operations. At (B, L) = (64, 162) the layer is
// 4 B 12 L^2 64 + 2 B L 768^2 + 4 B L 768 3072 = 115.2 GFLOP (0.117 ms at
// 989 TFLOP/s) against 90 MB of heads, x, weights and output (0.027 ms).
//
// Design (simple first, from #2 and #3's first design): one block of 8 warps per (tile of
// 32 query rows, batch row).
//   1. #2's body: attend_head (common.cuh) for each head into a [32, 768]
//      bf16 context tile, the out-projection into a [32, 768] fp32
//      accumulator in registers (96 columns a warp), + bo + x, LayerNorm1.
//      The normalised rows stay in the same registers in fp32 (x2), and
//      bf16(x2) is written over the context tile.
//   2. the mma.sync weight walk (ffn_block.cuh, 6-stage cp.async ring) on
//      that tile, with the accumulator seeded with x2 + b2: the walk's warp owns the
//      same 96 output columns as #2's out-projection, so the fp32 residual
//      never leaves the registers. Then LayerNorm2 and the bf16 store.
// attend_head's region (bias row, score rows, K/V) and the ring with its
// GELU tile are used one after the other and share shared memory; the
// ring's first tiles start loading under the out-projection. 166 KB at
// L <= 162, 192 KB at L = 512: one block per SM. Each block still streams
// all of Wo, W1 and W2 from L2 and runs mma.sync at 32 rows, which is
// what a faster version (wgmma, larger row tiles) would attack.
#include "ffn_block.cuh"

namespace uc2 {

static_assert(FFN_ROWS == 32 && FFN_WARPS == 8,
              "the attention half's tile and warps are the FFN walk's");

// [context / bf16(x2) tile][LayerNorm scratch][attend region | ring + GELU tile]
constexpr size_t LAYER_FIXED_BYTES = (size_t)FFN_ROWS * ROW_STRIDE * 2 + FFN_THREADS * 4;

inline size_t layer_smem_bytes(int L) {
  const size_t walk = (size_t)(STAGES * STAGE_ELEMS + FFN_ROWS * H_STRIDE) * 2;
  const size_t attend = attend_smem_bytes(FFN_ROWS, L);
  return LAYER_FIXED_BYTES + (attend > walk ? attend : walk);
}

template <int NC>
__global__ void __launch_bounds__(FFN_THREADS)
    fused_layer_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ bias,
                       const bf16* __restrict__ x, const bf16* __restrict__ wo,
                       const float* __restrict__ bo, const float* __restrict__ g1,
                       const float* __restrict__ be1, const bf16* __restrict__ w1,
                       const float* __restrict__ b1, const bf16* __restrict__ w2,
                       const float* __restrict__ b2, const float* __restrict__ g2,
                       const float* __restrict__ be2, bf16* __restrict__ out, int L,
                       int n, int rs, int F, float scale, float eps) {
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* tile = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(tile + FFN_ROWS * ROW_STRIDE);
  uint8_t* work = reinterpret_cast<uint8_t*>(red + FFN_THREADS);
  bf16* ring = reinterpret_cast<bf16*>(work);
  bf16* hs = ring + STAGES * STAGE_ELEMS;
  const int q0 = blockIdx.x * FFN_ROWS, b = blockIdx.y;
  const int rows = min(FFN_ROWS, L - q0);
  const size_t base = (size_t)b * L * rs;
  for (int h = 0; h < n; ++h) {
    const size_t hb = base + (size_t)h * HEAD_DIM;
    attend_head<FFN_WARPS, FFN_ROWS, NC>(q + hb, k + hb, v + hb, rs,
                                         bias + (size_t)b * L, L, q0, scale, work,
                                         tile + h * HEAD_DIM, ROW_STRIDE, FFN_ROWS);
  }
  __syncthreads();  // the attend region is free for the weight ring

  ffn_walk_prologue(ring, w1, w2, F);
  float acc[2][12][4];
  ctx_out_projection(tile, wo, acc);
  const size_t row0 = (size_t)b * L + q0;
  // acc = x2 (fp32), bf16(x2) over the context tile (every warp has read it
  // before the epilogue's first barrier)
  residual_layernorm<true, true, true>(acc, bo, x + row0 * HIDDEN, HIDDEN, g1, be1,
                                       eps, tile, rows, red, ROW_STRIDE);
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int col = out_col(warp, j) + t * 2;
      const float c0 = b2[col], c1 = b2[col + 1];
      acc[m][j][0] += c0;
      acc[m][j][1] += c1;
      acc[m][j][2] += c0;
      acc[m][j][3] += c1;
    }
  ffn_forward_walk(tile, hs, ring, w1, b1, w2, F, acc);
  residual_layernorm<false, false>(acc, nullptr, nullptr, 0, g2, be2, eps,
                                   out + row0 * HIDDEN, rows, red);
}

}  // namespace uc2

// q, k, v: [B, L, n, 64] bf16, tokens rs elements apart (n * 64 == 768);
// bias [B, L] fp32; x, out [B, L, 768] bf16 contiguous; wo [768, 768],
// w1 [F, 768], w2 [768, F] bf16 as nn.Linear stores them ([out, in]), F a
// multiple of 64; bo, g1, be1, b2, g2, be2 [768] and b1 [F] fp32;
// 1 <= L <= 512. Returns cudaGetLastError().
extern "C" int uc2_fused_layer_block(const void* q, const void* k, const void* v,
                                     const void* bias, const void* x, const void* wo,
                                     const void* bo, const void* g1, const void* be1,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, const void* g2, const void* be2,
                                     void* out, int B, int L, int n, int rs, int F,
                                     float scale, float eps, void* stream) {
  using namespace uc2;
  if (L < 1 || L > MAX_LEN || n * HEAD_DIM != HIDDEN || F < FFN_CHUNK || F % FFN_CHUNK)
    return (int)cudaErrorInvalidValue;
  const size_t smem = layer_smem_bytes(L);
  return with_score_chunks(L, [&](auto nc) {
    constexpr int NC = decltype(nc)::value;
    auto kernel = fused_layer_kernel<NC>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((L + FFN_ROWS - 1) / FFN_ROWS, B);
    kernel<<<grid, FFN_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const float*>(bias),
        static_cast<const bf16*>(x), static_cast<const bf16*>(wo),
        static_cast<const float*>(bo), static_cast<const float*>(g1),
        static_cast<const float*>(be1), static_cast<const bf16*>(w1),
        static_cast<const float*>(b1), static_cast<const bf16*>(w2),
        static_cast<const float*>(b2), static_cast<const float*>(g2),
        static_cast<const float*>(be2), static_cast<bf16*>(out), L, n, rs, F,
        scale, eps);
    return (int)cudaGetLastError();
  });
}
