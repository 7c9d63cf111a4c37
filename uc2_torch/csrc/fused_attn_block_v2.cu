// Fused attention block with the QKV projection inside the kernel:
//   q_h, k_h, v_h = bf16(x . W_h^T + b_h)          (bias added in fp32)
//   out = LayerNorm(x + sum_h attention(q_h, k_h, v_h, bias) . Wo_h^T + bo)
//
// Replaces the TPU kernel uc2_tpu/ops/fused_block.py:_block2_kernel
// (launched by fused_attn_block_v2), which the reference's encoder runs on
// the fused inference route (L >= 128 under "pallas", every L under
// "fused-force") when UC2_ATTN_V2 is set. Its point there is that the
// [B, L, 3H] projection never reaches device memory.
//
// Rounding is #7's, not the eager chain's: the projection's fp32 sum gets
// its fp32 bias before the bf16 rounding (the eager Dense rounds first).
// The rest is fused_attn_block.cu's (#2): fp32 scores * scale + bias, fp32
// softmax, P rounded to bf16 after normalising, the bf16 context of each
// head times its 64 rows of Wo summed in fp32, + bo + x, two-pass LN.
//
// Design (simple first): one block of 8 warps per (32 query rows, batch
// row), shared memory as #2's (bias row, 32 fp32 score rows, one [Lp, 64]
// region, the [32, 768] context tile; 192 KB at L = 512). For each head:
//   1. Q_h of the tile's 32 rows, projected into the head's 64 columns of
//      the context tile (free until the head's context lands there), and
//      K_h of all L rows projected into the K/V region; A fragments of x
//      and B fragments of the weights come from device memory (L2);
//   2. scores and softmax as attend_head (common.cuh);
//   3. V_h of all rows projected into the same region, transposed;
//   4. P . V_h into the head's context columns.
// Then the out-projection and residual_layernorm exactly as #2.
//
// What bounds it on an H100: operations. At (B, L) = (64, 162) the block
// needs 2 B L 768 3072 + 4 B 12 L^2 64 = 54.1 GFLOP (0.055 ms at 989
// TFLOP/s) against 32 MB of x and output. The price of this design: each
// query tile recomputes K_h and V_h for the whole row, ceil(L / 32) = 6
// times at L = 162 (about 2.7x the block's products), all through
// mma.sync with operands read from L2. Sharing the projection across a
// row's tiles (a cluster, or larger tiles) is later work.
#include "common.cuh"

namespace uc2 {

constexpr int V2_WARPS = 8;
constexpr int V2_ROWS = 32;

// acc[mi][j] (+)= X . W^T over the HIDDEN inputs for the m-tiles mt[mi]
// (rows 16 mt + g and + 8 of x, read as 0 past L) and the 64 outputs of
// one head's section of the weights: w points at its first [HIDDEN] row;
// n-tile j is output columns 8 j .. 8 j + 7.
template <int MI>
__device__ __forceinline__ void project_rows(float (&acc)[MI][8][4],
                                             const bf16* __restrict__ x, int L,
                                             const int (&mt)[MI],
                                             const bf16* __restrict__ w) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
  for (int ks = 0; ks < HIDDEN / 16; ++ks) {
    const int c = ks * 16 + t * 2;
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int r0 = mt[mi] * 16 + g, r1 = r0 + 8;
      a[mi][0] = r0 < L ? ldg32(x + (size_t)r0 * HIDDEN + c) : 0u;
      a[mi][1] = r1 < L ? ldg32(x + (size_t)r1 * HIDDEN + c) : 0u;
      a[mi][2] = r0 < L ? ldg32(x + (size_t)r0 * HIDDEN + c + 8) : 0u;
      a[mi][3] = r1 < L ? ldg32(x + (size_t)r1 * HIDDEN + c + 8) : 0u;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bf16* wr = w + (size_t)(j * 8 + g) * HIDDEN + c;
      const uint32_t b0 = ldg32(wr), b1 = ldg32(wr + 8);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) mma16816(acc[mi][j], a[mi], b0, b1);
    }
  }
}

// K_h (TRANSPOSE false: [Lp][K_STRIDE]) or V_h^T (TRANSPOSE true:
// [HEAD_DIM][vt_stride(Lp)]) of every row of x into dst, as
// bf16(x . W_h^T + b_h). Warp w takes the m-tiles w, w + 8 (together),
// w + 16, w + 24 and so on.
template <bool TRANSPOSE>
__device__ void project_head(const bf16* __restrict__ x, int L,
                             const bf16* __restrict__ w, const float* __restrict__ bh,
                             bf16* dst) {
  const int Lp = padded_len(L), n_mt = Lp / 16, VS = vt_stride(Lp);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto store = [&](const float (&acc)[8][4], int mtile) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + t * 2;
      const float b0 = bh[col], b1 = bh[col + 1];
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = mtile * 16 + g + 8 * hi;
        const float v0 = acc[j][2 * hi] + b0, v1 = acc[j][2 * hi + 1] + b1;
        if (TRANSPOSE) {
          dst[col * VS + r] = __float2bfloat16(v0);
          dst[(col + 1) * VS + r] = __float2bfloat16(v1);
        } else {
          *reinterpret_cast<uint32_t*>(dst + r * K_STRIDE + col) = pack2(v0, v1);
        }
      }
    }
  };
  for (int mt0 = warp; mt0 < n_mt; mt0 += 2 * V2_WARPS) {
    if (mt0 + V2_WARPS < n_mt) {
      const int mt[2] = {mt0, mt0 + V2_WARPS};
      float acc[2][8][4];
      project_rows<2>(acc, x, L, mt, w);
      store(acc[0], mt[0]);
      store(acc[1], mt[1]);
    } else {
      const int mt[1] = {mt0};
      float acc[1][8][4];
      project_rows<1>(acc, x, L, mt, w);
      store(acc[0], mt0);
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(V2_WARPS * 32)
    fused_attn_block_v2_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_qkv,
                               const float* __restrict__ b_qkv, const float* __restrict__ bias,
                               const bf16* __restrict__ wo, const float* __restrict__ bo,
                               const float* __restrict__ gamma, const float* __restrict__ beta,
                               bf16* __restrict__ out, int L, int n, float scale, float eps) {
  constexpr int QT = V2_ROWS, MT = QT / 16, WPM = V2_WARPS / MT;
  extern __shared__ __align__(16) uint8_t smem[];
  const int q0 = blockIdx.x * QT, b = blockIdx.y;
  const int rows = min(QT, L - q0);
  const int Lp = padded_len(L), SF = score_stride(Lp);
  const AttnSmem sm = attn_smem(smem, Lp, QT);
  bf16* ctx = reinterpret_cast<bf16*>(smem + attend_smem_bytes(QT, L));
  float* red = reinterpret_cast<float*>(ctx + QT * ROW_STRIDE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* xb = x + (size_t)b * L * HIDDEN;
  const bf16* xq = xb + (size_t)q0 * HIDDEN;   // the tile's rows

  for (int i = tid; i < Lp; i += V2_WARPS * 32)
    sm.bias[i] = i < L ? bias[(size_t)b * L + i] : -INFINITY;

  for (int h = 0; h < n; ++h) {
    const bf16* wq = w_qkv + (size_t)(h * HEAD_DIM) * HIDDEN;
    const bf16* wk = wq + (size_t)HIDDEN * HIDDEN;
    const bf16* wv = wk + (size_t)HIDDEN * HIDDEN;
    const float* bq = b_qkv + h * HEAD_DIM;
    __syncthreads();  // the previous head's readers of K/V and S are done

    // 1. Q_h of the tile into ctx[:, 64 h ..]: m-tile warp & 1, n-tiles
    //    2 (warp >> 1) and + 1; then K_h of every row
    {
      const int m = warp & 1, j0 = (warp >> 1) * 2;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const int r0 = m * 16 + g, r1 = r0 + 8;
      for (int ks = 0; ks < HIDDEN / 16; ++ks) {
        const int c = ks * 16 + t * 2;
        uint32_t a[4];
        a[0] = r0 < rows ? ldg32(xq + (size_t)r0 * HIDDEN + c) : 0u;
        a[1] = r1 < rows ? ldg32(xq + (size_t)r1 * HIDDEN + c) : 0u;
        a[2] = r0 < rows ? ldg32(xq + (size_t)r0 * HIDDEN + c + 8) : 0u;
        a[3] = r1 < rows ? ldg32(xq + (size_t)r1 * HIDDEN + c + 8) : 0u;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const bf16* wr = wq + (size_t)((j0 + jj) * 8 + g) * HIDDEN + c;
          mma16816(acc[jj], a, ldg32(wr), ldg32(wr + 8));
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = (j0 + jj) * 8 + t * 2;
        const float b0 = bq[col], b1 = bq[col + 1];
        bf16* cq = ctx + h * HEAD_DIM + col;
        *reinterpret_cast<uint32_t*>(cq + r0 * ROW_STRIDE) = pack2(acc[jj][0] + b0, acc[jj][1] + b1);
        *reinterpret_cast<uint32_t*>(cq + r1 * ROW_STRIDE) = pack2(acc[jj][2] + b0, acc[jj][3] + b1);
      }
    }
    project_head<false>(xb, L, wk, bq + HIDDEN, sm.KV);
    __syncthreads();

    // 2. scores of the tile's rows: m-tile warp % MT, every WPM-th key tile
    {
      const int m = warp % MT, wj = warp / MT;
      uint32_t qa[HEAD_DIM / 16][4];
      const bf16* qr = ctx + (m * 16 + g) * ROW_STRIDE + h * HEAD_DIM + t * 2;
#pragma unroll
      for (int ks = 0; ks < HEAD_DIM / 16; ++ks) {
        qa[ks][0] = ld32(qr + ks * 16);
        qa[ks][1] = ld32(qr + 8 * ROW_STRIDE + ks * 16);
        qa[ks][2] = ld32(qr + ks * 16 + 8);
        qa[ks][3] = ld32(qr + 8 * ROW_STRIDE + ks * 16 + 8);
      }
      for (int j = wj; j < Lp / 8; j += WPM) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < HEAD_DIM / 16; ++ks) {
          const bf16* kr = sm.KV + (j * 8 + g) * K_STRIDE + ks * 16 + t * 2;
          mma16816(c, qa[ks], ld32(kr), ld32(kr + 8));
        }
        const int key = j * 8 + t * 2;
        const float b0 = sm.bias[key], b1 = sm.bias[key + 1];
        float* s0 = sm.S + (m * 16 + g) * SF + key;
        *reinterpret_cast<float2*>(s0) = make_float2(c[0] * scale + b0, c[1] * scale + b1);
        *reinterpret_cast<float2*>(s0 + 8 * SF) = make_float2(c[2] * scale + b0, c[3] * scale + b1);
      }
    }
    __syncthreads();

    // 3. softmax rows (S only), then V_h^T over K (no one reads K any more)
    attn_softmax<V2_WARPS, QT, NC>(L, smem);
    project_head<true>(xb, L, wv, bq + 2 * HIDDEN, sm.KV);
    __syncthreads();

    // 4. the head's context over its Q_h columns
    attn_pv_product<V2_WARPS, QT>(L, smem, ctx + h * HEAD_DIM, ROW_STRIDE, QT);
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

// x, out: [B, L, 768] bf16 contiguous; w_qkv [2304, 768] bf16 as
// nn.Linear stores it (rows of q, then k, then v; head h's 64 rows at
// 64 h of each); b_qkv [2304], bias [B, L], bo, gamma, beta [768] fp32;
// wo [768, 768] bf16 ([out, in]); n * 64 == 768, 1 <= L <= 512.
// Returns cudaGetLastError().
extern "C" int uc2_fused_attn_block_v2(const void* x, const void* w_qkv, const void* b_qkv,
                                       const void* bias, const void* wo, const void* bo,
                                       const void* gamma, const void* beta, void* out,
                                       int B, int L, int n, float scale, float eps,
                                       void* stream) {
  using namespace uc2;
  if (L < 1 || L > MAX_LEN || n * HEAD_DIM != HIDDEN) return (int)cudaErrorInvalidValue;
  const size_t smem = attend_smem_bytes(V2_ROWS, L) +
                      (size_t)V2_ROWS * ROW_STRIDE * 2 + V2_WARPS * 32 * 4;
  return with_score_chunks(L, [&](auto nc) {
    constexpr int NC = decltype(nc)::value;
    auto kernel = fused_attn_block_v2_kernel<NC>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((L + V2_ROWS - 1) / V2_ROWS, B);
    kernel<<<grid, V2_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w_qkv),
        static_cast<const float*>(b_qkv), static_cast<const float*>(bias),
        static_cast<const bf16*>(wo), static_cast<const float*>(bo),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<bf16*>(out), L, n, scale, eps);
    return (int)cudaGetLastError();
  });
}
