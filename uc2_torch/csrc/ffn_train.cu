// Training FFN block with output dropout, forward (#9) and backward (#10):
//   y = LayerNorm(dropout(gelu_erf(x . W1^T + b1) . W2^T + b2) + x) * gamma + beta
//
// Replace the TPU kernels uc2_tpu/ops/ffn_train.py _fwd_kernel (launched by
// _ffn_train_fwd / fused_ffn_block_train) and _bwd_kernel (launched by
// _ffn_train_bwd), which every encoder layer runs in training under
// use_pallas_attention="pallas-train" with UC2_FFN_TRAIN=1.
//
// Dropout: the keep bit of output (row, col) is Philox4x32-10 of its
// global index (philox.cuh ffn_keep_bits4), never of a tile, so the
// forward and the backward draw the same mask though they tile differently
// (the TPU kernels had to share one row tile, _pick_tile, for that).
//
// Forward (#9): the mma.sync weight walk (ffn_block.cuh, shared with #8),
// then y2 = keep ? (acc + b2) / (1 - rate) : 0 before the residual and the
// LayerNorm. Bound by operations: 4 rows H F (196 GFLOP at B = 128,
// L = 162: 0.198 ms at 989 TFLOP/s) against 73 MB.
//
// Backward (#10): the TPU kernel walks its row tiles in sequence and sums
// dW1, dW2 and the vector gradients in VMEM-resident fp32 outputs. A GPU
// grid runs its blocks in no order, and fp32 atomics would make a step
// unrepeatable, so the backward is three passes without atomics:
//  A. one block per 32 rows repeats the forward walk (writing the bf16 GELU
//     output h, [rows, F]), the LN statistics and the mask; forms
//     dy_pre = inv (dyn - mean(dyn) - yhat mean(dyn yhat)) and
//     dy2 = keep ? dy_pre / (1 - rate) : 0 (bf16, [rows, H]); then walks F
//     again: a = x W1^T + b1, dh = dy2 W2, da = dh gelu'(a) (bf16,
//     [rows, F]) and dx = dy_pre + da W1, accumulated in registers. The
//     tile's column sums of dgamma, dbeta, db2 and db1 go to partial rows.
//  B. dW1 = da^T x and dW2 = dy2^T h in [128 x 128] output tiles, each block
//     summing the rows of one of `groups` fixed row groups into its own fp32
//     partial; ldmatrix.trans feeds both operands from their row-major
//     tiles.
//  C. every gradient is the sum of its partials, in a fixed order.
// The TPU kernel keeps nothing F-sized in HBM; pass A writes h and da
// (2 rows F bytes each: 127 MB apiece at 20736 rows), which keeps pass B a
// plain product. Bound by operations: the TPU kernel's count, 12 rows H F
// (587 GFLOP, 0.594 ms at 20736 rows); these passes run 14 rows H F (seven
// products: five in A, two in B).
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
  ffn_forward_walk<false>(xs, hs, ring, w1, b1, w2, F, acc, nullptr, 0);
  bf16* o = out + (size_t)r0 * HIDDEN;
  if constexpr (DROP) {
    bias_dropout<true>(acc, b2, r0, dr);
    residual_layernorm<false>(acc, b2, xs, ROW_STRIDE, gamma, beta, eps, o, rows, red);
  } else {
    residual_layernorm(acc, b2, xs, ROW_STRIDE, gamma, beta, eps, o, rows, red);
  }
}

// ------------------------------------------------- backward (#10), pass A
// per chunk: the forward walk's 12 tiles, then its six W1 tiles again
constexpr int BWD_CHUNK_TILES = CHUNK_TILES + W1_TILES;
constexpr size_t BWD_SMEM =
    (size_t)(2 * FFN_ROWS * ROW_STRIDE + FFN_ROWS * H_STRIDE + STAGES * STAGE_ELEMS) * 2 +
    2 * FFN_THREADS * 4;
static_assert(BWD_SMEM <= 232448, "pass A shared memory");

__device__ __forceinline__ void load_bwd_tile(bf16* stage, const bf16* __restrict__ w1,
                                              const bf16* __restrict__ w2, int F, int idx) {
  const int c = idx / BWD_CHUNK_TILES, r = idx % BWD_CHUNK_TILES;
  load_tile(stage, w1, w2, F, c * CHUNK_TILES + (r < CHUNK_TILES ? r : r - CHUNK_TILES));
}

// Totals over the block's HIDDEN columns of NQ per-row quantities:
// part[q][m][hi] holds this thread's share of row m*16 + g + 8hi and
// becomes the row's total (summed in a fixed order). red: NQ * 256 floats.
template <int NQ>
__device__ __forceinline__ void row_totals(float (&part)[NQ][2][2], float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float v = part[q][m][hi];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) red[q * 256 + warp * 32 + m * 16 + g + 8 * hi] = v;
      }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < FFN_WARPS; ++w) s += red[q * 256 + w * 32 + m * 16 + g + 8 * hi];
        part[q][m][hi] = s;
      }
  __syncthreads();
}

// column total over the 8 row groups of a warp (lanes t, t + 4, ..);
// lanes 0..3 hold it
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// d/da [a Phi(a)] = Phi(a) + a phi(a)
__device__ __forceinline__ float dgelu_erf(float a) {
  return 0.5f * (1.f + erff(a * 0.70710678118654752f)) +
         a * expf(-0.5f * a * a) * 0.39894228040143268f;
}

// x, dy: [n_rows, HIDDEN]; writes dx and, for pass B, h and da ([n_rows, F])
// and dy2 ([n_rows, HIDDEN]); part_b1 [2 * tiles, F] (one row per 16-row
// half tile), part_vec [3, tiles, HIDDEN] (db2, dgamma, dbeta).
template <bool DROP>
__global__ void __launch_bounds__(FFN_THREADS)
    ffn_train_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                              const float* __restrict__ b1, const bf16* __restrict__ w2,
                              const float* __restrict__ b2, const float* __restrict__ gamma,
                              const bf16* __restrict__ dy, bf16* __restrict__ dx,
                              bf16* __restrict__ h_out, bf16* __restrict__ dy2_out,
                              bf16* __restrict__ da_out, float* __restrict__ part_b1,
                              float* __restrict__ part_vec, int n_rows, int F, float eps,
                              FfnDropout dr) {
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* dys = xs + FFN_ROWS * ROW_STRIDE;
  bf16* hs = dys + FFN_ROWS * ROW_STRIDE;
  bf16* ring = hs + FFN_ROWS * H_STRIDE;
  float* red = reinterpret_cast<float*>(ring + STAGES * STAGE_ELEMS);
  const int tile = blockIdx.x, r0 = tile * FFN_ROWS;
  const int rows = min(FFN_ROWS, n_rows - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (F / FFN_CHUNK) * BWD_CHUNK_TILES;

  // 1. the forward again, then y = dropout(acc + b2) + x, its LN
  //    statistics, and acc := yhat
  ffn_walk_prologue(ring, w1, w2, F);
  stage_rows(xs, x, r0, rows);
  float acc[2][12][4];
  ffn_forward_walk<true>(xs, hs, ring, w1, b1, w2, F, acc, h_out + (size_t)r0 * F, rows);
  __syncthreads();  // every warp is done with the ring: the second walk starts loading
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) load_bwd_tile(ring + i * STAGE_ELEMS, w1, w2, F, i);
    cp_async_commit();
  }
  bias_dropout<DROP>(acc, b2, r0, dr);
  float st[1][2][2] = {{{0.f, 0.f}, {0.f, 0.f}}};
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int col = out_col(warp, j) + t * 2;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const float2 xr = unpack2(xs + (m * 16 + g + 8 * hi) * ROW_STRIDE + col);
        acc[m][j][2 * hi] += xr.x;
        acc[m][j][2 * hi + 1] += xr.y;
        st[0][m][hi] += acc[m][j][2 * hi] + acc[m][j][2 * hi + 1];
      }
    }
  row_totals<1>(st, red);
  float mean[2][2], rstd[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      mean[m][hi] = st[0][m][hi] / HIDDEN;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const float d0 = acc[m][j][2 * hi] - mean[m][hi];
        const float d1 = acc[m][j][2 * hi + 1] - mean[m][hi];
        v += d0 * d0 + d1 * d1;
      }
      st[0][m][hi] = v;
    }
  row_totals<1>(st, red);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      rstd[m][hi] = rsqrtf(st[0][m][hi] / HIDDEN + eps);
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        acc[m][j][2 * hi] = (acc[m][j][2 * hi] - mean[m][hi]) * rstd[m][hi];
        acc[m][j][2 * hi + 1] = (acc[m][j][2 * hi + 1] - mean[m][hi]) * rstd[m][hi];
      }
    }

  // 2. the tile's dgamma and dbeta; the row sums of dyn = dy gamma and
  //    dyn yhat (rows past n_rows have dy = 0, so they add nothing)
  float* p_db2 = part_vec + (size_t)tile * HIDDEN;
  float* p_dg = p_db2 + (size_t)gridDim.x * HIDDEN;
  float* p_dbeta = p_dg + (size_t)gridDim.x * HIDDEN;
  float s[2][2][2] = {{{0.f, 0.f}, {0.f, 0.f}}, {{0.f, 0.f}, {0.f, 0.f}}};
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const int col = out_col(warp, j) + t * 2;
    const float g0 = gamma[col], g1 = gamma[col + 1];
    float cg0 = 0.f, cg1 = 0.f, cb0 = 0.f, cb1 = 0.f;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = m * 16 + g + 8 * hi;
        const float2 d = r < rows ? unpack2(dy + (size_t)(r0 + r) * HIDDEN + col)
                                  : make_float2(0.f, 0.f);
        const float y0 = acc[m][j][2 * hi], y1 = acc[m][j][2 * hi + 1];
        cg0 += d.x * y0;
        cg1 += d.y * y1;
        cb0 += d.x;
        cb1 += d.y;
        const float n0 = d.x * g0, n1 = d.y * g1;
        s[0][m][hi] += n0 + n1;
        s[1][m][hi] += n0 * y0 + n1 * y1;
      }
    cg0 = group_sum(cg0);
    cg1 = group_sum(cg1);
    cb0 = group_sum(cb0);
    cb1 = group_sum(cb1);
    if (g == 0) {
      *reinterpret_cast<float2*>(p_dg + col) = make_float2(cg0, cg1);
      *reinterpret_cast<float2*>(p_dbeta + col) = make_float2(cb0, cb1);
    }
  }
  row_totals<2>(s, red);

  // 3. dy_pre (left in acc: dx starts from it), dy2 = keep ? dy_pre /
  //    (1 - rate) : 0 rounded to bf16 into dys and dy2_out, the tile's db2
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const int col = out_col(warp, j) + t * 2;
    const float g0 = gamma[col], g1 = gamma[col + 1];
    float c0 = 0.f, c1 = 0.f;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = m * 16 + g + 8 * hi;
        const float2 d = r < rows ? unpack2(dy + (size_t)(r0 + r) * HIDDEN + col)
                                  : make_float2(0.f, 0.f);
        const float mn = s[0][m][hi] / HIDDEN, mny = s[1][m][hi] / HIDDEN;
        const float p0 = rstd[m][hi] * (d.x * g0 - mn - acc[m][j][2 * hi] * mny);
        const float p1 = rstd[m][hi] * (d.y * g1 - mn - acc[m][j][2 * hi + 1] * mny);
        float q0 = p0, q1 = p1;
        if constexpr (DROP) {
          const uint32_t k = keep2(dr, r0 + r, col);
          q0 = (k & 1u) ? p0 * dr.scale : 0.f;
          q1 = (k & 2u) ? p1 * dr.scale : 0.f;
        }
        c0 += q0;
        c1 += q1;
        const uint32_t qb = pack2(q0, q1);
        *reinterpret_cast<uint32_t*>(dys + r * ROW_STRIDE + col) = qb;
        if (r < rows)
          *reinterpret_cast<uint32_t*>(dy2_out + (size_t)(r0 + r) * HIDDEN + col) = qb;
        acc[m][j][2 * hi] = p0;
        acc[m][j][2 * hi + 1] = p1;
      }
    c0 = group_sum(c0);
    c1 = group_sum(c1);
    if (g == 0) *reinterpret_cast<float2*>(p_db2 + col) = make_float2(c0, c1);
  }

  // 4. the second walk, per chunk of 64 intermediate columns: a = x W1^T
  //    (tiles 0-5, as the forward), dh = dy2 W2 (6-11), then da = dh
  //    gelu'(a + b1) and dx += da W1 (12-17). The dh and dx products read
  //    their W2 and W1 tiles k-major, through ldmatrix.trans.
  float hacc[2][4], dacc[2][4];
  const uint32_t* Xw = reinterpret_cast<const uint32_t*>(xs);
  const uint32_t* Dw = reinterpret_cast<const uint32_t*>(dys);
  const uint32_t* Hw = reinterpret_cast<const uint32_t*>(hs);
  constexpr int XW = ROW_STRIDE / 2, HWS = H_STRIDE / 2, T1 = W1_STRIDE / 2;
  const int m1 = warp & 1, jp = (warp >> 1) * 2;
  const int xa = (m1 * 16 + g) * XW, xb = xa + 8 * XW;
  const int q = lane >> 3, qi = lane & 7;  // ldmatrix: this lane's tile and row

  for (int idx = 0; idx < n_tiles; ++idx) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile idx landed
    __syncthreads();              // everyone's did (and dys is complete)
    if (idx + STAGES - 1 < n_tiles)
      load_bwd_tile(ring + ((idx + STAGES - 1) % STAGES) * STAGE_ELEMS, w1, w2, F,
                    idx + STAGES - 1);
    cp_async_commit();
    const bf16* T = ring + (idx % STAGES) * STAGE_ELEMS;
    const uint32_t* Tw = reinterpret_cast<const uint32_t*>(T);
    const int c = idx / BWD_CHUNK_TILES, r = idx % BWD_CHUNK_TILES;
    if (r < W1_TILES) {
      if (r == 0) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          hacc[p][0] = hacc[p][1] = hacc[p][2] = hacc[p][3] = 0.f;
          dacc[p][0] = dacc[p][1] = dacc[p][2] = dacc[p][3] = 0.f;
        }
      }
#pragma unroll
      for (int ks = 0; ks < K_SLICE / 16; ++ks) {
        const int xk = r * (K_SLICE / 2) + ks * 8 + t;
        const uint32_t a[4] = {Xw[xa + xk], Xw[xb + xk], Xw[xa + xk + 4], Xw[xb + xk + 4]};
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint32_t* br = Tw + ((jp + p) * 8 + g) * T1 + ks * 8 + t;
          mma16816(hacc[p], a, br[0], br[4]);
        }
      }
    } else if (r < CHUNK_TILES) {
      // dh += dy2[:, 128s .. 128s + 128) . W2 tile s ([128 outputs][64 chunk columns])
      const int s2 = r - W1_TILES;
#pragma unroll
      for (int ks = 0; ks < N_SLICE / 16; ++ks) {
        const int dk = s2 * (N_SLICE / 2) + ks * 8 + t;
        const uint32_t a[4] = {Dw[xa + dk], Dw[xb + dk], Dw[xa + dk + 4], Dw[xb + dk + 4]};
        uint32_t b[4];
        ldsm_x4_trans(b, T + (ks * 16 + (q & 1) * 8 + qi) * W2_STRIDE + (jp + (q >> 1)) * 8);
        mma16816(dacc[0], a, b[0], b[1]);
        mma16816(dacc[1], a, b[2], b[3]);
      }
      if (r == CHUNK_TILES - 1) {  // the chunk's da, read after the next barrier
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int col = (jp + p) * 8 + t * 2, f = c * FFN_CHUNK + col;
          const float c0 = b1[f], c1 = b1[f + 1];
          const float d00 = dacc[p][0] * dgelu_erf(hacc[p][0] + c0);
          const float d01 = dacc[p][1] * dgelu_erf(hacc[p][1] + c1);
          const float d10 = dacc[p][2] * dgelu_erf(hacc[p][2] + c0);
          const float d11 = dacc[p][3] * dgelu_erf(hacc[p][3] + c1);
          const float s0 = group_sum(d00 + d10), s1 = group_sum(d01 + d11);
          if (g == 0)
            *reinterpret_cast<float2*>(part_b1 + (size_t)(tile * 2 + m1) * F + f) =
                make_float2(s0, s1);
          const uint32_t h0 = pack2(d00, d01), h1 = pack2(d10, d11);
          const int ra = m1 * 16 + g;
          bf16* hr = hs + ra * H_STRIDE + col;
          *reinterpret_cast<uint32_t*>(hr) = h0;
          *reinterpret_cast<uint32_t*>(hr + 8 * H_STRIDE) = h1;
          bf16* dr_out = da_out + (size_t)(r0 + ra) * F + f;
          if (ra < rows) *reinterpret_cast<uint32_t*>(dr_out) = h0;
          if (ra + 8 < rows) *reinterpret_cast<uint32_t*>(dr_out + (size_t)8 * F) = h1;
        }
      }
    } else {
      // dx += da . W1 tile s ([64 chunk rows][128 inputs]) into this
      // warp's accumulator tiles 2s, 2s + 1 (static indices)
      const int s1 = r - CHUNK_TILES;
#pragma unroll
      for (int ss = 0; ss < W1_TILES; ++ss) {
        if (ss != s1) continue;
#pragma unroll
        for (int ks = 0; ks < FFN_CHUNK / 16; ++ks) {
          uint32_t a[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int hr = (m * 16 + g) * HWS + ks * 8 + t;
            a[m][0] = Hw[hr];
            a[m][1] = Hw[hr + 8 * HWS];
            a[m][2] = Hw[hr + 4];
            a[m][3] = Hw[hr + 8 * HWS + 4];
          }
          uint32_t b[4];
          ldsm_x4_trans(b, T + (ks * 16 + (q & 1) * 8 + qi) * W1_STRIDE + warp * 16 +
                               (q >> 1) * 8);
          mma16816(acc[0][2 * ss], a[0], b[0], b[1]);
          mma16816(acc[1][2 * ss], a[1], b[0], b[1]);
          mma16816(acc[0][2 * ss + 1], a[0], b[2], b[3]);
          mma16816(acc[1][2 * ss + 1], a[1], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // 5. dx
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int col = out_col(warp, j) + t * 2;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = m * 16 + g + 8 * hi;
        if (r < rows)
          *reinterpret_cast<uint32_t*>(dx + (size_t)(r0 + r) * HIDDEN + col) =
              pack2(acc[m][j][2 * hi], acc[m][j][2 * hi + 1]);
      }
    }
}

// ------------------------------------------------- backward (#10), pass B
constexpr int WG_TILE = 128, WG_K = 32, WG_STAGES = 3, WG_STRIDE = WG_TILE + 8;
constexpr int WG_STAGE_ELEMS = 2 * WG_K * WG_STRIDE;  // the A tile, then the B tile
constexpr size_t WG_SMEM = (size_t)WG_STAGES * WG_STAGE_ELEMS * 2;
static_assert(2 * WG_K * (WG_TILE / 8) % FFN_THREADS == 0, "tile copy split");

// rows [k0, k0 + 32) of A's columns [m0, m0 + 128) and of B's columns
// [n0, n0 + 128) into a stage; rows at or past k_end are zero
__device__ __forceinline__ void wg_load(bf16* stage, const bf16* __restrict__ A, int lda,
                                        int m0, const bf16* __restrict__ B, int ldb, int n0,
                                        int k0, int k_end) {
  constexpr int SEGS = WG_K * (WG_TILE / 8);  // 16-byte copies per operand
#pragma unroll
  for (int i = 0; i < 2 * SEGS / FFN_THREADS; ++i) {
    const int s = threadIdx.x + i * FFN_THREADS;
    const int which = s / SEGS, rem = s % SEGS;
    const int row = rem / (WG_TILE / 8), seg = rem % (WG_TILE / 8);
    bf16* dst = stage + which * WG_K * WG_STRIDE + row * WG_STRIDE + seg * 8;
    const int k = k0 + row;
    if (k < k_end)
      cp_async16(dst, which ? B + (size_t)k * ldb + n0 + seg * 8
                            : A + (size_t)k * lda + m0 + seg * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// part[z] = sum over rows k of group z of A[k, m] B[k, n] (A [K, lda],
// B [K, ldb] bf16 row-major; part [groups, M, N] fp32). One [128 x 128]
// output tile per block (blockIdx.x: n, .y: m, .z: the row group); warp w
// owns rows 64 (w & 1) .. and columns 32 (w >> 1) .. of it.
__global__ void __launch_bounds__(FFN_THREADS)
    wgrad_partial_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B,
                         int ldb, int M, int N, int K, int k_per_group,
                         float* __restrict__ part) {
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int n0 = blockIdx.x * WG_TILE, m0 = blockIdx.y * WG_TILE;
  const int k_begin = blockIdx.z * k_per_group;
  const int k_end = min(K, k_begin + k_per_group);
  const int n_steps = k_end > k_begin ? (k_end - k_begin + WG_K - 1) / WG_K : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, q = lane >> 3, qi = lane & 7;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int i = 0; i < WG_STAGES - 1; ++i) {
    if (i < n_steps)
      wg_load(ring + i * WG_STAGE_ELEMS, A, lda, m0, B, ldb, n0, k_begin + i * WG_K, k_end);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<WG_STAGES - 2>();
    __syncthreads();
    const int next = step + WG_STAGES - 1;
    if (next < n_steps)
      wg_load(ring + (next % WG_STAGES) * WG_STAGE_ELEMS, A, lda, m0, B, ldb, n0,
              k_begin + next * WG_K, k_end);
    cp_async_commit();
    const bf16* As = ring + (step % WG_STAGES) * WG_STAGE_ELEMS;
    const bf16* Bs = As + WG_K * WG_STRIDE;
#pragma unroll
    for (int kk = 0; kk < WG_K; kk += 16) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)  // A^T fragments from the k-major A tile
        ldsm_x4_trans(a[mt], As + (kk + (q >> 1) * 8 + qi) * WG_STRIDE + wm + mt * 16 +
                                 (q & 1) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np)  // two 8-column B fragments each
        ldsm_x4_trans(b[np], Bs + (kk + (q & 1) * 8 + qi) * WG_STRIDE + wn + np * 16 +
                                 (q >> 1) * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma16816(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  float* out = part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int row = m0 + wm + mt * 16 + g, col = n0 + wn + nt * 8 + t * 2;
      *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(out + (size_t)(row + 8) * N + col) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// ------------------------------------------------- backward (#10), pass C
// out[i] = sum over p = 0, 1, .. of part[p * n + i]
__global__ void sum_partials_kernel(const float* __restrict__ part, int P, long long n,
                                    float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += part[(size_t)p * n + i];
    out[i] = s;
  }
}

// Scratch of the backward, carved from one workspace (256-byte aligned)
struct BwdWorkspace {
  size_t dy2, h, da, pw1, pw2, pb1, pvec, total;
};

inline BwdWorkspace bwd_workspace(int rows, int F, int groups) {
  const size_t tiles = (rows + FFN_ROWS - 1) / FFN_ROWS;
  BwdWorkspace w{};
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += (bytes + 255) & ~size_t(255);
    return at;
  };
  w.dy2 = take((size_t)rows * HIDDEN * 2);
  w.h = take((size_t)rows * F * 2);
  w.da = take((size_t)rows * F * 2);
  w.pw1 = take((size_t)groups * F * HIDDEN * 4);
  w.pw2 = take((size_t)groups * HIDDEN * F * 4);
  w.pb1 = take(tiles * 2 * F * 4);
  w.pvec = take(tiles * 3 * HIDDEN * 4);
  w.total = off;
  return w;
}

inline cudaError_t sum_partials(const float* part, int P, long long n, float* out,
                                cudaStream_t stream) {
  const long long blocks = (n + 255) / 256;
  sum_partials_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(part, P, n,
                                                                               out);
  return cudaGetLastError();
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

// Bytes of the backward's workspace for `rows` rows, width F and `groups`
// row groups of the weight gradients.
extern "C" long long uc2_ffn_train_bwd_workspace(int rows, int F, int groups) {
  return (long long)uc2::bwd_workspace(rows, F, groups).total;
}

// Inputs as uc2_ffn_train_fwd (no beta) and dy [rows, 768] bf16; writes dx
// [rows, 768] bf16, dw1 [F, 768], db1 [F], dw2 [768, F], db2, dgamma,
// dbeta [768] fp32; ws holds uc2_ffn_train_bwd_workspace(rows, F, groups)
// bytes. Returns cudaGetLastError().
extern "C" int uc2_ffn_train_bwd(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* gamma,
                                 const void* dy, void* dx, void* dw1, void* db1, void* dw2,
                                 void* db2, void* dgamma, void* dbeta, void* ws, int rows,
                                 int F, int groups, float eps, unsigned seed,
                                 unsigned thresh, float keep_scale, int drop, void* stream) {
  using namespace uc2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FfnDropout dr{seed, thresh, keep_scale};
  const BwdWorkspace w = bwd_workspace(rows, F, groups);
  uint8_t* base = static_cast<uint8_t*>(ws);
  bf16* dy2 = reinterpret_cast<bf16*>(base + w.dy2);
  bf16* h = reinterpret_cast<bf16*>(base + w.h);
  bf16* da = reinterpret_cast<bf16*>(base + w.da);
  float* pw1 = reinterpret_cast<float*>(base + w.pw1);
  float* pw2 = reinterpret_cast<float*>(base + w.pw2);
  float* pb1 = reinterpret_cast<float*>(base + w.pb1);
  float* pvec = reinterpret_cast<float*>(base + w.pvec);
  const int tiles = (rows + FFN_ROWS - 1) / FFN_ROWS;

  auto pass_a = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BWD_SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<tiles, FFN_THREADS, BWD_SMEM, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
        static_cast<const float*>(b1), static_cast<const bf16*>(w2),
        static_cast<const float*>(b2), static_cast<const float*>(gamma),
        static_cast<const bf16*>(dy), static_cast<bf16*>(dx), h, dy2, da, pb1, pvec, rows, F,
        eps, dr);
    return cudaGetLastError();
  };
  cudaError_t err = drop ? pass_a(ffn_train_bwd_rows_kernel<true>)
                         : pass_a(ffn_train_bwd_rows_kernel<false>);
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(wgrad_partial_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WG_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int per_group = ((rows + groups - 1) / groups + WG_K - 1) / WG_K * WG_K;
  // dW1 [F, 768] = da^T x; dW2 [768, F] = dy2^T h
  wgrad_partial_kernel<<<dim3(HIDDEN / WG_TILE, F / WG_TILE, groups), FFN_THREADS, WG_SMEM,
                         st>>>(da, F, static_cast<const bf16*>(x), HIDDEN, F, HIDDEN, rows,
                               per_group, pw1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wgrad_partial_kernel<<<dim3(F / WG_TILE, HIDDEN / WG_TILE, groups), FFN_THREADS, WG_SMEM,
                         st>>>(dy2, HIDDEN, h, F, HIDDEN, F, rows, per_group, pw2);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const long long wn = (long long)F * HIDDEN;
  if ((err = sum_partials(pw1, groups, wn, static_cast<float*>(dw1), st)) != cudaSuccess ||
      (err = sum_partials(pw2, groups, wn, static_cast<float*>(dw2), st)) != cudaSuccess ||
      (err = sum_partials(pb1, 2 * tiles, F, static_cast<float*>(db1), st)) != cudaSuccess ||
      (err = sum_partials(pvec, tiles, HIDDEN, static_cast<float*>(db2), st)) != cudaSuccess ||
      (err = sum_partials(pvec + (size_t)tiles * HIDDEN, tiles, HIDDEN,
                          static_cast<float*>(dgamma), st)) != cudaSuccess ||
      (err = sum_partials(pvec + (size_t)2 * tiles * HIDDEN, tiles, HIDDEN,
                          static_cast<float*>(dbeta), st)) != cudaSuccess)
    return (int)err;
  return (int)cudaSuccess;
}
