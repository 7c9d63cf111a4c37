// Shared device code of the uc2_torch kernels (sm_90a): bf16 tensor-core
// products through mma.sync.m16n8k16, warp reductions, and the per-head
// attention routine, out-projection and residual + LayerNorm epilogue of
// the whole-layer kernel #8 (fused_layer_block.cu; #9 shares the
// epilogue). The fused attention blocks #2 and #7 are wgmma/TMA kernels
// of their own (attn_block.cuh).
//
// Fragment layout of mma.sync.m16n8k16.row.col (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]
//   B (16x8, k by n):     b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16x8, fp32):       c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
// Every B operand here is stored n-major with k contiguous ([N][K] row-major:
// K rows for Q.K^T, V^T for P.V, nn.Linear weights [out][in]), so each
// fragment register is one 32-bit load. Shared-memory rows are padded so
// that the eight row-groups of a warp land on distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace uc2 {

typedef __nv_bfloat16 bf16;

constexpr int HEAD_DIM = 64;            // d of every head the kernels take
constexpr int MAX_LEN = 512;            // joint-length limit of the encoder
constexpr int K_STRIDE = HEAD_DIM + 8;  // bf16 per K row in shared memory
constexpr int HIDDEN = 768;             // H of the fused blocks (uc2-base)
constexpr int ROW_STRIDE = HIDDEN + 8;  // bf16 per [rows, H] tile row in smem

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, lo in the low half (the lower address)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the exact (erf) GELU of the FFN blocks
__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float2 unpack2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Four transposed 8x8 bf16 tiles from shared memory: lane l gives the row
// address of row (l & 7) of tile (l >> 3); register r holds tile r's column
// (lane / 4), rows 2 (lane % 4) and 2 (lane % 4) + 1. From a tile stored
// k-major (k rows, n contiguous) this is an mma B fragment (or, for A, the
// fragment of A^T).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// 16-byte asynchronous copy global -> shared (cp.async, bypassing L1)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ inline int padded_len(int L) { return (L + 15) & ~15; }
__host__ __device__ inline int score_stride(int Lp) { return Lp + 4; }  // floats
__host__ __device__ inline int vt_stride(int Lp) { return Lp + 8; }     // bf16

// Score columns per lane (32-column chunks of a softmax row) that a launch
// at joint length L instantiates: the padded length rounded up to one of a
// few sizes, so the softmax loop runs no further than the row.
__host__ __device__ inline int score_chunks(int L) {
  const int c = (padded_len(L) + 31) / 32;
  return c <= 2 ? 2 : c <= 4 ? 4 : c <= 6 ? 6 : c <= 8 ? 8 : c <= 12 ? 12 : 16;
}

// Shared memory of attend_head for QT query rows: the bias row, the fp32
// score rows (reused in place for the bf16 probabilities), and one region
// that holds K and then V^T.
__host__ __device__ inline size_t attend_smem_bytes(int QT, int L) {
  const int Lp = padded_len(L);
  const size_t k_bytes = (size_t)Lp * K_STRIDE * 2;
  const size_t vt_bytes = (size_t)HEAD_DIM * vt_stride(Lp) * 2;
  return (size_t)Lp * 4 + (size_t)QT * score_stride(Lp) * 4 +
         (k_bytes > vt_bytes ? k_bytes : vt_bytes);
}

// The attention routine below works in three phases, so that a variant can
// replace one of them (the training forward replaces the softmax):
//   attn_scores   bias row and K into shared memory, fp32 score rows
//                 q.k^T * scale + bias of query rows [q0, q0 + QT);
//   attn_softmax  max-shifted fp32 softmax of each row, rounded to bf16 in
//                 place (the TPU kernel's rounding point);
//   attn_pv       V^T into the K region, context = P . V, stored as bf16.
// Keys past L (padding to a multiple of 16) get -inf and zero K/V rows, so
// they carry no weight. Shared memory: attend_smem_bytes(QT, L).
struct AttnSmem {
  float* bias;  // [Lp]
  float* S;     // [QT][score_stride(Lp)] fp32 scores, then bf16 probabilities
  bf16* KV;     // K [Lp][K_STRIDE], then V^T [HEAD_DIM][vt_stride(Lp)]
};

__device__ __forceinline__ AttnSmem attn_smem(uint8_t* smem, int Lp, int QT) {
  float* bias = reinterpret_cast<float*>(smem);
  float* S = bias + Lp;
  return {bias, S, reinterpret_cast<bf16*>(S + QT * score_stride(Lp))};
}

//   qh, kh:   token 0 of this batch row and head; tokens are rs apart
//   bias_row: the additive key bias of this batch row, [L] fp32
template <int WARPS, int QT>
__device__ void attn_scores(const bf16* __restrict__ qh,
                            const bf16* __restrict__ kh, int rs,
                            const float* __restrict__ bias_row, int L, int q0,
                            float scale, uint8_t* smem) {
  constexpr int MT = QT / 16;        // 16-row m-tiles
  constexpr int WPM = WARPS / MT;    // warps sharing one m-tile
  static_assert(WARPS % MT == 0, "warp layout");
  const int Lp = padded_len(L);
  const int SF = score_stride(Lp);
  const AttnSmem sm = attn_smem(smem, Lp, QT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m = warp % MT, wj = warp / MT;

  __syncthreads();  // the previous user of this shared memory is done
  for (int i = tid; i < Lp; i += WARPS * 32)
    sm.bias[i] = i < L ? bias_row[i] : -INFINITY;
  for (int i = tid; i < Lp * 8; i += WARPS * 32) {
    const int key = i >> 3, c = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (key < L) val = *reinterpret_cast<const uint4*>(kh + (size_t)key * rs + c);
    *reinterpret_cast<uint4*>(sm.KV + key * K_STRIDE + c) = val;
  }
  uint32_t qa[HEAD_DIM / 16][4];
  const int r0 = q0 + m * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int ks = 0; ks < HEAD_DIM / 16; ++ks) {
    const int c = ks * 16 + t * 2;
    qa[ks][0] = r0 < L ? ld32(qh + (size_t)r0 * rs + c) : 0u;
    qa[ks][1] = r1 < L ? ld32(qh + (size_t)r1 * rs + c) : 0u;
    qa[ks][2] = r0 < L ? ld32(qh + (size_t)r0 * rs + c + 8) : 0u;
    qa[ks][3] = r1 < L ? ld32(qh + (size_t)r1 * rs + c + 8) : 0u;
  }
  __syncthreads();

  // scores: this warp's m-tile against every WPM-th 8-key tile
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
    *reinterpret_cast<float2*>(s0 + 8 * SF) =
        make_float2(c[2] * scale + b0, c[3] * scale + b1);
  }
  __syncthreads();
}

// NC >= score_chunks(L). One row per warp at a time; the bf16
// probabilities overwrite the front of the row once every lane has read it.
template <int WARPS, int QT, int NC>
__device__ void attn_softmax(int L, uint8_t* smem) {
  static_assert(NC * 32 <= MAX_LEN, "score chunks");
  const int Lp = padded_len(L);
  const int SF = score_stride(Lp);
  const AttnSmem sm = attn_smem(smem, Lp, QT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < QT; r += WARPS) {
    float* srow = sm.S + r * SF;
    float e[NC];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      e[i] = c < Lp ? srow[c] : -INFINITY;
      mx = fmaxf(mx, e[i]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      e[i] = c < Lp ? expf(e[i] - mx) : 0.f;
      sum += e[i];
    }
    const float inv = 1.f / warp_sum(sum);
    __syncwarp();
    bf16* prow = reinterpret_cast<bf16*>(srow);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < Lp) prow[c] = __float2bfloat16(e[i] * inv);
    }
  }
}

// The product phase of attn_pv, once V^T [HEAD_DIM][vt_stride(Lp)] is in
// the K/V region (zero or finite past L) and the bf16 probabilities in S:
//   out: row q0 of the context; rows are out_rs apart; the first out_rows
//        rows are written, as bf16
template <int WARPS, int QT>
__device__ void attn_pv_product(int L, uint8_t* smem, bf16* out, int out_rs,
                                int out_rows) {
  constexpr int MT = QT / 16;
  constexpr int WPM = WARPS / MT;
  constexpr int NPW = 8 / WPM;       // 8-wide head-dim tiles per warp
  static_assert(8 % WPM == 0, "warp layout");
  const int Lp = padded_len(L);
  const int SF = score_stride(Lp);
  const int VS = vt_stride(Lp);
  const AttnSmem sm = attn_smem(smem, Lp, QT);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m = warp % MT, wj = warp / MT;

  float acc[NPW][4];
#pragma unroll
  for (int p = 0; p < NPW; ++p) acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.f;
  const uint32_t* Pw = reinterpret_cast<const uint32_t*>(sm.S);
  const uint32_t* Vw = reinterpret_cast<const uint32_t*>(sm.KV);
  const int pa = (m * 16 + g) * SF, pb = pa + 8 * SF;
  for (int kk = 0; kk < Lp / 16; ++kk) {
    uint32_t a[4];
    a[0] = Pw[pa + kk * 8 + t];
    a[1] = Pw[pb + kk * 8 + t];
    a[2] = Pw[pa + kk * 8 + t + 4];
    a[3] = Pw[pb + kk * 8 + t + 4];
#pragma unroll
    for (int p = 0; p < NPW; ++p) {
      const uint32_t* vr = Vw + ((wj + p * WPM) * 8 + g) * (VS / 2) + kk * 8 + t;
      mma16816(acc[p], a, vr[0], vr[4]);
    }
  }
  const int ra = m * 16 + g, rb = ra + 8;
#pragma unroll
  for (int p = 0; p < NPW; ++p) {
    const int col = (wj + p * WPM) * 8 + t * 2;
    if (ra < out_rows)
      *reinterpret_cast<uint32_t*>(out + (size_t)ra * out_rs + col) = pack2(acc[p][0], acc[p][1]);
    if (rb < out_rows)
      *reinterpret_cast<uint32_t*>(out + (size_t)rb * out_rs + col) = pack2(acc[p][2], acc[p][3]);
  }
}

//   vh:  token 0 of this batch row and head's values; tokens rs apart
//   out, out_rs, out_rows: as attn_pv_product
template <int WARPS, int QT>
__device__ void attn_pv(const bf16* __restrict__ vh, int rs, int L,
                        uint8_t* smem, bf16* out, int out_rs, int out_rows) {
  const int Lp = padded_len(L);
  const int VS = vt_stride(Lp);
  const AttnSmem sm = attn_smem(smem, Lp, QT);
  const int tid = threadIdx.x;

  // V^T into the K region: every warp passed the score loop's barrier
  for (int i = tid; i < Lp * 8; i += WARPS * 32) {
    const int key = i >> 3, c = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (key < L) val = *reinterpret_cast<const uint4*>(vh + (size_t)key * rs + c);
    const bf16* pv = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int u = 0; u < 8; ++u) sm.KV[(c + u) * VS + key] = pv[u];
  }
  __syncthreads();
  attn_pv_product<WARPS, QT>(L, smem, out, out_rs, out_rows);
}

// softmax(q.k^T * scale + bias) . v for one (batch, head) and query rows
// [q0, q0 + QT), computed by the whole block (WARPS warps); NC >=
// score_chunks(L). Arguments as the three phases above.
template <int WARPS, int QT, int NC>
__device__ void attend_head(const bf16* __restrict__ qh,
                            const bf16* __restrict__ kh,
                            const bf16* __restrict__ vh, int rs,
                            const float* __restrict__ bias_row, int L, int q0,
                            float scale, uint8_t* smem, bf16* out, int out_rs,
                            int out_rows) {
  attn_scores<WARPS, QT>(qh, kh, rs, bias_row, L, q0, scale, smem);
  attn_softmax<WARPS, QT, NC>(L, smem);
  attn_pv<WARPS, QT>(vh, rs, L, smem, out, out_rs, out_rows);
}

// Call launch(std::integral_constant<int, NC>()) with NC = score_chunks(L),
// so that a launcher instantiates its kernel once per chunk count.
template <typename Launch>
inline int with_score_chunks(int L, Launch launch) {
  switch (score_chunks(L)) {
    case 2: return launch(std::integral_constant<int, 2>());
    case 4: return launch(std::integral_constant<int, 4>());
    case 6: return launch(std::integral_constant<int, 6>());
    case 8: return launch(std::integral_constant<int, 8>());
    case 12: return launch(std::integral_constant<int, 12>());
    default: return launch(std::integral_constant<int, 16>());
  }
}

// Output columns of the fused blocks' [32, HIDDEN] product, for a block of
// 8 warps: warp w owns 16 columns of each 128-wide slice, so accumulator
// tile j (0..11, 8 columns each) of warp w starts at out_col(w, j), and
// every warp takes part in every 128-row tile of a weight.
__device__ __forceinline__ int out_col(int warp, int j) {
  return (j >> 1) * 128 + warp * 16 + (j & 1) * 8;
}

// y = ctx . Wo^T for the fused blocks, a block of 8 warps over a [32,
// HIDDEN] bf16 context tile in shared memory (rows ROW_STRIDE apart); wo
// [HIDDEN, HIDDEN] ([out, in]) is read from device memory (L2). acc[m][j]
// gets rows m*16 + g (+8) and columns out_col(warp, j) + 2t (+1), fp32.
__device__ __forceinline__ void ctx_out_projection(const bf16* ctx,
                                                   const bf16* __restrict__ wo,
                                                   float (&acc)[2][12][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 12; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
  const uint32_t* Cw = reinterpret_cast<const uint32_t*>(ctx);
  constexpr int CW = ROW_STRIDE / 2;
  for (int ks = 0; ks < HIDDEN / 16; ++ks) {
    uint32_t a[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int r = m * 16 + g;
      a[m][0] = Cw[r * CW + ks * 8 + t];
      a[m][1] = Cw[(r + 8) * CW + ks * 8 + t];
      a[m][2] = Cw[r * CW + ks * 8 + t + 4];
      a[m][3] = Cw[(r + 8) * CW + ks * 8 + t + 4];
    }
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const bf16* wr = wo + (size_t)(out_col(warp, j) + g) * HIDDEN + ks * 16 + t * 2;
      const uint32_t b0 = ldg32(wr), b1 = ldg32(wr + 8);
      mma16816(acc[0][j], a[0], b0, b1);
      mma16816(acc[1][j], a[1], b0, b1);
    }
  }
}

// Epilogue of the fused blocks, for a block of 8 warps over 32 rows of
// HIDDEN columns. acc[m][j] is this warp's product tile for rows
// m*16 + g (+8) and columns out_col(warp, j) + 2t (+1). Computes
//   out = LayerNorm(acc + vbias + residual) * gamma + beta
// with fp32 two-pass statistics (mean, then mean squared deviation), and
// writes the first `rows` rows as bf16, rows out_rs apart. `res` may point
// to global or shared memory; `red` is 8*32 floats of shared scratch. With
// ADD_BIAS false, acc already holds its bias and vbias is not read; with
// ADD_RES false there is no residual and res is not read (a residual comes
// with its bias). With KEEP (the whole-layer block, whose FFN takes the
// fp32 LayerNorm output as its residual), acc ends holding the fp32 output
// and all 32 rows are written.
template <bool ADD_BIAS = true, bool ADD_RES = true, bool KEEP = false>
__device__ __forceinline__ void residual_layernorm(
    float (&acc)[2][12][4], const float* __restrict__ vbias, const bf16* res,
    int res_rs, const float* __restrict__ gamma, const float* __restrict__ beta,
    float eps, bf16* __restrict__ out, int rows, float* red, int out_rs = HIDDEN) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  static_assert(ADD_BIAS || !ADD_RES, "a residual comes with its bias");
  float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int col = out_col(warp, j) + t * 2;
      const float b0 = ADD_BIAS ? vbias[col] : 0.f;
      const float b1 = ADD_BIAS ? vbias[col + 1] : 0.f;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = m * 16 + g + 8 * hi;
        if constexpr (ADD_RES) {
          const float2 xr = r < rows ? unpack2(res + (size_t)r * res_rs + col)
                                     : make_float2(0.f, 0.f);
          acc[m][j][2 * hi] = (acc[m][j][2 * hi] + b0) + xr.x;
          acc[m][j][2 * hi + 1] = (acc[m][j][2 * hi + 1] + b1) + xr.y;
        } else if (ADD_BIAS) {
          acc[m][j][2 * hi] += b0;
          acc[m][j][2 * hi + 1] += b1;
        }
        part[m][hi] += acc[m][j][2 * hi] + acc[m][j][2 * hi + 1];
      }
    }
  float mean[2][2], rstd[2][2];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float v = part[m][hi];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) red[warp * 32 + m * 16 + g + 8 * hi] = v;
      }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = m * 16 + g + 8 * hi;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) s += red[w * 32 + r];
        if (pass == 0) mean[m][hi] = s / HIDDEN;
        else rstd[m][hi] = rsqrtf(s / HIDDEN + eps);
      }
    __syncthreads();
    if (pass == 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          float v = 0.f;
#pragma unroll
          for (int j = 0; j < 12; ++j) {
            const float d0 = acc[m][j][2 * hi] - mean[m][hi];
            const float d1 = acc[m][j][2 * hi + 1] - mean[m][hi];
            v += d0 * d0 + d1 * d1;
          }
          part[m][hi] = v;
        }
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int col = out_col(warp, j) + t * 2;
      const float g0 = gamma[col], g1 = gamma[col + 1];
      const float e0 = beta[col], e1 = beta[col + 1];
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = m * 16 + g + 8 * hi;
        if constexpr (KEEP) {
          const float y0 = (acc[m][j][2 * hi] - mean[m][hi]) * rstd[m][hi];
          const float y1 = (acc[m][j][2 * hi + 1] - mean[m][hi]) * rstd[m][hi];
          acc[m][j][2 * hi] = y0 * g0 + e0;
          acc[m][j][2 * hi + 1] = y1 * g1 + e1;
          *reinterpret_cast<uint32_t*>(out + (size_t)r * out_rs + col) =
              pack2(acc[m][j][2 * hi], acc[m][j][2 * hi + 1]);
        } else if (r < rows) {
          const float y0 = (acc[m][j][2 * hi] - mean[m][hi]) * rstd[m][hi];
          const float y1 = (acc[m][j][2 * hi + 1] - mean[m][hi]) * rstd[m][hi];
          *reinterpret_cast<uint32_t*>(out + (size_t)r * out_rs + col) =
              pack2(y0 * g0 + e0, y1 * g1 + e1);
        }
      }
    }
}

}  // namespace uc2
