// The training FFN block's backward (#10): for
//   y = LayerNorm(dropout(gelu_erf(x . W1^T + b1) . W2^T + b2) + x) * gamma + beta
// and the output gradient dy, the gradients dx (bf16) and dW1, db1, dW2,
// db2, dgamma, dbeta (fp32). Replaces the TPU kernel
// uc2_tpu/ops/ffn_train.py _bwd_kernel (launched by _ffn_train_bwd), which
// every encoder layer runs in training under
// use_pallas_attention="pallas-train" with UC2_FFN_TRAIN=1. The forward
// (#9) is fused_ffn_block.cu's kernel with DROP; both draw the dropout mask
// from Philox of the global (row, column) (philox.cuh ffn_keep_bits4).
//
// The TPU kernel walks its row tiles in order and sums the weight and
// vector gradients in fp32 outputs that stay in VMEM. Here the backward is
// a short chain of products on one wgmma/TMA core (gemm.cuh), each with a
// fused epilogue, every intermediate written once (rows R, H = 768, F):
//   1. a = x . W1^T + b1:   h = bf16(gelu(a)) [R, F], gelu'(a) fp32 [R, F]
//   2. y2 = h . W2^T + b2:  fp32 [R, H]
//   3. a row pass (not a product): the mask, the residual, the LayerNorm
//      statistics in fp32, dy_pre = inv (dyn - mean(dyn) - yhat
//      mean(dyn yhat)) fp32 (over y2, in place), dy2 = keep ? dy_pre /
//      (1 - rate) : 0 in bf16, and each 64-row tile's column sums of
//      dgamma, dbeta and db2
//   4. dh = dy2 . W2 (W2 read MN-major): da = dh gelu'(a), bf16 [R, F],
//      and each 128-row tile's column sums of the fp32 da (db1)
//   5. dx = bf16(da . W1 + dy_pre) (W1 read MN-major)
//   6. dW1 = da^T x and dW2 = dy2^T h (both operands MN-major, K = R, in
//      fixed row splits, each split its own fp32 partial)
//   7. every partial summed in a fixed order.
// The rounding points are the reference's: dy2 is rounded before dW2 and
// dh, db1 sums the fp32 da while dW1 and dx take the rounded da, dx adds
// dy_pre in fp32 and rounds once, and gelu' is taken of the fp32 a. No
// atomics, so a step repeats bit for bit.
//
// What bounds it on an H100: operations. Six products of 2 R H F each,
// 12 R H F (587 GFLOP at R = 20736, F = 3072: 0.594 ms at 989 TFLOP/s),
// the TPU kernel's count. The intermediates cost bytes beside that: h, da
// (2 R F each) and gelu'(a) (4 R F) written and read once, 1.0 GB at
// R = 20736 (0.31 ms at 3.35 TB/s), which the products' epilogues and
// loads overlap only across blocks. gelu'(a) is stored rather than a: the
// same bytes, and step 4's epilogue then needs no erf.
//
// The partial mode (uc2_ffn_train_bwd_partial; tensor parallelism over T
// processes, the backward of #9's partial mode): W1 and W2 hold F = F / T
// of the intermediate columns, and the caller hands in dy_pre [R, H] fp32,
// the gradient of the masked partial sum (autograd of the LayerNorm and
// the residual behind the model group's all-reduce, the same on every
// process). The chain keeps step 1, drops step 2 and turns the row pass
// into a mask pass: dy2 = keep ? dy_pre / (1 - rate) : 0 in bf16 with its
// tiles' column sums (db2); steps 4, 6 and 7 as above; step 5 writes
// dx_part = bf16(da . W1), which the caller sums over the group (the
// residual's dy_pre reaches dx through autograd). Five products of
// 2 R H F each: 244.6 GFLOP at R = 20736, F = 1536 (0.247 ms).
#include "gemm.cuh"
#include "philox.cuh"

namespace uc2 {

// gelu(a) = a Phi(a) (erf form, as gelu_erf) and its derivative
// Phi(a) + a phi(a), sharing one erf
__device__ __forceinline__ void gelu_and_grad(float a, float& g, float& dg) {
  const float p = 0.5f * (1.f + erff(a * 0.70710678118654752f));
  g = a * p;
  dg = p + a * expf(-0.5f * a * a) * 0.39894228040143268f;
}

namespace ffn_bwd {

using gemm::BN;
using gemm::Tile;
typedef float Cols[BN / 32][2][8];  // gemm::quad_columns' layout

__device__ __forceinline__ void load8f(float (&d)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  d[0] = a.x, d[1] = a.y, d[2] = a.z, d[3] = a.w, d[4] = b.x, d[5] = b.y, d[6] = b.z, d[7] = b.w;
}

__device__ __forceinline__ void store8f(float* p, const float (&d)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(d[4], d[5], d[6], d[7]);
}

__device__ __forceinline__ void store8h(bf16* p, const float (&d)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack2(d[0], d[1]), pack2(d[2], d[3]), pack2(d[4], d[5]), pack2(d[6], d[7]));
}

// 1. h = bf16(gelu(acc + b1)), gp = gelu'(acc + b1); both [M, ld]
struct GeluEpi {
  const float* b1;
  bf16* h;
  float* gp;
  int ld;
  __device__ void operator()(const Cols& v, const Tile& e, int M) const {
#pragma unroll
    for (int k = 0; k < BN / 32; ++k) {
      const int col = e.col + 32 * k;
      float bb[8];
      load8f(bb, b1 + col);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = e.row + 8 * hi;
        if (r >= M) continue;
        float g[8], dg[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) gelu_and_grad(v[k][hi][i] + bb[i], g[i], dg[i]);
        const size_t o = (size_t)r * ld + col;
        store8h(h + o, g);
        store8f(gp + o, dg);
      }
    }
  }
};

// 2. y2 = acc + b2, fp32 [M, HIDDEN]
struct BiasEpi {
  const float* b2;
  float* y2;
  __device__ void operator()(const Cols& v, const Tile& e, int M) const {
#pragma unroll
    for (int k = 0; k < BN / 32; ++k) {
      const int col = e.col + 32 * k;
      float bb[8];
      load8f(bb, b2 + col);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = e.row + 8 * hi;
        if (r >= M) continue;
        float y[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) y[i] = v[k][hi][i] + bb[i];
        store8f(y2 + (size_t)r * HIDDEN + col, y);
      }
    }
  }
};

// 4. da = acc gp (fp32): bf16 da [M, ld]; the tile's column sums of the
//    fp32 da go to part_b1[blockIdx.y][ld]
struct DgeluEpi {
  const float* gp;
  bf16* da;
  float* part_b1;
  int ld;
  __device__ void operator()(const Cols& v, const Tile& e, int M) const {
    float sums[BN / 32][8];
#pragma unroll
    for (int k = 0; k < BN / 32; ++k) {
      const int col = e.col + 32 * k;
#pragma unroll
      for (int i = 0; i < 8; ++i) sums[k][i] = 0.f;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = e.row + 8 * hi;
        if (r >= M) continue;
        const size_t o = (size_t)r * ld + col;
        float d[8];
        load8f(d, gp + o);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          d[i] *= v[k][hi][i];
          sums[k][i] += d[i];
        }
        store8h(da + o, d);
      }
    }
    gemm::column_sums(sums, e, part_b1 + (size_t)blockIdx.y * ld + e.col - 8 * e.t);
  }
};

// 5. dx = bf16(acc + dy_pre), [M, HIDDEN]; without ADD (the partial
//    mode) dx = bf16(acc), dy_pre not read
template <bool ADD>
struct ResidualEpi {
  const float* dy_pre;
  bf16* dx;
  __device__ void operator()(const Cols& v, const Tile& e, int M) const {
#pragma unroll
    for (int k = 0; k < BN / 32; ++k) {
      const int col = e.col + 32 * k;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = e.row + 8 * hi;
        if (r >= M) continue;
        const size_t o = (size_t)r * HIDDEN + col;
        float d[8];
        if constexpr (ADD) {
          load8f(d, dy_pre + o);
#pragma unroll
          for (int i = 0; i < 8; ++i) d[i] += v[k][hi][i];
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) d[i] = v[k][hi][i];
        }
        store8h(dx + o, d);
      }
    }
  }
};

// 6. the split's fp32 partial, out[blockIdx.z][M][ld]
struct StoreEpi {
  float* out;
  int ld;
  __device__ void operator()(const Cols& v, const Tile& e, int M) const {
    float* o = out + (size_t)blockIdx.z * M * ld;
#pragma unroll
    for (int k = 0; k < BN / 32; ++k)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = e.row + 8 * hi;
        if (r < M) store8f(o + (size_t)r * ld + e.col + 32 * k, v[k][hi]);
      }
  }
};

// ------------------------------------------------------------ 3. row pass
// One warp a row, 8 rows a warp, 64 rows a block; lane l holds columns
// 256 j + 8 l .. + 7 (j = 0, 1, 2).
constexpr int RP_WARPS = 8, RP_ROWS = 64, RP_THREADS = RP_WARPS * 32;
constexpr int RP_SMEM = 3 * RP_WARPS * HIDDEN * 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void load8(float (&d)[8], const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = stream::bf16x2_to_float2(w[i]);
    d[2 * i] = f.x;
    d[2 * i + 1] = f.y;
  }
}

// y2 [R, H] fp32 in, dy_pre out (in place); x, dy [R, H] bf16; dy2 [R, H]
// bf16 out; part_vec [3][tiles][H]: the tile's db2, dgamma, dbeta
template <bool DROP>
__global__ void __launch_bounds__(RP_THREADS)
    rows_kernel(float* __restrict__ y2, const bf16* __restrict__ x, const bf16* __restrict__ dy,
                const float* __restrict__ gamma, bf16* __restrict__ dy2,
                float* __restrict__ part_vec, int R, float eps, Dropout dr) {
  extern __shared__ float red[];  // [3][RP_WARPS][HIDDEN]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float p_db2[24], p_dg[24], p_db[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) p_db2[i] = p_dg[i] = p_db[i] = 0.f;

  for (int i = 0; i < RP_ROWS / RP_WARPS; ++i) {
    const int r = blockIdx.x * RP_ROWS + warp * (RP_ROWS / RP_WARPS) + i;
    if (r >= R) break;
    const size_t ro = (size_t)r * HIDDEN;
    float y[24], d[24];
    uint32_t keep = 0xFFFFFFu;  // bit 8 j + e: column 256 j + 8 lane + e kept
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int col = 256 * j + 8 * lane;
      float xv[8], dv[8];
      load8(xv, x + ro + col);
      load8(dv, dy + ro + col);
      const float4 u0 = *reinterpret_cast<const float4*>(y2 + ro + col);
      const float4 u1 = *reinterpret_cast<const float4*>(y2 + ro + col + 4);
      const float yv[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
      if constexpr (DROP) {
        const uint32_t k = ffn_keep_bits4(dr.seed, dr.thresh, (uint32_t)col >> 2, (uint32_t)r) |
                           ffn_keep_bits4(dr.seed, dr.thresh, ((uint32_t)col >> 2) + 1,
                                          (uint32_t)r) << 4;
        keep = (keep & ~(0xFFu << (8 * j))) | (k << (8 * j));
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float v = DROP ? ((keep >> (8 * j + e)) & 1u ? yv[e] * dr.keep_scale : 0.f) : yv[e];
        y[8 * j + e] = v + xv[e];
        d[8 * j + e] = dv[e];
      }
    }
    // LayerNorm statistics (two passes, fp32), yhat in place of y
    float s = 0.f;
#pragma unroll
    for (int i2 = 0; i2 < 24; ++i2) s += y[i2];
    const float mean = warp_sum(s) / HIDDEN;
    float v = 0.f;
#pragma unroll
    for (int i2 = 0; i2 < 24; ++i2) v += (y[i2] - mean) * (y[i2] - mean);
    const float inv = rsqrtf(warp_sum(v) / HIDDEN + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i2 = 8 * j + e;
        y[i2] = (y[i2] - mean) * inv;
        p_dg[i2] += d[i2] * y[i2];
        p_db[i2] += d[i2];
        d[i2] *= gamma[256 * j + 8 * lane + e];  // dyn
        s1 += d[i2];
        s2 += d[i2] * y[i2];
      }
    const float mn = warp_sum(s1) / HIDDEN, mny = warp_sum(s2) / HIDDEN;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int col = 256 * j + 8 * lane;
      float pre[8], q[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i2 = 8 * j + e;
        pre[e] = inv * (d[i2] - mn - y[i2] * mny);
        q[e] = DROP ? ((keep >> i2) & 1u ? pre[e] * dr.keep_scale : 0.f) : pre[e];
        p_db2[i2] += q[e];
      }
      *reinterpret_cast<float4*>(y2 + ro + col) = make_float4(pre[0], pre[1], pre[2], pre[3]);
      *reinterpret_cast<float4*>(y2 + ro + col + 4) = make_float4(pre[4], pre[5], pre[6], pre[7]);
      *reinterpret_cast<uint4*>(dy2 + ro + col) =
          make_uint4(pack2(q[0], q[1]), pack2(q[2], q[3]), pack2(q[4], q[5]), pack2(q[6], q[7]));
    }
  }
  // the tile's column sums: warps in order
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = 256 * j + 8 * lane + e, i2 = 8 * j + e;
      red[(0 * RP_WARPS + warp) * HIDDEN + col] = p_db2[i2];
      red[(1 * RP_WARPS + warp) * HIDDEN + col] = p_dg[i2];
      red[(2 * RP_WARPS + warp) * HIDDEN + col] = p_db[i2];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * HIDDEN; i += RP_THREADS) {
    const int q = i / HIDDEN, col = i % HIDDEN;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < RP_WARPS; ++w) s += red[(q * RP_WARPS + w) * HIDDEN + col];
    part_vec[((size_t)q * gridDim.x + blockIdx.x) * HIDDEN + col] = s;
  }
}

// The partial mode's step 3: dy_pre [R, H] fp32 in; dy2 = keep ? dy_pre
// keep_scale : 0 as bf16 [R, H] out, and the tile's column sums of the
// fp32 dy2 (db2) in part_db2[tiles][H]; the rows, lanes and mask of
// rows_kernel
template <bool DROP>
__global__ void __launch_bounds__(RP_THREADS)
    mask_rows_kernel(const float* __restrict__ dy_pre, bf16* __restrict__ dy2,
                     float* __restrict__ part_db2, int R, Dropout dr) {
  extern __shared__ float red[];  // [RP_WARPS][HIDDEN]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float p_db2[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) p_db2[i] = 0.f;

  for (int i = 0; i < RP_ROWS / RP_WARPS; ++i) {
    const int r = blockIdx.x * RP_ROWS + warp * (RP_ROWS / RP_WARPS) + i;
    if (r >= R) break;
    const size_t ro = (size_t)r * HIDDEN;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int col = 256 * j + 8 * lane;
      float q[8];
      load8f(q, dy_pre + ro + col);
      if constexpr (DROP) {
        const uint32_t k = ffn_keep_bits4(dr.seed, dr.thresh, (uint32_t)col >> 2, (uint32_t)r) |
                           ffn_keep_bits4(dr.seed, dr.thresh, ((uint32_t)col >> 2) + 1,
                                          (uint32_t)r) << 4;
#pragma unroll
        for (int e = 0; e < 8; ++e) q[e] = (k >> e) & 1u ? q[e] * dr.keep_scale : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) p_db2[8 * j + e] += q[e];
      store8h(dy2 + ro + col, q);
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) red[warp * HIDDEN + 256 * j + 8 * lane + e] = p_db2[8 * j + e];
  __syncthreads();
  for (int col = threadIdx.x; col < HIDDEN; col += RP_THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < RP_WARPS; ++w) s += red[w * HIDDEN + col];
    part_db2[(size_t)blockIdx.x * HIDDEN + col] = s;
  }
}

// ------------------------------------------------------------ 7. partials
// out[i] = sum over p of part[p * n + i], each in a fixed order. Few
// partials over many outputs (the weight gradients' row splits): a thread
// sums four outputs. Many partials over few outputs (up to 324 row tiles
// of the vector gradients, where one thread an output waits on one load
// after another): a block takes 32 outputs, its 8 warps the partials
// p = w, w + 8, .., and the warp sums are added in warp order.
constexpr int SUM_COLS = 32, SUM_WARPS = 8;

__global__ void sum_few_kernel(const float4* __restrict__ part, int P, long long n4,
                               float4* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 s = part[i];
    for (int p = 1; p < P; ++p) {
      const float4 v = part[(size_t)p * n4 + i];
      s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
    }
    out[i] = s;
  }
}

__global__ void __launch_bounds__(SUM_COLS * SUM_WARPS)
    sum_many_kernel(const float* __restrict__ part, int P, int n, float* __restrict__ out) {
  __shared__ float red[SUM_WARPS][SUM_COLS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * SUM_COLS + lane;
  float s = 0.f;
  if (i < n)
    for (int p = warp; p < P; p += SUM_WARPS) s += part[(size_t)p * n + i];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < SUM_WARPS; ++w) t += red[w][lane];
    out[i] = t;
  }
}

// n a multiple of 4 (every width here is)
inline cudaError_t sum_partials(const float* part, int P, long long n, float* out,
                                cudaStream_t stream) {
  if (P <= SUM_WARPS) {
    const long long blocks = (n / 4 + 255) / 256;
    sum_few_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(part), P, n / 4, reinterpret_cast<float4*>(out));
  } else {
    sum_many_kernel<<<(int)((n + SUM_COLS - 1) / SUM_COLS), SUM_COLS * SUM_WARPS, 0, stream>>>(
        part, P, (int)n, out);
  }
  return cudaGetLastError();
}

// row splits of the weight-gradient products (K = rows): at most
// max_splits, and each at least 2048 rows
inline int wgrad_splits(int rows, int max_splits) {
  const int s = rows / 2048;
  return s < 1 ? 1 : s > max_splits ? max_splits : s;
}

// Scratch of the backward, carved from one workspace (256-byte aligned)
struct Workspace {
  size_t h, gp, da, y2, dy2, pb1, pvec, pw1, pw2, total;
};

// partial: the partial mode's (no y2; one vector's tile sums)
inline Workspace workspace(int rows, int F, int max_splits, bool partial) {
  const size_t R = rows, m_tiles = (rows + gemm::BM - 1) / gemm::BM,
               r_tiles = (rows + RP_ROWS - 1) / RP_ROWS, S = wgrad_splits(rows, max_splits);
  Workspace w{};
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += (bytes + 255) & ~size_t(255);
    return at;
  };
  w.h = take(R * F * 2);
  w.gp = take(R * F * 4);
  w.da = take(R * F * 2);
  w.y2 = take(partial ? 0 : R * HIDDEN * 4);
  w.dy2 = take(R * HIDDEN * 2);
  w.pb1 = take(m_tiles * F * 4);
  w.pvec = take((partial ? 1 : 3) * r_tiles * HIDDEN * 4);
  w.pw1 = take(S * F * HIDDEN * 4);
  w.pw2 = take(S * HIDDEN * F * 4);
  w.total = off;
  return w;
}

}  // namespace ffn_bwd
}  // namespace uc2

// Bytes of the backward's workspace for `rows` rows, width F and at most
// `max_splits` row splits of the weight gradients; partial != 0: of the
// partial mode's.
extern "C" long long uc2_ffn_train_bwd_workspace(int rows, int F, int max_splits, int partial) {
  return (long long)uc2::ffn_bwd::workspace(rows, F, max_splits, partial != 0).total;
}

// x, dy [rows, 768] bf16; w1 [F, 768] and w2 [768, F] bf16 ([out, in]), F
// a multiple of 128; b1 [F], b2, gamma [768] fp32; writes dx [rows, 768]
// bf16, dw1 [F, 768], db1 [F], dw2 [768, F], db2, dgamma, dbeta [768] fp32;
// ws holds uc2_ffn_train_bwd_workspace(rows, F, max_splits) bytes. drop = 0
// skips the mask (rate 0). Returns the first CUDA error.
extern "C" int uc2_ffn_train_bwd(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* gamma,
                                 const void* dy, void* dx, void* dw1, void* db1, void* dw2,
                                 void* db2, void* dgamma, void* dbeta, void* ws, int rows,
                                 int F, int max_splits, float eps, unsigned seed,
                                 unsigned thresh, float keep_scale, int drop, void* stream) {
  using namespace uc2;
  using namespace uc2::ffn_bwd;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Workspace w = workspace(rows, F, max_splits, false);
  uint8_t* base = static_cast<uint8_t*>(ws);
  bf16* h = reinterpret_cast<bf16*>(base + w.h);
  float* gp = reinterpret_cast<float*>(base + w.gp);
  bf16* da = reinterpret_cast<bf16*>(base + w.da);
  float* y2 = reinterpret_cast<float*>(base + w.y2);  // then dy_pre
  bf16* dy2 = reinterpret_cast<bf16*>(base + w.dy2);
  float* pb1 = reinterpret_cast<float*>(base + w.pb1);
  float* pvec = reinterpret_cast<float*>(base + w.pvec);
  float* pw1 = reinterpret_cast<float*>(base + w.pw1);
  float* pw2 = reinterpret_cast<float*>(base + w.pw2);
  const int S = wgrad_splits(rows, max_splits);
  const int m_tiles = (rows + gemm::BM - 1) / gemm::BM;
  const int r_tiles = (rows + RP_ROWS - 1) / RP_ROWS;

  // a runtime call before the tensor maps: it makes the device's primary
  // context current in this host thread (autograd runs the backward in a
  // thread of its own), which libcuda's cuTensorMapEncodeTiled needs
  auto rows_k = drop ? rows_kernel<true> : rows_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(rows_k, cudaFuncAttributeMaxDynamicSharedMemorySize, RP_SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap x_k, w1_k, h_k, w2_k, dy2_k, w2_mn, da_k, w1_mn, da_mn, x_mn, dy2_mn, h_mn;
  if (!gemm::operand_map(&x_k, x, HIDDEN, rows, false) ||
      !gemm::operand_map(&w1_k, w1, HIDDEN, F, false) ||
      !gemm::operand_map(&h_k, h, F, rows, false) ||
      !gemm::operand_map(&w2_k, w2, F, HIDDEN, false) ||
      !gemm::operand_map(&dy2_k, dy2, HIDDEN, rows, false) ||
      !gemm::operand_map(&w2_mn, w2, F, HIDDEN, true) ||
      !gemm::operand_map(&da_k, da, F, rows, false) ||
      !gemm::operand_map(&w1_mn, w1, HIDDEN, F, true) ||
      !gemm::operand_map(&da_mn, da, F, rows, true) ||
      !gemm::operand_map(&x_mn, x, HIDDEN, rows, true) ||
      !gemm::operand_map(&dy2_mn, dy2, HIDDEN, rows, true) ||
      !gemm::operand_map(&h_mn, h, F, rows, true))
    return (int)cudaErrorInvalidValue;

  // 1. a = x W1^T + b1 -> h, gelu'(a)
  if ((err = gemm::run<0, 0>(x_k, w1_k, rows, F, HIDDEN, 1,
                             GeluEpi{static_cast<const float*>(b1), h, gp, F}, st)) !=
      cudaSuccess)
    return (int)err;
  // 2. y2 = h W2^T + b2
  if ((err = gemm::run<0, 0>(h_k, w2_k, rows, HIDDEN, F, 1,
                             BiasEpi{static_cast<const float*>(b2), y2}, st)) != cudaSuccess)
    return (int)err;
  // 3. the row pass
  rows_k<<<r_tiles, RP_THREADS, RP_SMEM, st>>>(
      y2, static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<const float*>(gamma), dy2, pvec, rows, eps,
      uc2::Dropout{seed, thresh, keep_scale});
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 4. dh = dy2 W2 -> da, db1 partials
  if ((err = gemm::run<0, 1>(dy2_k, w2_mn, rows, F, HIDDEN, 1, DgeluEpi{gp, da, pb1, F}, st)) !=
      cudaSuccess)
    return (int)err;
  // 5. dx = da W1 + dy_pre
  if ((err = gemm::run<0, 1>(da_k, w1_mn, rows, HIDDEN, F, 1,
                             ResidualEpi<true>{y2, static_cast<bf16*>(dx)}, st)) != cudaSuccess)
    return (int)err;
  // 6. dW1 = da^T x, dW2 = dy2^T h, straight into the outputs when unsplit
  float* o1 = S > 1 ? pw1 : static_cast<float*>(dw1);
  float* o2 = S > 1 ? pw2 : static_cast<float*>(dw2);
  if ((err = gemm::run<1, 1>(da_mn, x_mn, F, HIDDEN, rows, S, StoreEpi{o1, HIDDEN}, st)) !=
          cudaSuccess ||
      (err = gemm::run<1, 1>(dy2_mn, h_mn, HIDDEN, F, rows, S, StoreEpi{o2, F}, st)) !=
          cudaSuccess)
    return (int)err;
  // 7. the partials, in a fixed order
  const long long wn = (long long)F * HIDDEN;
  if ((S > 1 && ((err = sum_partials(pw1, S, wn, static_cast<float*>(dw1), st)) != cudaSuccess ||
                 (err = sum_partials(pw2, S, wn, static_cast<float*>(dw2), st)) != cudaSuccess)) ||
      (err = sum_partials(pb1, m_tiles, F, static_cast<float*>(db1), st)) != cudaSuccess ||
      (err = sum_partials(pvec, r_tiles, HIDDEN, static_cast<float*>(db2), st)) != cudaSuccess ||
      (err = sum_partials(pvec + (size_t)r_tiles * HIDDEN, r_tiles, HIDDEN,
                          static_cast<float*>(dgamma), st)) != cudaSuccess ||
      (err = sum_partials(pvec + (size_t)2 * r_tiles * HIDDEN, r_tiles, HIDDEN,
                          static_cast<float*>(dbeta), st)) != cudaSuccess)
    return (int)err;
  return (int)cudaSuccess;
}

// The partial mode: x [rows, 768] bf16; w1 [F, 768] and w2 [768, F] bf16
// (the shard's), F a multiple of 128; b1 [F] fp32; dy_pre [rows, 768] fp32
// (16-byte aligned); writes dx [rows, 768] bf16 (da . W1 without dy_pre),
// dw1 [F, 768], db1 [F], dw2 [768, F] and db2 [768] fp32; ws holds
// uc2_ffn_train_bwd_workspace(rows, F, max_splits, 1) bytes. drop = 0
// skips the mask. Returns the first CUDA error.
extern "C" int uc2_ffn_train_bwd_partial(const void* x, const void* w1, const void* b1,
                                         const void* w2, const void* dy_pre, void* dx, void* dw1,
                                         void* db1, void* dw2, void* db2, void* ws, int rows,
                                         int F, int max_splits, unsigned seed, unsigned thresh,
                                         float keep_scale, int drop, void* stream) {
  using namespace uc2;
  using namespace uc2::ffn_bwd;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Workspace w = workspace(rows, F, max_splits, true);
  uint8_t* base = static_cast<uint8_t*>(ws);
  bf16* h = reinterpret_cast<bf16*>(base + w.h);
  float* gp = reinterpret_cast<float*>(base + w.gp);
  bf16* da = reinterpret_cast<bf16*>(base + w.da);
  bf16* dy2 = reinterpret_cast<bf16*>(base + w.dy2);
  float* pb1 = reinterpret_cast<float*>(base + w.pb1);
  float* pvec = reinterpret_cast<float*>(base + w.pvec);
  float* pw1 = reinterpret_cast<float*>(base + w.pw1);
  float* pw2 = reinterpret_cast<float*>(base + w.pw2);
  const int S = wgrad_splits(rows, max_splits);
  const int m_tiles = (rows + gemm::BM - 1) / gemm::BM;
  const int r_tiles = (rows + RP_ROWS - 1) / RP_ROWS;
  constexpr int MASK_SMEM = RP_WARPS * HIDDEN * 4;

  // a runtime call first (uc2_ffn_train_bwd says why)
  auto mask_k = drop ? mask_rows_kernel<true> : mask_rows_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(mask_k, cudaFuncAttributeMaxDynamicSharedMemorySize, MASK_SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap x_k, w1_k, dy2_k, w2_mn, da_k, w1_mn, da_mn, x_mn, dy2_mn, h_mn;
  if (!gemm::operand_map(&x_k, x, HIDDEN, rows, false) ||
      !gemm::operand_map(&w1_k, w1, HIDDEN, F, false) ||
      !gemm::operand_map(&dy2_k, dy2, HIDDEN, rows, false) ||
      !gemm::operand_map(&w2_mn, w2, F, HIDDEN, true) ||
      !gemm::operand_map(&da_k, da, F, rows, false) ||
      !gemm::operand_map(&w1_mn, w1, HIDDEN, F, true) ||
      !gemm::operand_map(&da_mn, da, F, rows, true) ||
      !gemm::operand_map(&x_mn, x, HIDDEN, rows, true) ||
      !gemm::operand_map(&dy2_mn, dy2, HIDDEN, rows, true) ||
      !gemm::operand_map(&h_mn, h, F, rows, true))
    return (int)cudaErrorInvalidValue;

  // 1. a = x W1^T + b1 -> h, gelu'(a)
  if ((err = gemm::run<0, 0>(x_k, w1_k, rows, F, HIDDEN, 1,
                             GeluEpi{static_cast<const float*>(b1), h, gp, F}, st)) !=
      cudaSuccess)
    return (int)err;
  // 3. the mask pass
  mask_k<<<r_tiles, RP_THREADS, MASK_SMEM, st>>>(static_cast<const float*>(dy_pre), dy2, pvec,
                                                  rows, uc2::Dropout{seed, thresh, keep_scale});
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 4. dh = dy2 W2 -> da, db1 partials
  if ((err = gemm::run<0, 1>(dy2_k, w2_mn, rows, F, HIDDEN, 1, DgeluEpi{gp, da, pb1, F}, st)) !=
      cudaSuccess)
    return (int)err;
  // 5. dx_part = da W1
  if ((err = gemm::run<0, 1>(da_k, w1_mn, rows, HIDDEN, F, 1,
                             ResidualEpi<false>{nullptr, static_cast<bf16*>(dx)}, st)) !=
      cudaSuccess)
    return (int)err;
  // 6. dW1 = da^T x, dW2 = dy2^T h
  float* o1 = S > 1 ? pw1 : static_cast<float*>(dw1);
  float* o2 = S > 1 ? pw2 : static_cast<float*>(dw2);
  if ((err = gemm::run<1, 1>(da_mn, x_mn, F, HIDDEN, rows, S, StoreEpi{o1, HIDDEN}, st)) !=
          cudaSuccess ||
      (err = gemm::run<1, 1>(dy2_mn, h_mn, HIDDEN, F, rows, S, StoreEpi{o2, F}, st)) !=
          cudaSuccess)
    return (int)err;
  // 7. the partials, in a fixed order
  const long long wn = (long long)F * HIDDEN;
  if ((S > 1 && ((err = sum_partials(pw1, S, wn, static_cast<float*>(dw1), st)) != cudaSuccess ||
                 (err = sum_partials(pw2, S, wn, static_cast<float*>(dw2), st)) != cudaSuccess)) ||
      (err = sum_partials(pb1, m_tiles, F, static_cast<float*>(db1), st)) != cudaSuccess ||
      (err = sum_partials(pvec, r_tiles, HIDDEN, static_cast<float*>(db2), st)) != cudaSuccess)
    return (int)err;
  return (int)cudaSuccess;
}
