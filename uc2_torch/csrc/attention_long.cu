// Attention forward for long joint lengths: out = softmax(q.k^T / sqrt(d) + bias) . v
//
// Replaces the TPU kernel uc2_tpu/ops/flash_attention.py:_attn_kernel
// (launched by _fwd_pallas), which the reference's flash_attention runs in
// place of the batch-blocked kernel when n * L^2 * 4 bytes > 8 MiB, that is
// joint L >= 419 at 12 heads: a training step at dropout 0 under "pallas"
// on long captions (its backward is the eager recompute).
//
// What it computes is _attn_kernel's: fp32 scores * (1 / sqrt(d)) + bias, a
// max-shifted softmax normalised in fp32 and rounded to bf16, P . V with
// fp32 sums, a bf16 context in the [B, L, n, d] layout; q, k, v may be
// strided views into the fused QKV projection.
//
// Design: attention.cu (#1) keeps [64, L] fp32 score rows in shared memory,
// so its shared memory grows with L (207 KB at 512). This kernel keeps none:
// one block of 4 warps per (64 query rows, head, batch row), each warp 16
// rows whose Q fragments stay in registers, and 64-key tiles of K (and V)
// streamed through a two-stage cp.async ring (37 KB, whatever L). It sweeps
// the keys twice:
//   1. scores of each K tile, folded into each row's running max and sum
//      (every lane keeps its own columns' pair; the four lanes of a row
//      merge theirs after the sweep);
//   2. the scores again, P = exp(s - max) * (1 / sum) rounded to bf16
//      straight from the accumulator registers into mma A fragments, and
//      the context += P . V, V read through ldmatrix.trans.
// So the probabilities are rounded after normalisation, where the reference
// rounds them; the row sum is taken in another order (online), which moves
// P by fp32 rounding only. The second sweep recomputes Q . K^T: 6 L^2 d
// products a row and head against the 4 L^2 d of the function.
//
// What bounds it on an H100: at B = 16, L = 512, 12 heads of 64 it reads q,
// k, v and writes the context, 50 MB (15 us at 3.35 TB/s), against 12.9
// GFLOP of products counted once (13 us at 989 TFLOP/s): bytes, barely.
// mma.sync rather than wgmma and the recompute keep it well above that.
#include "common.cuh"

namespace uc2 {

constexpr int LONG_WARPS = 4, LONG_QT = 64, LONG_KT = 64;

__global__ void __launch_bounds__(LONG_WARPS * 32)
    attn_long_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     bf16* __restrict__ out, int L, int n, int rs, float scale) {
  constexpr int KT = LONG_KT, THREADS = LONG_WARPS * 32;
  __shared__ __align__(16) bf16 sK[2][KT * K_STRIDE];
  __shared__ __align__(16) bf16 sV[2][KT * K_STRIDE];
  __shared__ float sB[2][KT];
  const int q0 = blockIdx.x * LONG_QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)b * L * rs + (size_t)h * HEAD_DIM;
  const float* bias_row = bias + (size_t)b * L;
  const int n_tiles = (L + KT - 1) / KT, steps = 2 * n_tiles;

  // step s stages K tile s mod n_tiles, and its V in the second sweep
  auto stage = [&](int s, int buf) {
    const int k0 = (s % n_tiles) * KT;
    const bool with_v = s >= n_tiles;
    for (int i = tid; i < KT * 8; i += THREADS) {
      const int r = i >> 3, c = (i & 7) * 8, key = k0 + r;
      bf16* dk = &sK[buf][r * K_STRIDE + c];
      bf16* dv = &sV[buf][r * K_STRIDE + c];
      if (key < L) {
        cp_async16(dk, k + base + (size_t)key * rs + c);
        if (with_v) cp_async16(dv, v + base + (size_t)key * rs + c);
      } else {
        *reinterpret_cast<uint4*>(dk) = make_uint4(0u, 0u, 0u, 0u);
        if (with_v) *reinterpret_cast<uint4*>(dv) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    for (int i = tid; i < KT; i += THREADS)
      sB[buf][i] = k0 + i < L ? bias_row[k0 + i] : -INFINITY;
    cp_async_commit();
  };

  stage(0, 0);

  // Q fragments of this warp's rows r0 and r0 + 8
  uint32_t qa[HEAD_DIM / 16][4];
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int ks = 0; ks < HEAD_DIM / 16; ++ks) {
    const int c = ks * 16 + t * 2;
    qa[ks][0] = r0 < L ? ldg32(q + base + (size_t)r0 * rs + c) : 0u;
    qa[ks][1] = r1 < L ? ldg32(q + base + (size_t)r1 * rs + c) : 0u;
    qa[ks][2] = r0 < L ? ldg32(q + base + (size_t)r0 * rs + c + 8) : 0u;
    qa[ks][3] = r1 < L ? ldg32(q + base + (size_t)r1 * rs + c + 8) : 0u;
  }

  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, inv[2];
  float o[HEAD_DIM / 8][4];
#pragma unroll
  for (int p = 0; p < HEAD_DIM / 8; ++p) o[p][0] = o[p][1] = o[p][2] = o[p][3] = 0.f;

  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) {
      stage(s + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (s == n_tiles) {  // merge the four lanes of each row; 1 / sum
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          const float m2 = __shfl_xor_sync(0xffffffffu, mx[hi], off);
          const float l2 = __shfl_xor_sync(0xffffffffu, sum[hi], off);
          const float mn = fmaxf(mx[hi], m2);
          sum[hi] = (mx[hi] == -INFINITY ? 0.f : sum[hi] * expf(mx[hi] - mn)) +
                    (m2 == -INFINITY ? 0.f : l2 * expf(m2 - mn));
          mx[hi] = mn;
        }
        inv[hi] = 1.f / sum[hi];
      }
    }

    // scores of the warp's 16 rows against the tile's 64 keys
    float c[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < HEAD_DIM / 16; ++ks) {
        const bf16* kr = &sK[buf][(j * 8 + g) * K_STRIDE + ks * 16 + t * 2];
        mma16816(c[j], qa[ks], ld32(kr), ld32(kr + 8));
      }
      const float b0 = sB[buf][j * 8 + t * 2], b1 = sB[buf][j * 8 + t * 2 + 1];
      c[j][0] = c[j][0] * scale + b0;
      c[j][1] = c[j][1] * scale + b1;
      c[j][2] = c[j][2] * scale + b0;
      c[j][3] = c[j][3] * scale + b1;
    }

    if (s < n_tiles) {  // sweep 1: running max and sum of this lane's columns
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float tm = -INFINITY;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) tm = fmaxf(tm, fmaxf(c[j][2 * hi], c[j][2 * hi + 1]));
        const float mn = fmaxf(mx[hi], tm);
        if (mn != -INFINITY) {
          float add = 0.f;
#pragma unroll
          for (int j = 0; j < KT / 8; ++j)
            add += expf(c[j][2 * hi] - mn) + expf(c[j][2 * hi + 1] - mn);
          sum[hi] = sum[hi] * expf(mx[hi] - mn) + add;
          mx[hi] = mn;
        }
      }
    } else {  // sweep 2: P rounded to bf16, context += P . V
      const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack2(expf(c[2 * kk][0] - mx[0]) * inv[0], expf(c[2 * kk][1] - mx[0]) * inv[0]);
        a[1] = pack2(expf(c[2 * kk][2] - mx[1]) * inv[1], expf(c[2 * kk][3] - mx[1]) * inv[1]);
        a[2] = pack2(expf(c[2 * kk + 1][0] - mx[0]) * inv[0],
                     expf(c[2 * kk + 1][1] - mx[0]) * inv[0]);
        a[3] = pack2(expf(c[2 * kk + 1][2] - mx[1]) * inv[1],
                     expf(c[2 * kk + 1][3] - mx[1]) * inv[1]);
#pragma unroll
        for (int np = 0; np < HEAD_DIM / 16; ++np) {
          uint32_t r[4];
          ldsm_x4_trans(r, &sV[buf][(kk * 16 + (mi & 1) * 8 + rr) * K_STRIDE +
                                    (2 * np + (mi >> 1)) * 8]);
          mma16816(o[2 * np], a, r[0], r[1]);
          mma16816(o[2 * np + 1], a, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // buffer buf is staged again at step s + 2
  }

  const int grs = n * HEAD_DIM;
  bf16* ob = out + (size_t)b * L * grs + (size_t)h * HEAD_DIM;
#pragma unroll
  for (int p = 0; p < HEAD_DIM / 8; ++p) {
    const int col = p * 8 + t * 2;
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * grs + col) = pack2(o[p][0], o[p][1]);
    if (r1 < L)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * grs + col) = pack2(o[p][2], o[p][3]);
  }
}

}  // namespace uc2

// q, k, v: [B, L, n, 64] bf16, tokens rs elements apart; bias [B, L] fp32;
// out [B, L, n, 64] bf16 contiguous; 1 <= L <= 512. Returns
// cudaGetLastError().
extern "C" int uc2_attn_long_fwd(const void* q, const void* k, const void* v,
                                 const void* bias, void* out, int B, int L, int n,
                                 int rs, float scale, void* stream) {
  using namespace uc2;
  if (L < 1 || L > MAX_LEN) return (int)cudaErrorInvalidValue;
  dim3 grid((L + LONG_QT - 1) / LONG_QT, n, B);
  attn_long_kernel<<<grid, LONG_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(out), L, n, rs, scale);
  return (int)cudaGetLastError();
}
