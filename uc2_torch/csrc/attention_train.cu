// Training attention with attention-probs dropout: the backward (#6), and
// the C entry of the forward (#5).
//
// Replace the TPU kernel uc2_tpu/ops/flash_attention.py
// _attn_train_bwd_kernel (launched by _bwd_train), which every layer of
// the uc2-base mlm step runs (attention dropout 0.1). The forward,
// _attn_train_fwd_kernel (launched by _fwd_train), is the streamed core of
// attention_stream.cuh, which kernel #4 shares; uc2_attn_train_fwd below
// only launches it.
//
// Dropout: the TPU kernels draw a per-grid-cell PRNG stream, so their
// forward and backward had to share one grid geometry. Here the keep bit of
// score (b, h, i, j) is Philox4x32-10 of its global index (philox.cuh), so
// the forward and the backward use different tiles and still draw the same
// mask.
//
// Backward (#6) for L <= 256: one block of 8 warps per (head, batch row). K and V stay
// in shared memory; the block walks 64-row query tiles and for each
// recomputes the fp32 scores, P and the mask, then
//   D   = rowsum(dP * P),  dP = keep ? (g . V^T) / (1 - rate) : 0
//   dV += Pd^T . g                    (Pd rounded to bf16)
//   dS  = P * (dP - D)                (g . V^T recomputed: no second tile)
//   dK += dS^T . Q,  dQ = dS . K      (dS rounded to bf16)
// and writes that tile's dQ. dK and dV of all keys accumulate in fp32
// registers (warp w owns key rows 16w.. and 16(w + 8)..), which is what
// caps the kernel at L = 256; dbias partials (dS summed over queries)
// accumulate in shared memory per m-tile and are written once per head,
// for the wrapper to sum over heads. No atomics: one seed gives the same
// bits every run. Bound by bytes: 223 MB at B = 128, L = 162 (66 us)
// against 25.8 GFLOP.
//
// Backward (#6) for 256 < L <= 512: the registers cannot hold dK and dV of
// every key, so the work splits in two kernels, still without atomics:
//   dQ kernel, one block of 8 warps per (64 query rows, head, batch row):
//     fp32 score rows in shared memory (K, then V, then K again
//     through one region), P in place, D = rowsum(dP * P), dS = P (dP - D)
//     in place, dQ = dS . K (dS rounded to bf16 as its A fragments are
//     built); writes dQ and the rows' max, 1 / sum and D as [3][B, n, L]
//     fp32 (225 KB of shared memory at L = 512).
//   dK/dV kernel, one block of 8 warps per (128 keys, head, batch row):
//     walks the 64-row query tiles; per tile it recomputes the scores of
//     its keys, P = exp(s - max) / sum from those statistics (bitwise the
//     dQ kernel's P: the same products and the same fp32 operations), the
//     mask from Philox, and accumulates dV += Pd^T . g and dK += dS^T . Q in
//     registers (warp w owns key rows 16w..16w + 15) and dS summed over the
//     queries in shared memory; writes dK, dV and the per-head dbias
//     partials [B, n, L].
// Each pass reads q, k, v and g once per block row of the other operand
// from L2; together they recompute the scores three times.
#include "attention_stream.cuh"

namespace uc2 {

constexpr int TRAIN_MAX_LEN = 256;  // the single-kernel backward's register-resident dK, dV

// four consecutive bf16 from four floats (8-byte store)
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(a, b), pack2(c, d));
}

// One softmax row held by a warp in 4-key groups: lane takes keys
// 4 (lane + 32 u) .. + 3. Loads the fp32 scores of row srow and leaves
// e = exp(s - max) * (1 / sum) in place of them in registers; the row's max
// and 1 / sum go to mx_out and inv_out.
template <int NG>
__device__ __forceinline__ void softmax_groups(const float* srow, int Lp,
                                               float4 (&e)[NG], float& mx_out,
                                               float& inv_out) {
  const int lane = threadIdx.x & 31;
  float mx = -INFINITY;
#pragma unroll
  for (int u = 0; u < NG; ++u) {
    const int c = 4 * (lane + 32 * u);
    e[u] = c < Lp ? *reinterpret_cast<const float4*>(srow + c)
                  : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    mx = fmaxf(mx, fmaxf(fmaxf(e[u].x, e[u].y), fmaxf(e[u].z, e[u].w)));
  }
  mx = warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < NG; ++u) {
    e[u].x = expf(e[u].x - mx);
    e[u].y = expf(e[u].y - mx);
    e[u].z = expf(e[u].z - mx);
    e[u].w = expf(e[u].w - mx);
    sum += (e[u].x + e[u].y) + (e[u].z + e[u].w);
  }
  const float inv = 1.f / warp_sum(sum);
#pragma unroll
  for (int u = 0; u < NG; ++u) {
    e[u].x *= inv;
    e[u].y *= inv;
    e[u].z *= inv;
    e[u].w *= inv;
  }
  mx_out = mx;
  inv_out = inv;
}

template <int NG>
__device__ __forceinline__ void softmax_groups(const float* srow, int Lp,
                                               float4 (&e)[NG]) {
  float mx, inv;
  softmax_groups<NG>(srow, Lp, e, mx, inv);
}

// keep ? p * keep_scale : 0 for the four keys of a group
__device__ __forceinline__ float4 drop4(float4 p, uint32_t kb, float s) {
  return make_float4(kb & 1 ? p.x * s : 0.f, kb & 2 ? p.y * s : 0.f,
                     kb & 4 ? p.z * s : 0.f, kb & 8 ? p.w * s : 0.f);
}

// -------------------------------------------------------------- backward
constexpr int BWD_WARPS = 8, BWD_QT = 64;

// Shared memory of the backward at padded length Lp, in this order:
__host__ __device__ inline int bwd_p_stride(int Lp) { return Lp + 8; }  // bf16
struct BwdSmem {
  float* bias;   // [Lp]
  bf16* K;       // [Lp][K_STRIDE]
  bf16* V;       // [Lp][K_STRIDE]
  bf16* Q;       // [QT][K_STRIDE] this tile's queries
  bf16* G;       // [QT][K_STRIDE] this tile's output gradient
  float* S;      // [QT][score_stride(Lp)] scores, then P (fp32)
  bf16* P;       // [QT][bwd_p_stride(Lp)] Pd, then dS (bf16)
  uint8_t* M;    // [QT][Lp / 4] keep bits, 4 keys a byte
  float* D;      // [2][QT] halves of rowsum(dP * P)
  float* dbias;  // [4][Lp] dS summed over the queries of each m-tile
};

__host__ __device__ inline size_t bwd_smem_bytes(int Lp) {
  return (size_t)Lp * 4 + 2 * (size_t)Lp * K_STRIDE * 2 + 2 * (size_t)BWD_QT * K_STRIDE * 2 +
         (size_t)BWD_QT * score_stride(Lp) * 4 + (size_t)BWD_QT * bwd_p_stride(Lp) * 2 +
         (size_t)BWD_QT * (Lp / 4) + 2 * BWD_QT * 4 + 4 * (size_t)Lp * 4;
}

__device__ inline BwdSmem bwd_smem(uint8_t* smem, int Lp) {
  BwdSmem s;
  s.bias = reinterpret_cast<float*>(smem);
  s.K = reinterpret_cast<bf16*>(s.bias + Lp);
  s.V = s.K + Lp * K_STRIDE;
  s.Q = s.V + Lp * K_STRIDE;
  s.G = s.Q + BWD_QT * K_STRIDE;
  s.S = reinterpret_cast<float*>(s.G + BWD_QT * K_STRIDE);
  s.P = reinterpret_cast<bf16*>(s.S + BWD_QT * score_stride(Lp));
  s.M = reinterpret_cast<uint8_t*>(s.P + BWD_QT * bwd_p_stride(Lp));
  s.D = reinterpret_cast<float*>(s.M + BWD_QT * (Lp / 4));
  s.dbias = s.D + 2 * BWD_QT;
  return s;
}

// A fragments (rows m*16 + g, + 8; columns 16 ks + 2t, + 8) of a [rows][K_STRIDE] tile
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[HEAD_DIM / 16][4], const bf16* tile,
                                             int m) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* r0 = tile + (m * 16 + g) * K_STRIDE + t * 2;
#pragma unroll
  for (int ks = 0; ks < HEAD_DIM / 16; ++ks) {
    a[ks][0] = ld32(r0 + ks * 16);
    a[ks][1] = ld32(r0 + 8 * K_STRIDE + ks * 16);
    a[ks][2] = ld32(r0 + ks * 16 + 8);
    a[ks][3] = ld32(r0 + 8 * K_STRIDE + ks * 16 + 8);
  }
}

// c = A . B for one 16 x 8 tile: A fragments over the head dim, B the 8
// rows [8 j, 8 j + 8) of a [keys][K_STRIDE] tile (K or V), k contiguous
__device__ __forceinline__ void rows_times_keys(float (&c)[4], const uint32_t (&a)[HEAD_DIM / 16][4],
                                                const bf16* keys, int j) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HEAD_DIM / 16; ++ks) {
    const bf16* kr = keys + (j * 8 + g) * K_STRIDE + ks * 16 + t * 2;
    mma16816(c, a[ks], ld32(kr), ld32(kr + 8));
  }
}

// acc[kk][nt] += X^T . Y over this tile's 64 queries, for the key m-tiles
// warp + 8 kk: X is the [QT][xs] bf16 tile P (Pd or dS, keys along a row),
// Y the [QT][K_STRIDE] tile G or Q (head dim along a row).
template <int KM>
__device__ __forceinline__ void accumulate_keys(float (&acc)[KM][8][4], const bf16* X, int xs,
                                                const bf16* Y, int n_mtiles) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int qs = 0; qs < BWD_QT / 16; ++qs) {
    uint32_t bfr[8][2];
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t r[4];
      ldsm_x4_trans(r, Y + (qs * 16 + (mi & 1) * 8 + rr) * K_STRIDE + (2 * np + (mi >> 1)) * 8);
      bfr[2 * np][0] = r[0];
      bfr[2 * np][1] = r[1];
      bfr[2 * np + 1][0] = r[2];
      bfr[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int kk = 0; kk < KM; ++kk) {
      const int km = warp + BWD_WARPS * kk;
      if (km < n_mtiles) {
        uint32_t a[4];
        ldsm_x4_trans(a, X + (qs * 16 + (mi >> 1) * 8 + rr) * xs + km * 16 + (mi & 1) * 8);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma16816(acc[kk][nt], a, bfr[nt][0], bfr[nt][1]);
      }
    }
  }
}

template <int NC, bool DROP>
__global__ void __launch_bounds__(BWD_WARPS * 32, 1)
    attn_train_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ bias,
                          const bf16* __restrict__ gout, bf16* __restrict__ dq,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          float* __restrict__ dbias_part, int L, int n, int rs,
                          float scale, Dropout dr) {
  constexpr int QT = BWD_QT, NG = (NC + 3) / 4, KM = NC <= 4 ? 1 : 2;
  static_assert(NC * 32 <= TRAIN_MAX_LEN, "score chunks");
  extern __shared__ __align__(16) uint8_t smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int Lp = padded_len(L), SF = score_stride(Lp), PS = bwd_p_stride(Lp);
  const int MS = Lp / 4, n_mtiles = Lp / 16;
  const BwdSmem sm = bwd_smem(smem, Lp);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m = warp & 3, jp = warp >> 2;  // score tiles: m-tile m, key tiles j = jp mod 2
  const uint32_t bh = (uint32_t)(b * n + h);
  const size_t base = (size_t)b * L * rs + (size_t)h * HEAD_DIM;
  const int grs = n * HEAD_DIM;  // token stride of g, dq, dk, dv
  const size_t gbase = (size_t)b * L * grs + (size_t)h * HEAD_DIM;

  for (int i = tid; i < Lp; i += BWD_WARPS * 32)
    sm.bias[i] = i < L ? bias[(size_t)b * L + i] : -INFINITY;
  for (int i = tid; i < 4 * Lp; i += BWD_WARPS * 32) sm.dbias[i] = 0.f;
  for (int i = tid; i < Lp * 8; i += BWD_WARPS * 32) {
    const int key = i >> 3, c = (i & 7) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (key < L) {
      kv = *reinterpret_cast<const uint4*>(k + base + (size_t)key * rs + c);
      vv = *reinterpret_cast<const uint4*>(v + base + (size_t)key * rs + c);
    }
    *reinterpret_cast<uint4*>(sm.K + key * K_STRIDE + c) = kv;
    *reinterpret_cast<uint4*>(sm.V + key * K_STRIDE + c) = vv;
  }
  float dka[KM][8][4], dva[KM][8][4];
#pragma unroll
  for (int kk = 0; kk < KM; ++kk)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[kk][nt][e] = dva[kk][nt][e] = 0.f;

  // dP of one score from g . v^T and the stored keep bits
  auto dprob = [&](float dpd, int row, int col) -> float {
    if constexpr (DROP)
      return (sm.M[row * MS + (col >> 2)] >> (col & 3)) & 1 ? dpd * dr.keep_scale : 0.f;
    else
      return dpd;
  };

  for (int q0 = 0; q0 < L; q0 += QT) {
    __syncthreads();  // staging done; the previous tile's readers are done
    for (int i = tid; i < QT * 8; i += BWD_WARPS * 32) {
      const int r = i >> 3, c = (i & 7) * 8, row = q0 + r;
      uint4 qv = make_uint4(0u, 0u, 0u, 0u), gv = qv;
      if (row < L) {
        qv = *reinterpret_cast<const uint4*>(q + base + (size_t)row * rs + c);
        gv = *reinterpret_cast<const uint4*>(gout + gbase + (size_t)row * grs + c);
      }
      *reinterpret_cast<uint4*>(sm.Q + r * K_STRIDE + c) = qv;
      *reinterpret_cast<uint4*>(sm.G + r * K_STRIDE + c) = gv;
    }
    __syncthreads();

    // 1. scores * scale + bias into S
    {
      uint32_t qa[HEAD_DIM / 16][4];
      load_a_frags(qa, sm.Q, m);
      for (int j = jp; j < Lp / 8; j += 2) {
        float c[4];
        rows_times_keys(c, qa, sm.K, j);
        const int key = j * 8 + t * 2;
        const float b0 = sm.bias[key], b1 = sm.bias[key + 1];
        float* s0 = sm.S + (m * 16 + g) * SF + key;
        *reinterpret_cast<float2*>(s0) = make_float2(c[0] * scale + b0, c[1] * scale + b1);
        *reinterpret_cast<float2*>(s0 + 8 * SF) =
            make_float2(c[2] * scale + b0, c[3] * scale + b1);
      }
    }
    __syncthreads();

    // 2. P (fp32, in place in S), Pd (bf16) and the keep bits, a row per warp
    for (int r = warp; r < QT; r += BWD_WARPS) {
      float* srow = sm.S + r * SF;
      float4 e[NG];
      softmax_groups<NG>(srow, Lp, e);
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        const int c = 4 * (lane + 32 * u);
        if (c < Lp) {
          *reinterpret_cast<float4*>(srow + c) = e[u];
          float4 pd = e[u];
          if constexpr (DROP) {
            const uint32_t kb = keep_bits4(dr.seed, dr.thresh, c >> 2, q0 + r, bh);
            pd = drop4(e[u], kb, dr.keep_scale);
            sm.M[r * MS + (c >> 2)] = (uint8_t)kb;
          }
          store4(sm.P + r * PS + c, pd.x, pd.y, pd.z, pd.w);
        }
      }
    }
    __syncthreads();

    // 3. D = rowsum(dP * P), from this warp's key tiles, halves in D[jp]
    {
      uint32_t ga[HEAD_DIM / 16][4];
      load_a_frags(ga, sm.G, m);
      float part[2] = {0.f, 0.f};
      for (int j = jp; j < Lp / 8; j += 2) {
        float c[4];
        rows_times_keys(c, ga, sm.V, j);
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
#pragma unroll
          for (int lo = 0; lo < 2; ++lo) {
            const int row = m * 16 + g + 8 * hi, col = j * 8 + t * 2 + lo;
            part[hi] += dprob(c[2 * hi + lo], row, col) * sm.S[row * SF + col];
          }
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float s = part[hi];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (t == 0) sm.D[jp * QT + m * 16 + g + 8 * hi] = s;
      }
    }

    // 4. dV += Pd^T . g
    accumulate_keys<KM>(dva, sm.P, PS, sm.G, n_mtiles);
    __syncthreads();  // D is complete; every reader of Pd is done

    // 5. dS = P * (dP - D) over Pd, and dS summed over this m-tile's queries
    {
      uint32_t ga[HEAD_DIM / 16][4];
      load_a_frags(ga, sm.G, m);
      float dsum[2];
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = m * 16 + g + 8 * hi;
        dsum[hi] = sm.D[row] + sm.D[QT + row];
      }
      for (int j = jp; j < Lp / 8; j += 2) {
        float c[4];
        rows_times_keys(c, ga, sm.V, j);
        float cs[2] = {0.f, 0.f};
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int row = m * 16 + g + 8 * hi, col = j * 8 + t * 2;
          float ds[2];
#pragma unroll
          for (int lo = 0; lo < 2; ++lo) {
            ds[lo] = sm.S[row * SF + col + lo] * (dprob(c[2 * hi + lo], row, col + lo) - dsum[hi]);
            cs[lo] += ds[lo];
          }
          *reinterpret_cast<uint32_t*>(sm.P + row * PS + col) = pack2(ds[0], ds[1]);
        }
#pragma unroll
        for (int lo = 0; lo < 2; ++lo) {
          float s = cs[lo];
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          s += __shfl_xor_sync(0xffffffffu, s, 8);
          s += __shfl_xor_sync(0xffffffffu, s, 16);
          if (g == 0) sm.dbias[m * Lp + j * 8 + t * 2 + lo] += s;
        }
      }
    }
    __syncthreads();

    // 6. dK += dS^T . Q
    accumulate_keys<KM>(dka, sm.P, PS, sm.Q, n_mtiles);

    // 7. dQ = dS . K * scale: m-tile m, head-dim tiles 4 jp .. 4 jp + 3
    {
      float acc[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.f;
      const int mi = lane >> 3, rr = lane & 7;
      const bf16* pr = sm.P + (m * 16 + g) * PS + t * 2;
      for (int kk = 0; kk < Lp / 16; ++kk) {
        uint32_t a[4];
        a[0] = ld32(pr + kk * 16);
        a[1] = ld32(pr + 8 * PS + kk * 16);
        a[2] = ld32(pr + kk * 16 + 8);
        a[3] = ld32(pr + 8 * PS + kk * 16 + 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldsm_x4_trans(r, sm.K + (kk * 16 + (mi & 1) * 8 + rr) * K_STRIDE +
                               (4 * jp + 2 * np + (mi >> 1)) * 8);
          mma16816(acc[2 * np], a, r[0], r[1]);
          mma16816(acc[2 * np + 1], a, r[2], r[3]);
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int col = (4 * jp + p) * 8 + t * 2;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int row = q0 + m * 16 + g + 8 * hi;
          if (row < L)
            *reinterpret_cast<uint32_t*>(dq + gbase + (size_t)row * grs + col) =
                pack2(acc[p][2 * hi] * scale, acc[p][2 * hi + 1] * scale);
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < KM; ++kk) {
    const int km = warp + BWD_WARPS * kk;
    if (km >= n_mtiles) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + t * 2;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int key = km * 16 + g + 8 * hi;
        if (key < L) {
          const size_t o = gbase + (size_t)key * grs + col;
          *reinterpret_cast<uint32_t*>(dk + o) =
              pack2(dka[kk][nt][2 * hi] * scale, dka[kk][nt][2 * hi + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + o) =
              pack2(dva[kk][nt][2 * hi], dva[kk][nt][2 * hi + 1]);
        }
      }
    }
  }
  if (dbias_part != nullptr) {
    __syncthreads();
    for (int c = tid; c < L; c += BWD_WARPS * 32)
      dbias_part[(size_t)bh * L + c] =
          ((sm.dbias[c] + sm.dbias[Lp + c]) + sm.dbias[2 * Lp + c]) + sm.dbias[3 * Lp + c];
  }
}

// ------------------------------------------ backward, 256 < L <= 512 (split)
constexpr int SPLIT_WARPS = 8, SPLIT_QT = 64, SPLIT_KT = 128;

// rows [row0, row0 + rows) of a [tokens][src_rs] bf16 tensor (64 wide) into
// [rows][K_STRIDE] shared memory, zero past L
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src,
                                           int src_rs, int row0, int rows, int L) {
  for (int i = threadIdx.x; i < rows * 8; i += blockDim.x) {
    const int r = i >> 3, c = (i & 7) * 8, row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < L) val = *reinterpret_cast<const uint4*>(src + (size_t)row * src_rs + c);
    *reinterpret_cast<uint4*>(dst + r * K_STRIDE + c) = val;
  }
}

// dP of one score from g . v^T and the keep bits stored 4 keys a byte
template <bool DROP>
__device__ __forceinline__ float drop_grad(float dpd, const uint8_t* M, int ms, int row,
                                           int col, float keep_scale) {
  if constexpr (DROP)
    return (M[row * ms + (col >> 2)] >> (col & 3)) & 1 ? dpd * keep_scale : 0.f;
  else
    return dpd;
}

// two fp32 values of shared memory rounded to a bf16 pair (an A fragment word)
__device__ __forceinline__ uint32_t pack2_at(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return pack2(v.x, v.y);
}

// dQ kernel: shared memory of attend_head (bias, score rows, one K/V
// region), then the g tile [QT][K_STRIDE], the keep bits [QT][Lp / 4] and
// the two halves of D [2][QT].
__host__ __device__ inline size_t dq_smem_bytes(int L) {
  const int Lp = padded_len(L);
  return attend_smem_bytes(SPLIT_QT, L) + (size_t)SPLIT_QT * K_STRIDE * 2 +
         (size_t)SPLIT_QT * (Lp / 4) + 2 * SPLIT_QT * 4;
}

// stats: [3][B, n, L] fp32 (row max, 1 / row sum, D)
template <int NC, bool DROP>
__global__ void __launch_bounds__(SPLIT_WARPS * 32, 1)
    attn_train_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const float* __restrict__ bias,
                             const bf16* __restrict__ gout, bf16* __restrict__ dq,
                             float* __restrict__ stats, int L, int n, int rs, float scale,
                             Dropout dr) {
  constexpr int WARPS = SPLIT_WARPS, QT = SPLIT_QT, NG = (NC + 3) / 4;
  extern __shared__ __align__(16) uint8_t smem[];
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int Lp = padded_len(L), SF = score_stride(Lp), MS = Lp / 4;
  const AttnSmem sm = attn_smem(smem, Lp, QT);
  bf16* G = reinterpret_cast<bf16*>(smem + attend_smem_bytes(QT, L));
  uint8_t* M = reinterpret_cast<uint8_t*>(G + QT * K_STRIDE);
  float* Dh = reinterpret_cast<float*>(M + QT * MS);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m = warp & 3, jp = warp >> 2;  // m-tile m, key tiles j = jp mod 2
  const uint32_t bh = (uint32_t)(b * n + h);
  const size_t base = (size_t)b * L * rs + (size_t)h * HEAD_DIM;
  const int grs = n * HEAD_DIM;  // token stride of g and dq
  const size_t gbase = (size_t)b * L * grs + (size_t)h * HEAD_DIM;
  const size_t bnl = (size_t)gridDim.z * n * L;
  float* st = stats + (size_t)bh * L;

  // 1. the g tile, then fp32 scores * scale + bias of the tile's rows; K in KV
  stage_rows(G, gout + gbase, grs, q0, QT, L);
  attn_scores<WARPS, QT>(q + base, k + base, rs, bias + (size_t)b * L, L, q0, scale, smem);

  // 2. P (fp32) in place, the keep bits, each row's max and 1 / sum
  for (int r = warp; r < QT; r += WARPS) {
    float* srow = sm.S + r * SF;
    float4 e[NG];
    float mx, inv;
    softmax_groups<NG>(srow, Lp, e, mx, inv);
#pragma unroll
    for (int u = 0; u < NG; ++u) {
      const int c = 4 * (lane + 32 * u);
      if (c < Lp) {
        *reinterpret_cast<float4*>(srow + c) = e[u];
        if constexpr (DROP) M[r * MS + (c >> 2)] = (uint8_t)keep_bits4(dr.seed, dr.thresh, c >> 2, q0 + r, bh);
      }
    }
    if (lane == 0 && q0 + r < L) {
      st[q0 + r] = mx;
      st[bnl + q0 + r] = inv;
    }
  }
  __syncthreads();

  // 3. V over K
  stage_rows(sm.KV, v + base, rs, 0, Lp, L);
  __syncthreads();

  // 4. D = rowsum(dP * P), halves by key-tile parity in Dh[jp]
  uint32_t ga[HEAD_DIM / 16][4];
  load_a_frags(ga, G, m);
  {
    float part[2] = {0.f, 0.f};
    for (int j = jp; j < Lp / 8; j += 2) {
      float c[4];
      rows_times_keys(c, ga, sm.KV, j);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
#pragma unroll
        for (int lo = 0; lo < 2; ++lo) {
          const int row = m * 16 + g + 8 * hi, col = j * 8 + t * 2 + lo;
          part[hi] += drop_grad<DROP>(c[2 * hi + lo], M, MS, row, col, dr.keep_scale) *
                      sm.S[row * SF + col];
        }
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float s = part[hi];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t == 0) Dh[jp * QT + m * 16 + g + 8 * hi] = s;
    }
  }
  __syncthreads();

  // 5. dS = P * (dP - D) in place (fp32); D to device memory
  {
    float dsum[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = m * 16 + g + 8 * hi;
      dsum[hi] = Dh[row] + Dh[QT + row];
    }
    for (int j = jp; j < Lp / 8; j += 2) {
      float c[4];
      rows_times_keys(c, ga, sm.KV, j);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
#pragma unroll
        for (int lo = 0; lo < 2; ++lo) {
          const int row = m * 16 + g + 8 * hi, col = j * 8 + t * 2 + lo;
          float* s = sm.S + row * SF + col;
          *s = *s * (drop_grad<DROP>(c[2 * hi + lo], M, MS, row, col, dr.keep_scale) - dsum[hi]);
        }
    }
  }
  if (tid < QT && q0 + tid < L) st[2 * bnl + q0 + tid] = Dh[tid] + Dh[QT + tid];
  __syncthreads();

  // 6. K over V
  stage_rows(sm.KV, k + base, rs, 0, Lp, L);
  __syncthreads();

  // 7. dQ = dS . K * scale: m-tile m, head-dim tiles 4 jp .. 4 jp + 3
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p) acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.f;
  const int mi = lane >> 3, rr = lane & 7;
  const float* sr = sm.S + (m * 16 + g) * SF + t * 2;
  for (int kk = 0; kk < Lp / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack2_at(sr + kk * 16);
    a[1] = pack2_at(sr + 8 * SF + kk * 16);
    a[2] = pack2_at(sr + kk * 16 + 8);
    a[3] = pack2_at(sr + 8 * SF + kk * 16 + 8);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      ldsm_x4_trans(r, sm.KV + (kk * 16 + (mi & 1) * 8 + rr) * K_STRIDE +
                           (4 * jp + 2 * np + (mi >> 1)) * 8);
      mma16816(acc[2 * np], a, r[0], r[1]);
      mma16816(acc[2 * np + 1], a, r[2], r[3]);
    }
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int col = (4 * jp + p) * 8 + t * 2;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = q0 + m * 16 + g + 8 * hi;
      if (row < L)
        *reinterpret_cast<uint32_t*>(dq + gbase + (size_t)row * grs + col) =
            pack2(acc[p][2 * hi] * scale, acc[p][2 * hi + 1] * scale);
    }
  }
}

// dK/dV kernel: shared memory in this order (independent of L)
struct KvSmem {
  float* bias;   // [KT] the tile's key bias
  bf16* K;       // [KT][K_STRIDE]
  bf16* V;       // [KT][K_STRIDE]
  bf16* Q;       // [QT][K_STRIDE] the query tile
  bf16* G;       // [QT][K_STRIDE] its output gradient
  float* S;      // [QT][KT + 4] scores, then P (fp32)
  bf16* P;       // [QT][KT + 8] Pd, then dS (bf16)
  uint8_t* M;    // [QT][KT / 4] keep bits
  float* st;     // [3][QT] the query rows' max, 1 / sum and D
  float* dbias;  // [4][KT] dS summed over the queries of each m-tile
};
constexpr int KV_SF = SPLIT_KT + 4, KV_PS = SPLIT_KT + 8;
constexpr size_t KV_SMEM_BYTES =
    (size_t)SPLIT_KT * 4 + 2 * (size_t)SPLIT_KT * K_STRIDE * 2 + 2 * (size_t)SPLIT_QT * K_STRIDE * 2 +
    (size_t)SPLIT_QT * KV_SF * 4 + (size_t)SPLIT_QT * KV_PS * 2 + (size_t)SPLIT_QT * (SPLIT_KT / 4) +
    3 * SPLIT_QT * 4 + 4 * SPLIT_KT * 4;

__device__ inline KvSmem kv_smem(uint8_t* smem) {
  KvSmem s;
  s.bias = reinterpret_cast<float*>(smem);
  s.K = reinterpret_cast<bf16*>(s.bias + SPLIT_KT);
  s.V = s.K + SPLIT_KT * K_STRIDE;
  s.Q = s.V + SPLIT_KT * K_STRIDE;
  s.G = s.Q + SPLIT_QT * K_STRIDE;
  s.S = reinterpret_cast<float*>(s.G + SPLIT_QT * K_STRIDE);
  s.P = reinterpret_cast<bf16*>(s.S + SPLIT_QT * KV_SF);
  s.M = reinterpret_cast<uint8_t*>(s.P + SPLIT_QT * KV_PS);
  s.st = reinterpret_cast<float*>(s.M + SPLIT_QT * (SPLIT_KT / 4));
  s.dbias = s.st + 3 * SPLIT_QT;
  return s;
}

template <bool DROP>
__global__ void __launch_bounds__(SPLIT_WARPS * 32, 1)
    attn_train_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const float* __restrict__ bias,
                               const bf16* __restrict__ gout, const float* __restrict__ stats,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               float* __restrict__ dbias_part, int L, int n, int rs,
                               float scale, Dropout dr) {
  constexpr int WARPS = SPLIT_WARPS, QT = SPLIT_QT, KT = SPLIT_KT;
  constexpr int SF = KV_SF, PS = KV_PS, MS = KT / 4, NM = KT / 16;
  static_assert(NM == WARPS, "one key m-tile per warp");
  extern __shared__ __align__(16) uint8_t smem[];
  const int k0 = blockIdx.x * KT, h = blockIdx.y, b = blockIdx.z;
  const KvSmem sm = kv_smem(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m = warp & 3, jp = warp >> 2;  // score tiles: m-tile m, key tiles j = jp mod 2
  const uint32_t bh = (uint32_t)(b * n + h);
  const size_t base = (size_t)b * L * rs + (size_t)h * HEAD_DIM;
  const int grs = n * HEAD_DIM;
  const size_t gbase = (size_t)b * L * grs + (size_t)h * HEAD_DIM;
  const size_t bnl = (size_t)gridDim.z * n * L;
  const float* st = stats + (size_t)bh * L;

  for (int i = tid; i < KT; i += WARPS * 32)
    sm.bias[i] = k0 + i < L ? bias[(size_t)b * L + k0 + i] : -INFINITY;
  for (int i = tid; i < 4 * KT; i += WARPS * 32) sm.dbias[i] = 0.f;
  stage_rows(sm.K, k + base, rs, k0, KT, L);
  stage_rows(sm.V, v + base, rs, k0, KT, L);
  float dka[1][8][4], dva[1][8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[0][nt][e] = dva[0][nt][e] = 0.f;

  for (int q0 = 0; q0 < L; q0 += QT) {
    __syncthreads();  // staging done; the previous tile's readers are done
    stage_rows(sm.Q, q + base, rs, q0, QT, L);
    stage_rows(sm.G, gout + gbase, grs, q0, QT, L);
    for (int i = tid; i < QT; i += WARPS * 32) {
      const bool in = q0 + i < L;  // rows past L: P = 0, D = 0
      sm.st[i] = in ? st[q0 + i] : 0.f;
      sm.st[QT + i] = in ? st[bnl + q0 + i] : 0.f;
      sm.st[2 * QT + i] = in ? st[2 * bnl + q0 + i] : 0.f;
    }
    __syncthreads();

    // 1. scores * scale + bias of the tile's queries against the block's keys
    {
      uint32_t qa[HEAD_DIM / 16][4];
      load_a_frags(qa, sm.Q, m);
      for (int j = jp; j < KT / 8; j += 2) {
        float c[4];
        rows_times_keys(c, qa, sm.K, j);
        const int key = j * 8 + t * 2;
        const float b0 = sm.bias[key], b1 = sm.bias[key + 1];
        float* s0 = sm.S + (m * 16 + g) * SF + key;
        *reinterpret_cast<float2*>(s0) = make_float2(c[0] * scale + b0, c[1] * scale + b1);
        *reinterpret_cast<float2*>(s0 + 8 * SF) =
            make_float2(c[2] * scale + b0, c[3] * scale + b1);
      }
    }
    __syncthreads();

    // 2. P = exp(s - max) * (1 / sum) in place, Pd (bf16) and the keep bits
    for (int i = tid; i < QT * MS; i += WARPS * 32) {
      const int r = i / MS, grp = i % MS, c = grp * 4;
      float4* sp = reinterpret_cast<float4*>(sm.S + r * SF + c);
      const float mx = sm.st[r], inv = sm.st[QT + r];
      float4 p = *sp;
      p = make_float4(expf(p.x - mx) * inv, expf(p.y - mx) * inv, expf(p.z - mx) * inv,
                      expf(p.w - mx) * inv);
      *sp = p;
      if constexpr (DROP) {
        const uint32_t kb = keep_bits4(dr.seed, dr.thresh, (k0 >> 2) + grp, q0 + r, bh);
        sm.M[r * MS + grp] = (uint8_t)kb;
        p = drop4(p, kb, dr.keep_scale);
      }
      store4(sm.P + r * PS + c, p.x, p.y, p.z, p.w);
    }
    __syncthreads();

    // 3. dV += Pd^T . g
    accumulate_keys<1>(dva, sm.P, PS, sm.G, NM);
    __syncthreads();  // every reader of Pd is done

    // 4. dS = P * (dP - D) over Pd, and dS summed over this m-tile's queries
    {
      uint32_t ga[HEAD_DIM / 16][4];
      load_a_frags(ga, sm.G, m);
      float dsum[2];
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) dsum[hi] = sm.st[2 * QT + m * 16 + g + 8 * hi];
      for (int j = jp; j < KT / 8; j += 2) {
        float c[4];
        rows_times_keys(c, ga, sm.V, j);
        float cs[2] = {0.f, 0.f};
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int row = m * 16 + g + 8 * hi, col = j * 8 + t * 2;
          float ds[2];
#pragma unroll
          for (int lo = 0; lo < 2; ++lo) {
            ds[lo] = sm.S[row * SF + col + lo] *
                     (drop_grad<DROP>(c[2 * hi + lo], sm.M, MS, row, col + lo, dr.keep_scale) -
                      dsum[hi]);
            cs[lo] += ds[lo];
          }
          *reinterpret_cast<uint32_t*>(sm.P + row * PS + col) = pack2(ds[0], ds[1]);
        }
#pragma unroll
        for (int lo = 0; lo < 2; ++lo) {
          float s = cs[lo];
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          s += __shfl_xor_sync(0xffffffffu, s, 8);
          s += __shfl_xor_sync(0xffffffffu, s, 16);
          if (g == 0) sm.dbias[m * KT + j * 8 + t * 2 + lo] += s;
        }
      }
    }
    __syncthreads();

    // 5. dK += dS^T . Q
    accumulate_keys<1>(dka, sm.P, PS, sm.Q, NM);
  }

#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + t * 2;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int key = k0 + warp * 16 + g + 8 * hi;
      if (key < L) {
        const size_t o = gbase + (size_t)key * grs + col;
        *reinterpret_cast<uint32_t*>(dk + o) =
            pack2(dka[0][nt][2 * hi] * scale, dka[0][nt][2 * hi + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + o) = pack2(dva[0][nt][2 * hi], dva[0][nt][2 * hi + 1]);
      }
    }
  }
  if (dbias_part != nullptr) {
    __syncthreads();
    for (int c = tid; c < KT && k0 + c < L; c += WARPS * 32)
      dbias_part[(size_t)bh * L + k0 + c] =
          ((sm.dbias[c] + sm.dbias[KT + c]) + sm.dbias[2 * KT + c]) + sm.dbias[3 * KT + c];
  }
}

// Call launch(std::integral_constant<int, NC>(), std::bool_constant<DROP>())
// for the chunk count of L (L <= TRAIN_MAX_LEN) and the dropout flag.
template <typename Launch>
inline int with_train_variant(int L, int drop, Launch launch) {
  auto go = [&](auto nc) {
    return drop ? launch(nc, std::true_type()) : launch(nc, std::false_type());
  };
  if (L < 1 || L > TRAIN_MAX_LEN) return (int)cudaErrorInvalidValue;
  switch (score_chunks(L)) {
    case 2: return go(std::integral_constant<int, 2>());
    case 4: return go(std::integral_constant<int, 4>());
    case 6: return go(std::integral_constant<int, 6>());
    default: return go(std::integral_constant<int, 8>());
  }
}

// The same for the split backward, TRAIN_MAX_LEN < L <= MAX_LEN.
template <typename Launch>
inline int with_split_variant(int L, int drop, Launch launch) {
  auto go = [&](auto nc) {
    return drop ? launch(nc, std::true_type()) : launch(nc, std::false_type());
  };
  if (L <= TRAIN_MAX_LEN || L > MAX_LEN) return (int)cudaErrorInvalidValue;
  if (score_chunks(L) == 12) return go(std::integral_constant<int, 12>());
  return go(std::integral_constant<int, 16>());
}

}  // namespace uc2

// q, k, v: [B, L, n, 64] bf16, tokens rs elements apart; bias [B, L] fp32;
// out [B, L, n, 64] bf16 contiguous. drop = 0 skips the mask (rate 0): the
// launch is then kernel #4's, bit for bit. Returns cudaGetLastError().
extern "C" int uc2_attn_train_fwd(const void* q, const void* k, const void* v,
                                  const void* bias, void* out, int B, int L, int n,
                                  int rs, float scale, unsigned seed, unsigned thresh,
                                  float keep_scale, int drop, void* stream) {
  using namespace uc2;
  const Dropout dr{seed, thresh, keep_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return drop ? stream::attention<true>(q, k, v, bias, out, B, L, n, rs, scale, dr, st)
              : stream::attention<false>(q, k, v, bias, out, B, L, n, rs, scale, dr, st);
}

// q, k, v as above; g, dq, dk, dv [B, L, n, 64] bf16 contiguous;
// dbias_part [B, n, L] fp32 or null (not written). Returns cudaGetLastError().
extern "C" int uc2_attn_train_bwd(const void* q, const void* k, const void* v,
                                  const void* bias, const void* g, void* dq, void* dk,
                                  void* dv, void* dbias_part, int B, int L, int n,
                                  int rs, float scale, unsigned seed, unsigned thresh,
                                  float keep_scale, int drop, void* stream) {
  using namespace uc2;
  const size_t smem = bwd_smem_bytes(padded_len(L));
  const Dropout dr{seed, thresh, keep_scale};
  return with_train_variant(L, drop, [&](auto nc, auto dp) {
    auto kernel = attn_train_bwd_kernel<decltype(nc)::value, decltype(dp)::value>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(n, B);
    kernel<<<grid, BWD_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const float*>(bias),
        static_cast<const bf16*>(g), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), static_cast<float*>(dbias_part), L, n, rs, scale, dr);
    return (int)cudaGetLastError();
  });
}

// The split backward for TRAIN_MAX_LEN < L <= MAX_LEN, first kernel: q, k,
// v, bias and g as above; dq [B, L, n, 64] bf16 contiguous; stats
// [3][B, n, L] fp32 (written). Returns cudaGetLastError().
extern "C" int uc2_attn_train_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* bias, const void* g, void* dq, void* stats,
                                     int B, int L, int n, int rs, float scale, unsigned seed,
                                     unsigned thresh, float keep_scale, int drop,
                                     void* stream) {
  using namespace uc2;
  const size_t smem = dq_smem_bytes(L);
  const Dropout dr{seed, thresh, keep_scale};
  return with_split_variant(L, drop, [&](auto nc, auto dp) {
    auto kernel = attn_train_bwd_dq_kernel<decltype(nc)::value, decltype(dp)::value>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((L + SPLIT_QT - 1) / SPLIT_QT, n, B);
    kernel<<<grid, SPLIT_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const float*>(bias),
        static_cast<const bf16*>(g), static_cast<bf16*>(dq), static_cast<float*>(stats), L,
        n, rs, scale, dr);
    return (int)cudaGetLastError();
  });
}

// Second kernel: stats as the first kernel wrote them; dk, dv [B, L, n, 64]
// bf16 contiguous; dbias_part [B, n, L] fp32 or null (not written).
// Returns cudaGetLastError().
extern "C" int uc2_attn_train_bwd_dkdv(const void* q, const void* k, const void* v,
                                       const void* bias, const void* g, const void* stats,
                                       void* dk, void* dv, void* dbias_part, int B, int L,
                                       int n, int rs, float scale, unsigned seed,
                                       unsigned thresh, float keep_scale, int drop,
                                       void* stream) {
  using namespace uc2;
  const Dropout dr{seed, thresh, keep_scale};
  return with_split_variant(L, drop, [&](auto, auto dp) {
    auto kernel = attn_train_bwd_dkdv_kernel<decltype(dp)::value>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)KV_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((L + SPLIT_KT - 1) / SPLIT_KT, n, B);
    kernel<<<grid, SPLIT_WARPS * 32, KV_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const float*>(bias),
        static_cast<const bf16*>(g), static_cast<const float*>(stats), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), static_cast<float*>(dbias_part), L, n, rs, scale, dr);
    return (int)cudaGetLastError();
  });
}
