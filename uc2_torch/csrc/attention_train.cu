// Training attention with attention-probs dropout: the backward (#6) as two
// passes, and the C entry of the forward (#5).
//
// Replaces the TPU kernel uc2_tpu/ops/flash_attention.py
// _attn_train_bwd_kernel (launched by _bwd_train), which every layer of a
// uc2-base training step runs at attention dropout 0.1. The forward,
// _attn_train_fwd_kernel (launched by _fwd_train), is the streamed core of
// attention_stream.cuh, which kernel #4 shares; uc2_attn_train_fwd below
// only launches it.
//
// The function (the reference kernel's): s = q.k^T scale + bias in fp32,
// P = softmax(s), Pd = keep ? P / (1 - rate) : 0, dV = bf16(Pd)^T . g,
// dP = keep ? (g . v^T) / (1 - rate) : 0, D = rowsum(dP * P) in fp32,
// dS = P (dP - D), dQ = bf16(dS) . k scale, dK = bf16(dS)^T . q scale, and
// dbias as dS summed over the queries of each head ([B, n, L] fp32, which
// the wrapper sums over heads). The keep bit of score (b, h, i, j) is
// Philox4x32-10 of its global index (philox.cuh): the mask #5 drew.
//
// What bounds it on an H100: at B = 128, L = 162 it reads q, k, v, g and
// the bias and writes dq, dk, dv and the dbias partials, 223 MB (67 us at
// 3.35 TB/s), against 25.8 GFLOP of the function's products (26 us at
// 989 TFLOP/s). As in #5, the exp2 and Philox work of the score tiles
// takes longer than either on one warpgroup; several blocks a SM overlap
// one block's exp2 and Philox with another's products.
//
// Design: two deterministic passes on the streamed core's machinery (TMA
// tensor maps, an mbarrier ring fed by one producer warp, one consumer
// warpgroup of 64 rows, wgmma with 128-byte-swizzled operands), the same
// at every L from 1 to 512. No atomics, so one seed gives the same bits on
// every run: dQ sums over the keys and dK, dV over the queries, so each
// pass owns one of the two and sweeps the other operand.
//   Pass 1, rows (uc2_attn_train_bwd_dq): one block per (64 query rows,
//     head, batch row); Q and G stay in shared memory, K and V tiles of 64
//     keys stream through the ring in two sweeps:
//       1. S = Q . K^T and dPd = G . V^T (both operands K-major); the keep
//          bits, drawn here, the only Philox draw of the backward (kept in
//          shared memory for sweep 2 and written as a byte mask for pass
//          2); each row's running max m, sum l of exp2(s - m) and sum of
//          dP exp2(s - m), rescaled together when m grows, so that D =
//          rowsum(dP * P) comes out of the same sweep as the statistics;
//       2. S and dPd again, P = exp2(s - m) / l, dS = P (dP - D) rounded
//          to bf16 straight into wgmma A fragments, dQ += dS . K with K
//          read MN-major (as #5 reads V for P . V); one step's dS . K runs
//          under the next step's exp2 and dS.
//     Writes dQ (through the Q slot and a TMA store), each row's max (of
//     the base-2 scores), 1 / sum and D as [3][B, n, L] fp32, and the keep
//     bits as [B, n, Lp, Lp / 8] bytes (bit j % 8 of byte j / 8 of row i;
//     Lp = L rounded up to 64; only at rate > 0).
//   Pass 2, keys (uc2_attn_train_bwd_dkdv): one block per (64 keys, head,
//     batch row); K and V stay in shared memory, Q and G tiles of 64
//     queries stream through the ring with the rows' statistics and keep
//     bits. Keys are the 64 wgmma rows: S^T = K . Q^T and dPd^T = V . G^T,
//     P^T = exp2(S^T - max) (1 / sum) from pass 1's statistics, then
//     dV += bf16(Pd^T) . G and dK += bf16(dS^T) . Q with A from registers
//     and G, Q read MN-major; dbias sums the unrounded dS^T over the query
//     tiles in registers. Reading pass 1's bits spares a second Philox
//     draw in the transposed layout, where a 4-key group spans four lanes.
//     dPd^T runs under P^T's exp2; the gradient products and the next
//     S^T follow back to back, so no more than four accumulators are held
//     (a deeper pipeline spilled and serialised the products).
// Products: pass 1 makes 5 L^2 d a row and head (S and dPd in each sweep,
// dS . K), pass 2 makes 4, against the function's 5. Query rows >= L
// (TMA fills them with zeros) get max = +inf and 1 / sum = 0 in pass 2,
// so their P is 0 and no 0 * inf reaches dK.
#include "attention_bwd.cuh"

namespace uc2 {
namespace bwd {

using namespace stream;

// --------------------------------------------------------------- pass 1
// stats: [3][B, n, L] fp32 (row max of the base-2 scores, 1 / sum, D);
// bits: [B, n, Lp, Lp / 64] 64-bit words (DROP only)
template <bool DROP>
__global__ void __launch_bounds__(Cfg::THREADS, Cfg::MIN_BLOCKS)
    attn_bwd_rows_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap gmap,
                         const __grid_constant__ CUtensorMap dqmap,
                         const float* __restrict__ bias, float* __restrict__ stats,
                         uint64_t* __restrict__ bits, int L, int n, float scale, Dropout dr) {
  using C = Cfg;
  constexpr int T = C::T, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* sbias = reinterpret_cast<float*>(smem + C::R_BIAS);
  uint64_t* sbits = reinterpret_cast<uint64_t*>(smem + C::R_BITS);
  const uint32_t full = base + C::R_BAR, empty = full + 8 * STAGES, qbar = empty + 8 * STAGES;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * T;
  const int nt = (L + T - 1) / T, steps = 2 * nt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 32);   // the producer warp's lanes (+ the bytes)
      mbar_init(empty + 8 * s, 4);   // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // ---------------------------------------- producer
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, 2 * C::TILE);
      tma_load(base, &qmap, qbar, h, q0, b);
      tma_load(base + C::R_G, &gmap, qbar, h, q0, b);
    }
    const float* brow = bias + (size_t)b * L;
    for (int s = 0; s < steps; ++s) {
      const int st = s % STAGES;
      mbar_wait(empty + 8 * st, ((s / STAGES) & 1) ^ 1);
      const int k0 = (s % nt) * T;
#pragma unroll
      for (int i = lane; i < T; i += 32)
        sbias[st * T + i] = k0 + i < L ? brow[k0 + i] * LOG2E : -INFINITY;
      if (lane == 0) {
        mbar_arrive_expect_tx(full + 8 * st, 2 * C::TILE);
        tma_load(base + C::R_K + st * C::TILE, &kmap, full + 8 * st, h, k0, b);
        tma_load(base + C::R_V + st * C::TILE, &vmap, full + 8 * st, h, k0, b);
      } else {
        mbar_arrive(full + 8 * st);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int wl = warp, g = lane >> 2, t = lane & 3;
  const uint32_t qslot = base, gslot = base + C::R_G;
  const uint32_t bh = (uint32_t)(b * n + h);
  const uint32_t ph = (uint32_t)(b * dr.n_tot + dr.h0 + h);  // the mask's head index
  const float scale_log2 = scale * LOG2E;
  // the query row whose keep bits this lane draws (row g + 8 (t & 1) of its warp)
  const uint32_t my_row = (uint32_t)(q0 + wl * 16 + g + 8 * (t & 1));
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, inv[2], dsum[2] = {0.f, 0.f};

  auto kslot = [&](int s) { return base + C::R_K + (s % STAGES) * C::TILE; };
  auto vslot = [&](int s) { return base + C::R_V + (s % STAGES) * C::TILE; };
  auto release = [&](int s) {  // this warp is done with step s's slot
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (s % STAGES));
  };
  // S = Q . K^T and dPd = G . V^T of step s, committed as one group
  auto issue_sdp = [&](float(&sc)[32], float(&dp)[32], int s) {
    mbar_wait(full + 8 * (s % STAGES), (s / STAGES) & 1);
    wgmma_fence();
    product_xyt(sc, qslot, kslot(s));
    product_xyt(dp, gslot, vslot(s));
    wgmma_commit();
  };
  // the scores of step s in base 2: s * scale * log2 e + bias * log2 e
  auto add_bias = [&](float(&acc)[32], int s) {
    fence_regs(acc);
    const float* sb = sbias + (s % STAGES) * T;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float2 bb = *reinterpret_cast<const float2*>(sb + 8 * c + 2 * t);
      acc[4 * c + 0] = fmaf(acc[4 * c + 0], scale_log2, bb.x);
      acc[4 * c + 1] = fmaf(acc[4 * c + 1], scale_log2, bb.y);
      acc[4 * c + 2] = fmaf(acc[4 * c + 2], scale_log2, bb.x);
      acc[4 * c + 3] = fmaf(acc[4 * c + 3], scale_log2, bb.y);
    }
  };
  // P = exp2(s - max) * (1 / sum) in place of the scores
  auto probs = [&](float(&acc)[32]) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      acc[4 * c + 0] = ex2(acc[4 * c + 0] - mx[0]) * inv[0];
      acc[4 * c + 1] = ex2(acc[4 * c + 1] - mx[0]) * inv[0];
      acc[4 * c + 2] = ex2(acc[4 * c + 2] - mx[1]) * inv[1];
      acc[4 * c + 3] = ex2(acc[4 * c + 3] - mx[1]) * inv[1];
    }
  };

  // dP = keep ? dPd * keep_scale : 0 of the lane's four scores of column
  // group c: kg, kh hold the keep bits of rows g, g + 8 at bits 0 and 1
  auto dprob = [&](float (&d)[4], const float (&dp)[32], uint32_t kg, uint32_t kh, int c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      d[e] = dp[4 * c + e];
      if constexpr (DROP)
        d[e] = ((e < 2 ? kg : kh) >> (e & 1)) & 1 ? d[e] * dr.keep_scale : 0.f;
    }
  };

  mbar_wait(qbar, 0);
  // sweep 1: the keep bits (to shared memory for sweep 2 and to device
  // memory for pass 2), dP in place of dPd, then each lane's running max,
  // sum of exp2 and sum of dP exp2, rescaled together when the max grows
  for (int s = 0; s < nt; ++s) {
    float sc[32], dp[32];
    issue_sdp(sc, dp, s);
    wgmma_wait<0>();
    fence_regs(dp);
    add_bias(sc, s);
    release(s);
    uint64_t word = 0;  // this lane's keep bits of row g + 8 (t & 1)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      uint32_t kg = 0, kh = 0;
      if constexpr (DROP) {
        const uint32_t mine =
            keep_bits4(dr.seed, dr.thresh, (uint32_t)(s * 16 + 2 * c + (t >> 1)), my_row, ph);
        word |= (uint64_t)mine << (8 * c + 4 * (t >> 1));
        const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
        const int sh = 2 * (t & 1);
        kg = ((t & 1) ? other : mine) >> sh;  // row g
        kh = ((t & 1) ? mine : other) >> sh;  // row g + 8
      }
      float d[4];
      dprob(d, dp, kg, kh, c);
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[4 * c + e] = d[e];
    }
    if constexpr (DROP) {  // lanes t, t ^ 2 hold the two halves of a row's word
      word |= (uint64_t)__shfl_xor_sync(0xffffffffu, (uint32_t)word, 2) |
              ((uint64_t)__shfl_xor_sync(0xffffffffu, (uint32_t)(word >> 32), 2) << 32);
      if (t < 2) {
        const int r = wl * 16 + g + 8 * t;
        sbits[r * C::WORDS + s] = word;
        bits[((size_t)bh * (nt * T) + q0 + r) * nt + s] = word;
      }
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float tm = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        tm = fmaxf(tm, fmaxf(sc[4 * c + 2 * hi], sc[4 * c + 2 * hi + 1]));
      const float mn = fmaxf(mx[hi], tm);
      if (mn != -INFINITY) {
        float add = 0.f, dadd = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float e0 = ex2(sc[4 * c + 2 * hi] - mn), e1 = ex2(sc[4 * c + 2 * hi + 1] - mn);
          add += e0 + e1;
          dadd += dp[4 * c + 2 * hi] * e0 + dp[4 * c + 2 * hi + 1] * e1;
        }
        const float r = ex2(mx[hi] - mn);
        sum[hi] = sum[hi] * r + add;
        dsum[hi] = dsum[hi] * r + dadd;
        mx[hi] = mn;
      }
    }
  }
  // merge the four lanes of each row: max, 1 / sum and D = (sum of dP exp2) / sum
  float D[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, mx[hi], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, sum[hi], off);
      const float d2 = __shfl_xor_sync(0xffffffffu, dsum[hi], off);
      const float mn = fmaxf(mx[hi], m2);
      const float r1 = mx[hi] == -INFINITY ? 0.f : ex2(mx[hi] - mn);
      const float r2 = m2 == -INFINITY ? 0.f : ex2(m2 - mn);
      sum[hi] = sum[hi] * r1 + l2 * r2;
      dsum[hi] = dsum[hi] * r1 + d2 * r2;
      mx[hi] = mn;
    }
    inv[hi] = 1.f / sum[hi];
    D[hi] = dsum[hi] * inv[hi];
    const int row = q0 + wl * 16 + g + 8 * hi;
    if (t == 0 && row < L) {
      const size_t bnl = (size_t)gridDim.z * n * L, at = (size_t)bh * L + row;
      stats[at] = mx[hi];
      stats[bnl + at] = inv[hi];
      stats[2 * bnl + at] = D[hi];
    }
  }
  __syncwarp();  // the keep bits of this warp's rows are in shared memory

  // sweep 2: dS = P (dP - D); dQ += dS . K one step behind, under the
  // next step's exp2 and dS
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  fence_regs(dq);
  uint32_t pa[4][4];  // dS of the step whose dS . K starts next
  for (int s = nt; s < steps; ++s) {
    const int kt = s - nt;
    float sc[32], dp[32];
    issue_sdp(sc, dp, s);
    if (s > nt) {
      wgmma_fence();
      product_ay(dq, pa, kslot(s - 1));
      wgmma_commit();
      wgmma_wait<1>();  // S and dPd; dS . K still in flight
    } else {
      wgmma_wait<0>();
    }
    fence_regs(dp);
    add_bias(sc, s);
    probs(sc);
    uint64_t wg = 0, wh = 0;  // rows g, g + 8, shifted to column 2t
    if constexpr (DROP) {
      wg = sbits[(wl * 16 + g) * C::WORDS + kt] >> (2 * t);
      wh = sbits[(wl * 16 + g + 8) * C::WORDS + kt] >> (2 * t);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float d[4];
      dprob(d, dp, (uint32_t)(wg >> (8 * c)), (uint32_t)(wh >> (8 * c)), c);
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[4 * c + e] = sc[4 * c + e] * (d[e] - D[e >> 1]);
    }
    if (s > nt) {
      wgmma_wait<0>();
      fence_regs(dq);
      release(s - 1);  // its K has been read
    }
    to_frags(pa, sc);
  }
  wgmma_fence();
  product_ay(dq, pa, kslot(steps - 1));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dq);

  // dQ * scale through the Q slot (every product that read Q is done)
  to_tile(smem, dq, scale, wl, g, t);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumers_sync();
  if (wl == 0 && lane == 0) tma_store(&dqmap, qslot, h, q0, b);
}

// --------------------------------------------------------------- pass 2
// stats and bits as pass 1 wrote them; dbias_part [B, n, L] fp32 or null
template <bool DROP>
__global__ void __launch_bounds__(Cfg::THREADS, Cfg::MIN_BLOCKS)
    attn_bwd_keys_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap gmap,
                         const __grid_constant__ CUtensorMap dkmap,
                         const __grid_constant__ CUtensorMap dvmap,
                         const float* __restrict__ bias, const float* __restrict__ stats,
                         const uint64_t* __restrict__ bits, float* __restrict__ dbias_part,
                         int L, int n, float scale, Dropout dr) {
  using C = Cfg;
  constexpr int T = C::T, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* sst = reinterpret_cast<float*>(smem + C::K_ST);
  uint64_t* sbits = reinterpret_cast<uint64_t*>(smem + C::K_BITS);
  const uint32_t full = base + C::K_BAR, empty = full + 8 * STAGES, kvbar = empty + 8 * STAGES;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, k0 = kt * T;
  const int nt = (L + T - 1) / T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t bh = (uint32_t)(b * n + h);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, 4);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // ---------------------------------------- producer
    if (lane == 0) {
      mbar_arrive_expect_tx(kvbar, 2 * C::TILE);
      tma_load(base, &kmap, kvbar, h, k0, b);
      tma_load(base + C::K_V, &vmap, kvbar, h, k0, b);
    }
    const size_t bnl = (size_t)gridDim.z * n * L;
    const float* srow = stats + (size_t)bh * L;
    for (int s = 0; s < nt; ++s) {
      const int st = s % STAGES, q0 = s * T;
      mbar_wait(empty + 8 * st, ((s / STAGES) & 1) ^ 1);
      float* ss = sst + st * 3 * T;
#pragma unroll
      for (int i = lane; i < T; i += 32) {  // rows >= L: P = 0, D = 0
        const bool in = q0 + i < L;
        ss[i] = in ? srow[q0 + i] : INFINITY;
        ss[T + i] = in ? srow[bnl + q0 + i] : 0.f;
        ss[2 * T + i] = in ? srow[2 * bnl + q0 + i] : 0.f;
        if constexpr (DROP)
          sbits[st * T + i] = bits[((size_t)bh * (nt * T) + q0 + i) * nt + kt];
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full + 8 * st, 2 * C::TILE);
        tma_load(base + C::K_Q + st * C::TILE, &qmap, full + 8 * st, h, q0, b);
        tma_load(base + C::K_G + st * C::TILE, &gmap, full + 8 * st, h, q0, b);
      } else {
        mbar_arrive(full + 8 * st);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int wl = warp, g = lane >> 2, t = lane & 3;
  const int r0 = wl * 16 + g;  // this lane's keys: k0 + r0, k0 + r0 + 8
  const float scale_log2 = scale * LOG2E;
  float kb[2];  // the keys' bias in base 2
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int key = k0 + r0 + 8 * hi;
    kb[hi] = key < L ? bias[(size_t)b * L + key] * LOG2E : -INFINITY;
  }
  float dk[32], dv[32], db[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  fence_regs(dk);
  fence_regs(dv);
  auto qslot = [&](int s) { return base + C::K_Q + (s % STAGES) * C::TILE; };
  auto gslot = [&](int s) { return base + C::K_G + (s % STAGES) * C::TILE; };

  auto issue_st = [&](float(&acc)[32], int s) {  // S^T = K . Q^T of step s
    mbar_wait(full + 8 * (s % STAGES), (s / STAGES) & 1);
    wgmma_fence();
    product_xyt(acc, base, qslot(s));
    wgmma_commit();
  };

  // per step: dPd^T(s) runs under P^T(s)'s exp2; the gradient products of
  // s and S^T(s + 1) follow back to back (holding no more accumulators
  // keeps the products unserialised)
  mbar_wait(kvbar, 0);
  float sc[32];
  issue_st(sc, 0);
  for (int s = 0; s < nt; ++s) {
    const int st = s % STAGES;
    const float* ss = sst + st * 3 * T;
    float dp[32];
    wgmma_fence();
    product_xyt(dp, base + C::K_V, gslot(s));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int c = 0; c < 8; ++c) {  // P^T = exp2(s - max) * (1 / sum)
      const int col = 8 * c + 2 * t;  // queries col, col + 1 of this tile
      const float2 m = *reinterpret_cast<const float2*>(ss + col);
      const float2 iv = *reinterpret_cast<const float2*>(ss + T + col);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * c + e] = ex2(fmaf(sc[4 * c + e], scale_log2, kb[e >> 1]) - (e & 1 ? m.y : m.x)) *
                        (e & 1 ? iv.y : iv.x);
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int c = 0; c < 8; ++c) {  // Pd^T in sc, dS^T in dp
      const int col = 8 * c + 2 * t;
      const float2 dd = *reinterpret_cast<const float2*>(ss + 2 * T + col);
      uint64_t w0 = 0, w1 = 0;
      if constexpr (DROP) {
        w0 = sbits[st * T + col];
        w1 = sbits[st * T + col + 1];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1, lo = e & 1;
        const float p = sc[4 * c + e];
        float pd = p, d = dp[4 * c + e];
        if constexpr (DROP) {
          const bool keep = ((lo ? w1 : w0) >> (r0 + 8 * hi)) & 1;
          pd = keep ? p * dr.keep_scale : 0.f;
          d = keep ? d * dr.keep_scale : 0.f;
        }
        const float ds = p * (d - (lo ? dd.y : dd.x));
        db[hi] += ds;
        sc[4 * c + e] = pd;
        dp[4 * c + e] = ds;
      }
    }
    uint32_t pv[4][4], pk[4][4];
    to_frags(pv, sc);
    to_frags(pk, dp);
    wgmma_fence();
    product_ay(dv, pv, gslot(s));
    product_ay(dk, pk, qslot(s));
    wgmma_commit();
    if (s + 1 < nt) {
      issue_st(sc, s + 1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(dk);
    fence_regs(dv);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);  // its Q and G read
  }

  if (dbias_part != nullptr) {  // dS summed over the queries: the quad's lanes
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float s = db[hi] + __shfl_xor_sync(0xffffffffu, db[hi], 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const int key = k0 + r0 + 8 * hi;
      if (t == 0 && key < L) dbias_part[(size_t)bh * L + key] = s;
    }
  }
  // dK * scale and dV through the K and V slots
  to_tile(smem, dk, scale, wl, g, t);
  to_tile(smem + C::K_V, dv, 1.f, wl, g, t);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumers_sync();
  if (wl == 0 && lane == 0) {
    tma_store(&dkmap, base, h, k0, b);
    tma_store(&dvmap, base + C::K_V, h, k0, b);
  }
}

}  // namespace bwd
}  // namespace uc2

// q, k, v: [B, L, n, 64] bf16, tokens rs elements apart; bias [B, L] fp32;
// out [B, L, n, 64] bf16 contiguous. drop = 0 skips the mask (rate 0): the
// launch is then kernel #4's, bit for bit. The n heads are heads h0 ..
// h0 + n - 1 of n_tot for the mask (h0 = 0, n_tot = n: the whole layer).
// Returns cudaGetLastError().
extern "C" int uc2_attn_train_fwd(const void* q, const void* k, const void* v,
                                  const void* bias, void* out, int B, int L, int n,
                                  int rs, float scale, unsigned seed, unsigned thresh,
                                  float keep_scale, int drop, int h0, int n_tot,
                                  void* stream) {
  using namespace uc2;
  const Dropout dr{seed, thresh, keep_scale, (uint32_t)h0, (uint32_t)n_tot};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return drop ? stream::attention<true>(q, k, v, bias, out, B, L, n, rs, scale, dr, st)
              : stream::attention<false>(q, k, v, bias, out, B, L, n, rs, scale, dr, st);
}

// The backward's first pass, 1 <= L <= 512: q, k, v and bias as above;
// g, dq [B, L, n, 64] bf16 contiguous; stats [3][B, n, L] fp32 and, when
// drop, bits [B, n, Lp, Lp / 8] bytes (Lp = L rounded up to 64), both
// written; h0 and n_tot as the forward's. Returns cudaGetLastError().
extern "C" int uc2_attn_train_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* bias, const void* g, void* dq, void* stats,
                                     void* bits, int B, int L, int n, int rs, float scale,
                                     unsigned seed, unsigned thresh, float keep_scale, int drop,
                                     int h0, int n_tot, void* stream) {
  using namespace uc2;
  using namespace uc2::stream;
  if (L < 1 || L > MAX_LEN) return (int)cudaErrorInvalidValue;
  const Dropout dr{seed, thresh, keep_scale, (uint32_t)h0, (uint32_t)n_tot};
  CUtensorMap qm, km, vm, gm, dqm;
  const size_t rb = (size_t)rs * 2, gb = (size_t)n * HEAD_DIM * 2;
  if (!heads_map(&qm, q, B, L, n, rb, 64) || !heads_map(&km, k, B, L, n, rb, 64) ||
      !heads_map(&vm, v, B, L, n, rb, 64) || !heads_map(&gm, g, B, L, n, gb, 64) ||
      !heads_map(&dqm, dq, B, L, n, gb, 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  float* sp = static_cast<float*>(stats);
  uint64_t* wp = static_cast<uint64_t*>(bits);
  return drop ? bwd::launch(bwd::attn_bwd_rows_kernel<true>, bwd::Cfg::SMEM_ROWS, B, L, n, st,
                            qm, km, vm, gm, dqm, bp, sp, wp, L, n, scale, dr)
              : bwd::launch(bwd::attn_bwd_rows_kernel<false>, bwd::Cfg::SMEM_ROWS, B, L, n, st,
                            qm, km, vm, gm, dqm, bp, sp, wp, L, n, scale, dr);
}

// The second pass: stats and bits as the first wrote them; dk, dv
// [B, L, n, 64] bf16 contiguous; dbias_part [B, n, L] fp32 or null (not
// written). Returns cudaGetLastError().
extern "C" int uc2_attn_train_bwd_dkdv(const void* q, const void* k, const void* v,
                                       const void* bias, const void* g, const void* stats,
                                       const void* bits, void* dk, void* dv, void* dbias_part,
                                       int B, int L, int n, int rs, float scale, unsigned seed,
                                       unsigned thresh, float keep_scale, int drop,
                                       void* stream) {
  using namespace uc2;
  using namespace uc2::stream;
  if (L < 1 || L > MAX_LEN) return (int)cudaErrorInvalidValue;
  const Dropout dr{seed, thresh, keep_scale};
  CUtensorMap qm, km, vm, gm, dkm, dvm;
  const size_t rb = (size_t)rs * 2, gb = (size_t)n * HEAD_DIM * 2;
  if (!heads_map(&qm, q, B, L, n, rb, 64) || !heads_map(&km, k, B, L, n, rb, 64) ||
      !heads_map(&vm, v, B, L, n, rb, 64) || !heads_map(&gm, g, B, L, n, gb, 64) ||
      !heads_map(&dkm, dk, B, L, n, gb, 64) || !heads_map(&dvm, dv, B, L, n, gb, 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  const float* sp = static_cast<const float*>(stats);
  const uint64_t* wp = static_cast<const uint64_t*>(bits);
  float* dbp = static_cast<float*>(dbias_part);
  return drop ? bwd::launch(bwd::attn_bwd_keys_kernel<true>, bwd::Cfg::SMEM_KEYS, B, L, n, st,
                            qm, km, vm, gm, dkm, dvm, bp, sp, wp, dbp, L, n, scale, dr)
              : bwd::launch(bwd::attn_bwd_keys_kernel<false>, bwd::Cfg::SMEM_KEYS, B, L, n, st,
                            qm, km, vm, gm, dkm, dvm, bp, sp, wp, dbp, L, n, scale, dr);
}
