// Segment-masked flash attention, forward (#12) and backward (#12a dQ,
// #12b dK/dV): the function of jax's library TPU kernel
// (jax/experimental/pallas/ops/tpu/flash_attention.py: the forward body
// _flash_attention_kernel_single_batch(_single_step), the backward bodies
// _flash_attention_dq_kernel and _flash_attention_dkv_kernel), which the
// reference's _stock_flash_attention (uc2_tpu/ops/attention.py) runs under
// use_pallas_attention="flash".
//
// The function (uc2_torch/ops/segment_flash.py spells it out): the
// sequence padded to Lp = 128 * ceil(L / 128) with zero keys and values;
// segment ids 1 for a key with additive bias >= -1, else 0 (padded keys
// 0); s = (q . k^T) * scale + (segments agree ? 0 : -0.7 FLT_MAX), the
// mask finite so that a block masked for a whole row is wiped by the next
// block's rescale instead of turning into NaN; an online softmax over
// 128-key blocks with p = exp(s - m) rounded to bf16 unnormalised and the
// accumulator rescaled by alpha l_prev / l_next and (p . v) / l_next, or,
// with one block (Lp = 128), p normalised before the rounding. The
// padding here is virtual: q, k, v are read as [B, L, n, 64] (strided
// views into the fused QKV projection), keys past L are zero rows of
// segment 0 in shared memory, and query rows past L, which the reference
// computes and slices off (their output gradient is 0, so they add
// nothing to dK and dV), are skipped. The row statistics m and l go to
// [2][B, n, L] fp32.
//
// Forward (#12): the streamed core's TMA/mbarrier/wgmma machinery
// (attention_stream.cuh), one sweep over the library's 128-key blocks;
// see segment_flash_fwd_kernel below. q, k, v are read through TMA
// tensor maps of the [B, L, n, 64] views, so keys past L arrive as zero
// rows, and their segment (0) comes from the block's segment row.
//
// Backward, split as #6's pair of passes (attention_train.cu), on the
// pieces they share (attention_bwd.cuh), without atomics so a step repeats
// bit for bit:
//   #12a, #6a's rows pass with the segment mask: per (64 query rows, head,
//     batch row), Q, dO and O resident, di = rowsum(o * dO) in fp32 from
//     the bf16 output (written for #12b), then one sweep over 64-key tiles
//     of K and V with their segments through a TMA ring: S and dP by
//     wgmma, P = expf(s + mask - m) (1 / l), dS = (dP - di) P scale rounded
//     to bf16, dQ += dS . K (see segment_flash_bwd_dq_kernel below);
//   #12b, #6b's keys pass (attention_train.cu) with the segment mask: per
//     (64 keys, head, batch row), K and V resident, Q and dO tiles of 64
//     queries and the rows' m, 1 / l, di and segment through a TMA ring;
//     S^T, dP^T and the two gradient products by wgmma (see
//     segment_flash_bwd_dkdv_kernel below).
// Both recompute P with the same fp32 operations from the same m and l.
//
// What bounds them on an H100: bytes. #12 at (B, L) = (64, 162) reads q,
// k, v and writes o, 63.7 MB (0.019 ms at 3.35 TB/s) against 10.3 GFLOP
// counted at L (the padded Lp = 256 keys make it 16.3); #12a at (128, 162)
// reads q, k, v, o, dO, the bias and the row statistics and writes dq and
// di, 194 MB (0.058 ms), against three products of L^2 d a row and head
// (15.5 GFLOP, 0.016 ms); #12a + #12b together read q, k, v, o, dO and write dq,
// dk, dv, 255 MB (0.076 ms). All three run two blocks a SM, one block's
// exponentials under the other's products.
#include "attention_bwd.cuh"
#include "gemm.cuh"

namespace uc2 {

constexpr int SEG_BLOCK = 128;  // the library kernel's key block
constexpr int SEG_TILE = 64;    // query rows per CUDA block (#12)
constexpr float SEG_MASK = (float)(-0.7 * 3.4028234663852886e38);  // -0.7 * FLT_MAX

__device__ __forceinline__ int segment_of(const float* bias_row, int i, int L) {
  return i < L && bias_row[i] >= -1.f;
}

// ----------------------------------------------------------------- #12
// The streamed core's machinery (attention_stream.cuh): one block per (64
// query rows, head, batch row), one consumer warpgroup and one producer
// warp. The producer copies the Q tile once and, for each 128-key block,
// its K and V rows (one TMA box of 128 rows each, zero past L) into a ring
// of SEG_STAGES slots, with the keys' segments beside them. The consumers,
// one sweep over the blocks: S = Q . K^T by wgmma m64n128k16 (both from
// swizzled shared memory), the mask added in natural units, the block's
// max and sum merged across the row's four lanes before p is formed and
// rounded (the library's rounding points), P . V by wgmma m64n64k16 with P
// from registers and the V block read MN-major into a second accumulator,
// and the two folded with the reference's factors. exp is taken as
// exp2((s - m) log2 e), the difference first: the mask value times log2 e
// is below -FLT_MAX, and a masked first block would then give NaN where
// the library's rescale wipes it with a finite 0. The context leaves
// through the Q slot by a TMA store that clips rows >= L.
namespace seg {
constexpr int THREADS = 128 + 32;               // one consumer warpgroup + the producer warp
constexpr int STAGES = 2;                       // 128-key blocks in the ring
constexpr int ROW_BYTES = HEAD_DIM * 2;         // 128: one swizzle row
constexpr int KV_BYTES = SEG_BLOCK * ROW_BYTES; // K or V of one block: 16 KB
constexpr int Q_BYTES = SEG_TILE * ROW_BYTES;
constexpr int OFF_K = Q_BYTES;
constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
constexpr int OFF_SEG = OFF_V + STAGES * KV_BYTES;
constexpr int OFF_BAR = OFF_SEG + STAGES * SEG_BLOCK * 4;
constexpr int SMEM = OFF_BAR + (2 * STAGES + 1) * 8 + 1024;
}  // namespace seg

__global__ void __launch_bounds__(seg::THREADS, 2)
    segment_flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __grid_constant__ CUtensorMap omap,
                             const float* __restrict__ bias, float* __restrict__ stats, int L,
                             int n, float scale) {
  using namespace stream;
  constexpr int STAGES = seg::STAGES, NC = SEG_BLOCK / 8;  // 8-key column groups
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  int* sseg = reinterpret_cast<int*>(smem + seg::OFF_SEG);
  const uint32_t full = base + seg::OFF_BAR, empty = full + 8 * STAGES,
                 qbar = empty + 8 * STAGES;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * SEG_TILE;
  const int n_blocks = (L + SEG_BLOCK - 1) / SEG_BLOCK;
  const bool single = n_blocks == 1;  // the library kernel's one-step path
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* bias_row = bias + (size_t)b * L;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 32);  // the producer warp's lanes (+ the bytes)
      mbar_init(empty + 8 * s, 4);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // ---------------------------------------------- producer
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, seg::Q_BYTES);
      tma_load(base, &qmap, qbar, h, q0, b);
    }
    for (int j = 0; j < n_blocks; ++j) {
      const int st = j % STAGES, k0 = j * SEG_BLOCK;
      mbar_wait(empty + 8 * st, ((j / STAGES) & 1) ^ 1);
      for (int i = lane; i < SEG_BLOCK; i += 32)
        sseg[st * SEG_BLOCK + i] = segment_of(bias_row, k0 + i, L);
      if (lane == 0) {
        mbar_arrive_expect_tx(full + 8 * st, 2 * seg::KV_BYTES);
        tma_load(base + seg::OFF_K + st * seg::KV_BYTES, &kmap, full + 8 * st, h, k0, b);
        tma_load(base + seg::OFF_V + st * seg::KV_BYTES, &vmap, full + 8 * st, h, k0, b);
      } else {
        mbar_arrive(full + 8 * st);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const int seg_q[2] = {segment_of(bias_row, r0, L), segment_of(bias_row, r1, L)};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  mbar_wait(qbar, 0);
  for (int j = 0; j < n_blocks; ++j) {
    const int st = j % STAGES;
    mbar_wait(full + 8 * st, (j / STAGES) & 1);
    const uint32_t kslot = base + seg::OFF_K + st * seg::KV_BYTES;
    const uint32_t vslot = base + seg::OFF_V + st * seg::KV_BYTES;
    const int* sk = sseg + st * SEG_BLOCK;

    // masked scores of the warpgroup's 64 rows against the block's 128 keys
    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HEAD_DIM / 16; ++kk)
      gemm::wgmma_ss_n128<0, 0>(s, sw128_desc(base + 32 * kk), sw128_desc(kslot + 32 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int k0 = sk[8 * c + 2 * t], k1 = sk[8 * c + 2 * t + 1];
      s[4 * c + 0] = s[4 * c + 0] * scale + (seg_q[0] == k0 ? 0.f : SEG_MASK);
      s[4 * c + 1] = s[4 * c + 1] * scale + (seg_q[0] == k1 ? 0.f : SEG_MASK);
      s[4 * c + 2] = s[4 * c + 2] * scale + (seg_q[1] == k0 ? 0.f : SEG_MASK);
      s[4 * c + 3] = s[4 * c + 3] * scale + (seg_q[1] == k1 ? 0.f : SEG_MASK);
    }
    // online softmax: the block max, p = exp(s - m_next), the factors
    float keep_f[2], new_f[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float mc = -INFINITY;
#pragma unroll
      for (int c = 0; c < NC; ++c) mc = fmaxf(mc, fmaxf(s[4 * c + 2 * hi], s[4 * c + 2 * hi + 1]));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float m_next = fmaxf(m[hi], mc);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2((s[4 * c + 2 * hi + e] - m_next) * LOG2E);
          s[4 * c + 2 * hi + e] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float l_corr = ex2((m[hi] - m_next) * LOG2E) * l[hi];
      const float l_next = sum + l_corr;
      const float inv = l_next == 0.f ? 1.f : 1.f / l_next;
      if (single) {  // p / l rounded; the context is that product alone
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          s[4 * c + 2 * hi] = s[4 * c + 2 * hi] / l_next;
          s[4 * c + 2 * hi + 1] = s[4 * c + 2 * hi + 1] / l_next;
        }
        keep_f[hi] = 0.f;
        new_f[hi] = 1.f;
      } else {
        keep_f[hi] = l_corr * inv;
        new_f[hi] = inv;
      }
      m[hi] = m_next;
      l[hi] = l_next;
    }
    // P rounded to bf16 into A fragments (keys 16 kk .. + 15 are column
    // groups 2 kk and 2 kk + 1), P . V into oc
    uint32_t pa[SEG_BLOCK / 16][4];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      pa[c >> 1][2 * (c & 1) + 0] = pack2(s[4 * c + 0], s[4 * c + 1]);
      pa[c >> 1][2 * (c & 1) + 1] = pack2(s[4 * c + 2], s[4 * c + 3]);
    }
    float oc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) oc[i] = 0.f;
    fence_regs(oc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SEG_BLOCK / 16; ++kk)
      wgmma_rs_n64(oc, pa[kk], sw128_desc(vslot + kk * 16 * seg::ROW_BYTES));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp is done with the slot
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[4 * c + e] = o[4 * c + e] * keep_f[e >> 1] + oc[4 * c + e] * new_f[e >> 1];
  }

  // the context through the Q slot (swizzled as TMA reads it), the stats
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int r = warp * 16 + g;
    *reinterpret_cast<uint32_t*>(smem + r * 128 + ((c ^ g) << 4) + 4 * t) =
        pack2(o[4 * c], o[4 * c + 1]);
    *reinterpret_cast<uint32_t*>(smem + (r + 8) * 128 + ((c ^ g) << 4) + 4 * t) =
        pack2(o[4 * c + 2], o[4 * c + 3]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  if (warp == 0 && lane == 0) tma_store(&omap, base, h, q0, b);
  if (t == 0) {
    const size_t bnl = (size_t)gridDim.z * n * L;
    float* st = stats + ((size_t)b * n + h) * L;
    if (r0 < L) st[r0] = m[0], st[bnl + r0] = l[0];
    if (r1 < L) st[r1] = m[1], st[bnl + r1] = l[1];
  }
}

// ---------------------------------------------------------------- #12a
// #6a's rows pass (attention_train.cu attn_bwd_rows_kernel) with the
// segment mask, in one sweep: one block per (64 query rows, head, batch
// row), one consumer warpgroup and one producer warp (bwd::Cfg, two blocks
// a SM).
//   * The producer loads the tile's Q (the strided view into the fused
//     QKV projection), dO and O once by TMA, then streams K and V tiles of
//     64 keys through a ring of bwd::Cfg::STAGES slots, each with its keys'
//     segments (keys past L arrive as zero rows of segment 0). It starts a
//     slot's TMA copies first and issues every load of the segments before
//     its first store (#12b's lesson).
//   * The consumers take di = rowsum(o * dO) in fp32 from the O and dO
//     boxes (written for #12b) and each row's m and 1 / l from the
//     forward's statistics (rows past L: m = +inf, 1 / l = 0, so their P
//     is 0). Per key tile: S = Q . K^T and dP = dO . V^T (both K-major);
//     P = expf(s scale + mask - m) (1 / l), #12b's fp32 operations (the
//     mask added in natural units and the difference taken before expf:
//     exp2 of the difference times log2 e would overflow at the mask
//     value); dS = (dP - di) P scale rounded into A fragments; dQ += dS . K
//     with K read MN-major, one tile's dS . K under the next tile's S and
//     dP.
//   * The sweep covers ceil(L / 64) key tiles, not the library's Lp = 128
//     ceil(L / 128) keys: the keys in [L, Lp) have K = 0, so each adds
//     dS . 0 = 0 to dQ.
//   * dQ leaves through the O box (free once di is taken) by a TMA store
//     that clips the rows past L. No atomics: the output repeats bit for
//     bit.
namespace sega {
using C = bwd::Cfg;
static_assert(C::T == 64, "the producer's lanes stage two keys each");
constexpr int OFF_G = C::TILE, OFF_O = 2 * C::TILE;
constexpr int OFF_K = 3 * C::TILE;
constexpr int OFF_V = OFF_K + C::STAGES * C::TILE;
constexpr int OFF_SEG = OFF_V + C::STAGES * C::TILE;            // [slot][64] key segments
constexpr int OFF_BAR = OFF_SEG + C::STAGES * C::T * 4;
constexpr int SMEM = OFF_BAR + C::BARS + 1024;                 // + the alignment slack
}  // namespace sega

__global__ void __launch_bounds__(bwd::Cfg::THREADS, bwd::Cfg::MIN_BLOCKS)
    segment_flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                const __grid_constant__ CUtensorMap omap,
                                const __grid_constant__ CUtensorMap gmap,
                                const __grid_constant__ CUtensorMap dqmap,
                                const float* __restrict__ bias, const float* __restrict__ stats,
                                float* __restrict__ di_out, int L, int n, float scale) {
  using namespace stream;
  using C = bwd::Cfg;
  constexpr int T = C::T, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  int* sseg = reinterpret_cast<int*>(smem + sega::OFF_SEG);
  const uint32_t full = base + sega::OFF_BAR, empty = full + 8 * STAGES,
                 qbar = empty + 8 * STAGES;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * T;
  const int nt = (L + T - 1) / T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* bias_row = bias + (size_t)b * L;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 32);  // the producer warp's lanes (+ the bytes)
      mbar_init(empty + 8 * s, 4);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // ---------------------------------------------- producer
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, 3 * C::TILE);
      tma_load(base, &qmap, qbar, h, q0, b);
      tma_load(base + sega::OFF_G, &gmap, qbar, h, q0, b);
      tma_load(base + sega::OFF_O, &omap, qbar, h, q0, b);
    }
    for (int s = 0; s < nt; ++s) {
      const int st = s % STAGES, k0 = s * T;
      mbar_wait(empty + 8 * st, ((s / STAGES) & 1) ^ 1);
      if (lane == 0) {  // the tiles first, so that they load under the segments
        mbar_expect_tx(full + 8 * st, 2 * C::TILE);
        tma_load(base + sega::OFF_K + st * C::TILE, &kmap, full + 8 * st, h, k0, b);
        tma_load(base + sega::OFF_V + st * C::TILE, &vmap, full + 8 * st, h, k0, b);
      }
      // keys lane and lane + 32: both loads issued before the first store
      const int s0 = segment_of(bias_row, k0 + lane, L);
      const int s1 = segment_of(bias_row, k0 + lane + 32, L);
      sseg[st * T + lane] = s0;
      sseg[st * T + lane + 32] = s1;
      mbar_arrive(full + 8 * st);
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wl = warp, g = lane >> 2, t = lane & 3;
  const int r = wl * 16 + g;  // this lane's rows: q0 + r, q0 + r + 8
  const uint32_t qslot = base, gslot = base + sega::OFF_G;
  auto kslot = [&](int s) { return base + sega::OFF_K + (s % STAGES) * C::TILE; };
  auto vslot = [&](int s) { return base + sega::OFF_V + (s % STAGES) * C::TILE; };
  // each row's m, 1 / l and segment (rows past L: P = 0), loaded under the
  // producer's first copies
  const size_t bnl = (size_t)gridDim.z * n * L, at = ((size_t)b * n + h) * L;
  float m[2], inv[2];
  int seg_q[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = q0 + r + 8 * hi;
    const bool in = row < L;
    m[hi] = in ? stats[at + row] : INFINITY;
    const float l = in ? stats[bnl + at + row] : 0.f;
    inv[hi] = in ? 1.f / l : 0.f;
    seg_q[hi] = segment_of(bias_row, row, L);
  }

  // di = rowsum(o * dO) in fp32: lane t of a row's quad takes the row's
  // 16-byte groups 2t, 2t + 1 (swizzled by the row's low bits, g), the quad
  // merged by shuffles
  mbar_wait(qbar, 0);
  float di[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = r + 8 * hi;
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int off = row * 128 + (((2 * t + u) ^ g) << 4);
      const uint4 ov = *reinterpret_cast<const uint4*>(smem + sega::OFF_O + off);
      const uint4 gv = *reinterpret_cast<const uint4*>(smem + sega::OFF_G + off);
      const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w}, gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = bf16x2_to_float2(ow[e]), gf = bf16x2_to_float2(gw[e]);
        acc += of.x * gf.x + of.y * gf.y;
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    di[hi] = acc;
    if (t == 0 && q0 + row < L) di_out[at + q0 + row] = acc;
  }

  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  fence_regs(dq);
  uint32_t pa[4][4];  // dS of the tile whose dS . K starts next
  for (int s = 0; s < nt; ++s) {
    const int* sk = sseg + (s % STAGES) * T;
    float sc[32], dp[32];
    mbar_wait(full + 8 * (s % STAGES), (s / STAGES) & 1);
    wgmma_fence();
    bwd::product_xyt(sc, qslot, kslot(s));
    bwd::product_xyt(dp, gslot, vslot(s));
    wgmma_commit();
    if (s > 0) {
      wgmma_fence();
      bwd::product_ay(dq, pa, kslot(s - 1));
      wgmma_commit();
      wgmma_wait<1>();  // S and dP; dS . K still in flight
    } else {
      wgmma_wait<0>();
    }
    fence_regs(sc);
    fence_regs(dp);
#pragma unroll
    for (int c = 0; c < 8; ++c) {  // dS in place of S
      const int2 kseg = *reinterpret_cast<const int2*>(sk + 8 * c + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        const float sv = sc[4 * c + e] * scale + (seg_q[hi] == (e & 1 ? kseg.y : kseg.x) ? 0.f : SEG_MASK);
        const float p = expf(sv - m[hi]) * inv[hi];
        sc[4 * c + e] = (dp[4 * c + e] - di[hi]) * p * scale;
      }
    }
    if (s > 0) {
      wgmma_wait<0>();
      fence_regs(dq);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * ((s - 1) % STAGES));  // its K read
    }
    bwd::to_frags(pa, sc);
  }
  wgmma_fence();
  bwd::product_ay(dq, pa, kslot(nt - 1));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dq);

  // dQ through the O box, once every warp has taken its di
  bwd::consumers_sync();
  bwd::to_tile(smem + sega::OFF_O, dq, 1.f, wl, g, t);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bwd::consumers_sync();
  if (wl == 0 && lane == 0) tma_store(&dqmap, base + sega::OFF_O, h, q0, b);
}

// ---------------------------------------------------------------- #12b
// #6b's keys pass (attention_train.cu attn_bwd_keys_kernel) with the
// segment mask in place of the additive bias and the dropout: one block per
// (64 keys, head, batch row), one consumer warpgroup and one producer warp
// (bwd::Cfg, two blocks a SM).
//   * The block's K and V tiles stay in shared memory (TMA through maps
//     over the strided views; keys past L arrive as zero rows of segment 0).
//   * The producer streams Q and dO tiles of 64 queries through a ring of
//     bwd::Cfg::STAGES slots, each with its rows' m, 1 / l, di and segment
//     (rows past L: m = +inf, 1 / l = 0, di = 0, so their P is 0 and no
//     0 * inf reaches dK). It starts a slot's TMA copies first and issues
//     every load of the rows' data before its first store.
//   * Per tile, keys as the 64 wgmma rows: S^T = K . Q^T and dP^T =
//     V . dO^T (both K-major); P^T = expf(S^T scale + mask - m) (1 / l),
//     the fp32 operations of #12a and the plain version (the mask added in
//     natural units and the difference taken first, so a row whose m is
//     itself the mask value gets p = 1 / l); dS^T = (dP^T - di) P^T scale;
//     then dV += bf16(P^T) . dO and dK += bf16(dS^T) . Q with A from
//     registers and dO, Q read MN-major. dP^T runs under P^T's
//     exponentials; the two gradient products and the next tile's S^T
//     follow back to back.
//   * dK and dV leave through the K and V slots by TMA stores, which clip
//     the keys past L.
// Why (H100 timings at (128, 162), PERF.md): with the rows' data staged
// row by row after the copies, as #6b stages its statistics, the pass took
// 0.19 ms instead of 0.13, its blocks (three query tiles each at L = 162)
// waiting on the producer's load latencies; exp2 of the difference times
// log2 e took 0.123 ms against expf's 0.130, but #12a and #12b would then
// recompute two different P.
namespace segb {
using C = bwd::Cfg;
static_assert(C::T == 64, "the producer's lanes stage two rows each");
constexpr int OFF_V = C::TILE, OFF_Q = 2 * C::TILE;
constexpr int OFF_G = OFF_Q + C::STAGES * C::TILE;
constexpr int OFF_ROWS = OFF_G + C::STAGES * C::TILE;          // [slot][m, 1 / l, di, segment][64]
constexpr int OFF_BAR = OFF_ROWS + C::STAGES * 4 * C::T * 4;
constexpr int SMEM = OFF_BAR + C::BARS + 1024;                // + the alignment slack
}  // namespace segb

__global__ void __launch_bounds__(bwd::Cfg::THREADS, bwd::Cfg::MIN_BLOCKS)
    segment_flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                                  const __grid_constant__ CUtensorMap kmap,
                                  const __grid_constant__ CUtensorMap vmap,
                                  const __grid_constant__ CUtensorMap gmap,
                                  const __grid_constant__ CUtensorMap dkmap,
                                  const __grid_constant__ CUtensorMap dvmap,
                                  const float* __restrict__ bias, const float* __restrict__ stats,
                                  const float* __restrict__ di, int L, int n, float scale) {
  using namespace stream;
  using C = bwd::Cfg;
  constexpr int T = C::T, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* srows = reinterpret_cast<float*>(smem + segb::OFF_ROWS);
  const uint32_t full = base + segb::OFF_BAR, empty = full + 8 * STAGES,
                 kvbar = empty + 8 * STAGES;
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * T;
  const int nt = (L + T - 1) / T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* bias_row = bias + (size_t)b * L;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 32);  // the producer warp's lanes (+ the bytes)
      mbar_init(empty + 8 * s, 4);  // one arrival per consumer warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // ---------------------------------------------- producer
    if (lane == 0) {
      mbar_arrive_expect_tx(kvbar, 2 * C::TILE);
      tma_load(base, &kmap, kvbar, h, k0, b);
      tma_load(base + segb::OFF_V, &vmap, kvbar, h, k0, b);
    }
    const size_t bnl = (size_t)gridDim.z * n * L, at = ((size_t)b * n + h) * L;
    for (int s = 0; s < nt; ++s) {
      const int st = s % STAGES, q0 = s * T;
      mbar_wait(empty + 8 * st, ((s / STAGES) & 1) ^ 1);
      if (lane == 0) {  // the tiles first, so that they load under the rows' data
        mbar_expect_tx(full + 8 * st, 2 * C::TILE);
        tma_load(base + segb::OFF_Q + st * C::TILE, &qmap, full + 8 * st, h, q0, b);
        tma_load(base + segb::OFF_G + st * C::TILE, &gmap, full + 8 * st, h, q0, b);
      }
      // rows lane and lane + 32: every load issued before the first store
      float m[2], l[2], d[2], sg[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int row = q0 + lane + 32 * u;
        const bool in = row < L;
        m[u] = in ? stats[at + row] : INFINITY;
        l[u] = in ? stats[bnl + at + row] : 0.f;
        d[u] = in ? di[at + row] : 0.f;
        sg[u] = (float)segment_of(bias_row, row, L);
      }
      float* rw = srows + st * 4 * T;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = lane + 32 * u;
        rw[i] = m[u];
        rw[T + i] = q0 + i < L ? 1.f / l[u] : 0.f;
        rw[2 * T + i] = d[u];
        rw[3 * T + i] = sg[u];
      }
      mbar_arrive(full + 8 * st);
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wl = warp, g = lane >> 2, t = lane & 3;
  const int r0 = wl * 16 + g;  // this lane's keys: k0 + r0, k0 + r0 + 8
  float seg_k[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) seg_k[hi] = (float)segment_of(bias_row, k0 + r0 + 8 * hi, L);
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  fence_regs(dk);
  fence_regs(dv);
  auto qslot = [&](int s) { return base + segb::OFF_Q + (s % STAGES) * C::TILE; };
  auto gslot = [&](int s) { return base + segb::OFF_G + (s % STAGES) * C::TILE; };
  auto issue_st = [&](float(&acc)[32], int s) {  // S^T = K . Q^T of tile s
    mbar_wait(full + 8 * (s % STAGES), (s / STAGES) & 1);
    wgmma_fence();
    bwd::product_xyt(acc, base, qslot(s));
    wgmma_commit();
  };

  mbar_wait(kvbar, 0);
  float sc[32];
  issue_st(sc, 0);
  for (int s = 0; s < nt; ++s) {
    const int st = s % STAGES;
    const float* rw = srows + st * 4 * T;
    float dp[32];
    wgmma_fence();
    bwd::product_xyt(dp, base + segb::OFF_V, gslot(s));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int c = 0; c < 8; ++c) {  // P^T in place of S^T
      const int col = 8 * c + 2 * t;  // queries col, col + 1 of this tile
      const float2 m = *reinterpret_cast<const float2*>(rw + col);
      const float2 iv = *reinterpret_cast<const float2*>(rw + T + col);
      const float2 sq = *reinterpret_cast<const float2*>(rw + 3 * T + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1, lo = e & 1;
        const float sv = sc[4 * c + e] * scale + (seg_k[hi] == (lo ? sq.y : sq.x) ? 0.f : SEG_MASK);
        sc[4 * c + e] = expf(sv - (lo ? m.y : m.x)) * (lo ? iv.y : iv.x);
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int c = 0; c < 8; ++c) {  // dS^T in place of dP^T
      const float2 dd = *reinterpret_cast<const float2*>(rw + 2 * T + 8 * c + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * c + e] = (dp[4 * c + e] - (e & 1 ? dd.y : dd.x)) * sc[4 * c + e] * scale;
    }
    uint32_t pv[4][4], pk[4][4];
    bwd::to_frags(pv, sc);
    bwd::to_frags(pk, dp);
    wgmma_fence();
    bwd::product_ay(dv, pv, gslot(s));
    bwd::product_ay(dk, pk, qslot(s));
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
    if (lane == 0) mbar_arrive(empty + 8 * st);  // its Q and dO read
  }

  // dK and dV through the K and V slots (every product that read them is done)
  bwd::to_tile(smem, dk, 1.f, wl, g, t);
  bwd::to_tile(smem + segb::OFF_V, dv, 1.f, wl, g, t);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bwd::consumers_sync();
  if (wl == 0 && lane == 0) {
    tma_store(&dkmap, base, h, k0, b);
    tma_store(&dvmap, base + segb::OFF_V, h, k0, b);
  }
}

}  // namespace uc2

// q, k, v: [B, L, n, 64] bf16, tokens rs elements apart; bias [B, L] fp32;
// out [B, L, n, 64] bf16 contiguous; stats [2][B, n, L] fp32 (m, l);
// 1 <= L <= 512. Returns cudaGetLastError().
extern "C" int uc2_segment_flash_fwd(const void* q, const void* k, const void* v,
                                     const void* bias, void* out, void* stats, int B, int L,
                                     int n, int rs, float scale, void* stream) {
  using namespace uc2;
  if (L < 1 || L > MAX_LEN) return (int)cudaErrorInvalidValue;
  // on every call: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(segment_flash_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, seg::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap qm, km, vm, om;
  const size_t rb = (size_t)rs * 2;
  if (!stream::heads_map(&qm, q, B, L, n, rb, SEG_TILE) ||
      !stream::heads_map(&km, k, B, L, n, rb, SEG_BLOCK) ||
      !stream::heads_map(&vm, v, B, L, n, rb, SEG_BLOCK) ||
      !stream::heads_map(&om, out, B, L, n, (size_t)n * HEAD_DIM * 2, SEG_TILE))
    return (int)cudaErrorInvalidValue;
  dim3 grid((L + SEG_TILE - 1) / SEG_TILE, n, B);
  segment_flash_fwd_kernel<<<grid, seg::THREADS, seg::SMEM, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, om, static_cast<const float*>(bias), static_cast<float*>(stats), L, n, scale);
  return (int)cudaGetLastError();
}

// q, k, v, bias as above; out, g, dq [B, L, n, 64] bf16 contiguous (16-byte
// aligned); stats as the forward wrote them; di [B, n, L] fp32 (written).
// Returns cudaGetLastError().
extern "C" int uc2_segment_flash_bwd_dq(const void* q, const void* k, const void* v,
                                        const void* bias, const void* out, const void* g,
                                        const void* stats, void* dq, void* di, int B, int L,
                                        int n, int rs, float scale, void* stream) {
  using namespace uc2;
  if (L < 1 || L > MAX_LEN) return (int)cudaErrorInvalidValue;
  // a runtime call before the tensor maps are encoded: it makes the
  // device's context current in autograd's backward thread
  cudaError_t err = cudaFuncSetAttribute(segment_flash_bwd_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, sega::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap qm, km, vm, om, gm, dqm;
  const size_t rb = (size_t)rs * 2, gb = (size_t)n * HEAD_DIM * 2;
  constexpr int T = bwd::Cfg::T;
  if (!stream::heads_map(&qm, q, B, L, n, rb, T) || !stream::heads_map(&km, k, B, L, n, rb, T) ||
      !stream::heads_map(&vm, v, B, L, n, rb, T) || !stream::heads_map(&om, out, B, L, n, gb, T) ||
      !stream::heads_map(&gm, g, B, L, n, gb, T) || !stream::heads_map(&dqm, dq, B, L, n, gb, T))
    return (int)cudaErrorInvalidValue;
  return bwd::launch(segment_flash_bwd_dq_kernel, sega::SMEM, B, L, n,
                     static_cast<cudaStream_t>(stream), qm, km, vm, om, gm, dqm,
                     static_cast<const float*>(bias), static_cast<const float*>(stats),
                     static_cast<float*>(di), L, n, scale);
}

// q, k, v, bias, g as above; stats and di as #12 and #12a wrote them;
// dk, dv [B, L, n, 64] bf16 contiguous. Returns cudaGetLastError().
extern "C" int uc2_segment_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                          const void* bias, const void* g, const void* stats,
                                          const void* di, void* dk, void* dv, int B, int L,
                                          int n, int rs, float scale, void* stream) {
  using namespace uc2;
  if (L < 1 || L > MAX_LEN) return (int)cudaErrorInvalidValue;
  // a runtime call before the tensor maps are encoded: it makes the
  // device's context current in autograd's backward thread
  cudaError_t err = cudaFuncSetAttribute(segment_flash_bwd_dkdv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, segb::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap qm, km, vm, gm, dkm, dvm;
  const size_t rb = (size_t)rs * 2, gb = (size_t)n * HEAD_DIM * 2;
  constexpr int T = bwd::Cfg::T;
  if (!stream::heads_map(&qm, q, B, L, n, rb, T) || !stream::heads_map(&km, k, B, L, n, rb, T) ||
      !stream::heads_map(&vm, v, B, L, n, rb, T) || !stream::heads_map(&gm, g, B, L, n, gb, T) ||
      !stream::heads_map(&dkm, dk, B, L, n, gb, T) || !stream::heads_map(&dvm, dv, B, L, n, gb, T))
    return (int)cudaErrorInvalidValue;
  dim3 grid((L + T - 1) / T, n, B);
  segment_flash_bwd_dkdv_kernel<<<grid, bwd::Cfg::THREADS, segb::SMEM,
                                  static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, gm, dkm, dvm, static_cast<const float*>(bias),
      static_cast<const float*>(stats), static_cast<const float*>(di), L, n, scale);
  return (int)cudaGetLastError();
}
