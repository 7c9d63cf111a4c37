// The pieces that the fused attention blocks #2 (fused_attn_block.cu) and
// #7 (fused_attn_block_v2.cu) share on Hopper:
//   attend            one head's attention for a 64-row query tile: the
//                     streamed core's two sweeps (attention_stream.cuh),
//                     Q from a swizzled [64 x 64] box in shared memory, the
//                     key tiles from a source that either streams them
//                     through an mbarrier ring (#2) or holds the whole row
//                     (#7); the bf16 context is written over the Q box;
//   out_projection    y = ctx . Wo^T for this block's 384 output columns
//                     (two consumer warpgroups of 192, 96 fp32 accumulators
//                     a thread), the ctx boxes of the 12 heads as wgmma's A
//                     and Wo slots arriving by TMA through a ring;
//   residual_ln_store y + bo + x, the row statistics merged with the other
//                     column half of the tile through distributed shared
//                     memory (#3's epilogue), LayerNorm, and the bf16 rows
//                     stored by TMA, which clips the rows past L (the
//                     whole-layer kernel #8, fused_layer_block.cu, keeps its
//                     first LayerNorm's output in fp32 instead, and takes
//                     its second without the residual);
//   load_heads        the producer's Q boxes and K/V ring of #2 and #8;
//   HeadSplit         which heads each block and warpgroup computes when
//                     a launch holds fewer than 12 (#2's and #7's partial
//                     modes);
//   store_partial     the partial modes' fp32 sums, without the epilogue.
// Numbers as the TPU kernels compute them: fp32 scores * 1/sqrt(64) + bias
// (in base 2: s * scale * log2 e + bias * log2 e), the softmax normalised
// in fp32 and then rounded to bf16, the bf16 context of each head, fp32
// sums of ctx . Wo^T, + bo + x in fp32, two-pass LayerNorm.
#pragma once

#include "cluster.cuh"

namespace uc2 {
namespace blk {

using namespace stream;

constexpr int BOX = 64 * 128;               // [64 rows x 64 bf16], 128-byte swizzle
constexpr int WO_ROWS = 96;                 // Wo rows a warpgroup takes from a slot
constexpr int WO_SLOT = 2 * WO_ROWS * 128;  // 24 KB: both warpgroups' rows of one k-box
constexpr int RED_BYTES = 2 * 2 * 2 * 64 * 4;  // [pass][half][warpgroup][row] fp32

// Key tiles streamed by TMA through a ring of STAGES slots (K, and V in
// sweep 2) that one consumer warpgroup owns: step s of a head is ring
// step s0 + s.
template <int STAGES>
struct RingKV {
  uint32_t k, v, full, empty;
  int s0;
  __device__ __forceinline__ uint32_t kaddr(int s) const { return k + ((s0 + s) % STAGES) * BOX; }
  __device__ __forceinline__ uint32_t vaddr(int s) const { return v + ((s0 + s) % STAGES) * BOX; }
  __device__ __forceinline__ void wait(int s) const {
    spin_wait(full + 8 * ((s0 + s) % STAGES), ((s0 + s) / STAGES) & 1);
  }
  __device__ __forceinline__ void release(int s) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * ((s0 + s) % STAGES));
  }
};

// The whole row's K and V of one head in shared memory (tile j at
// k + j BOX, v + j BOX), waited for before the head starts
struct RowKV {
  uint32_t k, v;
  int n_tiles;
  __device__ __forceinline__ uint32_t kaddr(int s) const { return k + (s % n_tiles) * BOX; }
  __device__ __forceinline__ uint32_t vaddr(int s) const { return v + (s - n_tiles) * BOX; }
  __device__ __forceinline__ void wait(int) const {}
  __device__ __forceinline__ void release(int) const {}
};

// The heads of a launch over nh of them (nh = 12: a whole layer; fewer:
// #2's and #7's partial modes, a tensor-parallel shard): column half `half` computes
// count(half) heads from first(half), its warpgroup 0 the first half of
// them rounded up and warpgroup 1 the rest; the out-projection of a half
// takes its own heads' k-boxes first, then the other half's. At nh = 12
// warpgroup w of half `half` computes heads 6 half + 3 w .. + 2.
struct HeadSplit {
  int nh;
  __device__ __forceinline__ int half_first(int half) const { return half ? (nh + 1) / 2 : 0; }
  __device__ __forceinline__ int half_count(int half) const { return half ? nh / 2 : (nh + 1) / 2; }
  __device__ __forceinline__ int first(int half, int w) const {
    return half_first(half) + (w ? (half_count(half) + 1) / 2 : 0);
  }
  __device__ __forceinline__ int count(int half, int w) const {
    return w ? half_count(half) / 2 : (half_count(half) + 1) / 2;
  }
  __device__ __forceinline__ int kbox(int i, int half) const {
    const int c = half_count(half);
    return i < c ? half_first(half) + i : half_first(half ^ 1) + i - c;
  }
};

// Producer warp w's loads (one lane) for consumer warpgroup w: the Q tiles
// of its `count` heads h0 .. h0 + count - 1 straight into their context
// boxes (boxes + h BOX), completing on wq (an arrival alone when it has
// none), then the K (and in the second sweep V) tiles of those heads
// through the warpgroup's ring of STAGES slots (K slots at kring, V slots
// after them) with full barriers wf and empty barriers we. Returns once
// the ring is given back (a parity wait is only sure on the ring of the
// warp that filled it: the other may lag a phase).
template <int STAGES>
__device__ __forceinline__ void load_heads(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                           const CUtensorMap* vmap, uint32_t boxes,
                                           uint32_t kring, uint32_t wq, uint32_t wf,
                                           uint32_t we, int h0, int count, int q0, int b,
                                           int T) {
  const uint32_t vring = kring + STAGES * BOX;
  if (count > 0) mbar_arrive_expect_tx(wq, count * BOX);
  else mbar_arrive(wq);
  for (int j = 0; j < count; ++j) {
    const int h = h0 + j;
    tma_load(boxes + h * BOX, qmap, wq, h, q0, b);
  }
  int s = 0;
  for (int j = 0; j < count; ++j) {
    const int h = h0 + j;
    for (int step = 0; step < 2 * T; ++step, ++s) {
      const int st = s % STAGES;
      const bool with_v = step >= T;
      mbar_wait(we + 8 * st, ((s / STAGES) & 1) ^ 1);
      mbar_arrive_expect_tx(wf + 8 * st, (with_v ? 2 : 1) * BOX);
      tma_load(kring + st * BOX, kmap, wf + 8 * st, h, 64 * (step % T), b);
      if (with_v) tma_load(vring + st * BOX, vmap, wf + 8 * st, h, 64 * (step - T), b);
    }
  }
  for (int e = s; e < s + STAGES; ++e) mbar_wait(we + 8 * (e % STAGES), ((e / STAGES) & 1) ^ 1);
}

// One head for the 64 query rows whose Q sits in the box at qbox (qptr its
// generic address), called by one consumer warpgroup; sbias: the batch
// row's bias times log2 e (-inf from key L on), 64 n_tiles entries. The
// consumer loop of attention_stream.cuh without dropout: sweep 1 folds
// each row's max and sum of exp2, sweep 2 rounds
// P = exp2(s - max) / sum to bf16 into wgmma A fragments and adds P . V,
// one step's P . V under the next step's scores. The context ends in the
// Q box, swizzled as TMA and wgmma read it.
template <class Src>
__device__ __forceinline__ void attend(uint32_t qbox, uint8_t* qptr, const float* sbias,
                                       int n_tiles, float scale_log2, const Src& src) {
  constexpr int NC = 8;  // 8-key column groups of a 64-key tile
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int steps = 2 * n_tiles;
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, inv[2];
  float o[32];

  auto start_scores = [&](float(&acc)[32], int s) {
    src.wait(s);
    const uint32_t kslot = src.kaddr(s);
    wgmma_fence();
    wgmma_ss_n64_first(acc, sw128_desc(qbox), sw128_desc(kslot));
#pragma unroll
    for (int kk = 1; kk < HEAD_DIM / 16; ++kk)
      wgmma_ss_n64(acc, sw128_desc(qbox + 32 * kk), sw128_desc(kslot + 32 * kk));
    wgmma_commit();
  };
  auto start_pv = [&](const uint32_t(&pa)[4][4], int s) {
    const uint32_t vslot = src.vaddr(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(o, pa[kk], sw128_desc(vslot + kk * 16 * 128));
    wgmma_commit();
  };
  auto add_bias = [&](float(&acc)[32], int s) {
    fence_regs(acc);
    const float* sb = sbias + 64 * (s % n_tiles);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float2 bb = *reinterpret_cast<const float2*>(sb + 8 * c + 2 * t);
      acc[4 * c + 0] = fmaf(acc[4 * c + 0], scale_log2, bb.x);
      acc[4 * c + 1] = fmaf(acc[4 * c + 1], scale_log2, bb.y);
      acc[4 * c + 2] = fmaf(acc[4 * c + 2], scale_log2, bb.x);
      acc[4 * c + 3] = fmaf(acc[4 * c + 3], scale_log2, bb.y);
    }
  };
  auto fold = [&](const float(&acc)[32]) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float tm = -INFINITY;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tm = fmaxf(tm, fmaxf(acc[4 * c + 2 * hi], acc[4 * c + 2 * hi + 1]));
      const float mn = fmaxf(mx[hi], tm);
      if (mn != -INFINITY) {
        float add = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          add += ex2(acc[4 * c + 2 * hi] - mn) + ex2(acc[4 * c + 2 * hi + 1] - mn);
        sum[hi] = sum[hi] * ex2(mx[hi] - mn) + add;
        mx[hi] = mn;
      }
    }
  };

  // sweep 1, one step at a time: two products in flight (as the streamed
  // core runs it) made ptxas serialise every wgmma of these kernels
  // (C7515), which cost more than the overlap gave (PERF.md)
  for (int s = 0; s < n_tiles; ++s) {
    float sa[32];
    start_scores(sa, s);
    wgmma_wait<0>();
    add_bias(sa, s);
    src.release(s);
    fold(sa);
  }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {  // merge the four lanes of each row; 1 / sum
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, mx[hi], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, sum[hi], off);
      const float mn = fmaxf(mx[hi], m2);
      sum[hi] = (mx[hi] == -INFINITY ? 0.f : sum[hi] * ex2(mx[hi] - mn)) +
                (m2 == -INFINITY ? 0.f : l2 * ex2(m2 - mn));
      mx[hi] = mn;
    }
    inv[hi] = 1.f / sum[hi];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  fence_regs(o);

  uint32_t pa[4][4];  // P of the step whose P . V starts next
  for (int s = n_tiles; s < steps; ++s) {  // sweep 2
    float sc[32];
    start_scores(sc, s);
    if (s > n_tiles) {
      start_pv(pa, s - 1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    add_bias(sc, s);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      sc[4 * c + 0] = ex2(sc[4 * c + 0] - mx[0]) * inv[0];
      sc[4 * c + 1] = ex2(sc[4 * c + 1] - mx[0]) * inv[0];
      sc[4 * c + 2] = ex2(sc[4 * c + 2] - mx[1]) * inv[1];
      sc[4 * c + 3] = ex2(sc[4 * c + 3] - mx[1]) * inv[1];
    }
    if (s > n_tiles) {
      wgmma_wait<0>();
      fence_regs(o);
      src.release(s - 1);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      pa[c >> 1][2 * (c & 1) + 0] = pack2(sc[4 * c + 0], sc[4 * c + 1]);
      pa[c >> 1][2 * (c & 1) + 1] = pack2(sc[4 * c + 2], sc[4 * c + 3]);
    }
  }
  start_pv(pa, steps - 1);
  wgmma_wait<0>();
  fence_regs(o);
  src.release(steps - 1);

  const int r = wl * 16 + g;  // the context over the Q box
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    *reinterpret_cast<uint32_t*>(qptr + r * 128 + ((c ^ g) << 4) + 4 * t) =
        pack2(o[4 * c], o[4 * c + 1]);
    *reinterpret_cast<uint32_t*>(qptr + (r + 8) * 128 + ((c ^ g) << 4) + 4 * t) =
        pack2(o[4 * c + 2], o[4 * c + 3]);
  }
}

// k-box i (0..11) of the out-projection of column half `half`: the half's
// own six heads first, then the other half's
__device__ __forceinline__ int kbox(int i, int half) {
  return i < 6 ? 6 * half + i : 6 * (half ^ 1) + i - 6;
}

// Wo slots of the out-projection over nh k-boxes (Wo's inputs), in the
// consumers' order: part p (two 96-column parts of each warpgroup's 192),
// k-box i is ring step nh p + i; its slot holds [96 rows x 64 inputs] of
// each warpgroup: rows 384 half + 192 w + 96 p, inputs 64 HeadSplit{nh}
// .kbox(i, half) (kbox at nh = 12). The ring: `stages` slots `stride`
// bytes apart; a consumer holds one slot at a time, so one stage is
// enough.
__device__ __forceinline__ void load_wo(const CUtensorMap* wom, uint32_t ring, int stages,
                                        int stride, uint32_t full, uint32_t empty, int half,
                                        int nh = 12) {
  const HeadSplit split{nh};
  for (int ws = 0; ws < 2 * nh; ++ws) {
    const int st = ws % stages, p = ws / nh, kb = split.kbox(ws % nh, half);
    mbar_wait(empty + 8 * st, ((ws / stages) & 1) ^ 1);
    mbar_arrive_expect_tx(full + 8 * st, WO_SLOT);
    const uint32_t slot = ring + st * stride;
    tma_load_2d(slot, wom, full + 8 * st, 64 * kb, 384 * half + WO_ROWS * p);
    tma_load_2d(slot + WO_SLOT / 2, wom, full + 8 * st, 64 * kb, 384 * half + 192 + WO_ROWS * p);
  }
  for (int e = 2 * nh; e < 2 * nh + stages; ++e)  // every slot given back: a lost one traps here
    mbar_wait(empty + 8 * (e % stages), ((e / stages) & 1) ^ 1);
}

// y[p] = ctx . Wo^T for warpgroup w's 192 columns (p: its two 96-column
// parts), over the nh k-boxes in load_wo's order; box(i) waits until
// k-box i is in and returns its address; the Wo slots as load_wo fills
// them. Both warpgroups read every slot (the empty barriers count their
// eight warps).
template <class Box>
__device__ __forceinline__ void out_projection(float (&y)[2][48], uint32_t ring, int stages,
                                               int stride, uint32_t full, uint32_t empty, int w,
                                               Box box, int nh = 12) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int i = 0; i < 48; ++i) y[p][i] = 0.f;
#pragma unroll 1
    for (int i = 0; i < nh; ++i) {
      const int s = nh * p + i;
      const uint64_t da = sw128_desc(box(i));
      spin_wait(full + 8 * (s % stages), (s / stages) & 1);
      const uint64_t db = sw128_desc(ring + (s % stages) * stride + w * (WO_SLOT / 2));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_n96(y[p], da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(y[p]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (s % stages));
    }
  }
}

// out = LayerNorm(y + bo + x) * gamma + beta for warpgroup w of column
// half `half` (columns 384 half + 192 w ..): x's rows (x + row0 768,
// `valid` of the tile's 64 rows before L) read from L2; the row sums of the
// four warpgroups of the tile merged through red (this block's and, by
// remote stores, the partner's: cluster rank `partner`) and two cluster
// barriers, which every thread of the cluster passes; the bf16 rows written
// into this block's six staging boxes (stage, generic and shared address)
// after the second barrier, when no one reads them any more, and stored by
// TMA at (column, q0, b) of omap. Without ADD, LayerNorm(y) (bo, xrows
// unread); with KEEP, y keeps the fp32 output and the boxes are not
// stored (omap unread): they end fenced for the async proxy and the
// warpgroup synchronised.
template <bool ADD = true, bool KEEP = false>
__device__ __forceinline__ void residual_ln_store(
    float (&y)[2][48], int half, int w, const float* __restrict__ bo,
    const bf16* __restrict__ xrows, int valid, const float* __restrict__ gamma,
    const float* __restrict__ beta, float eps, float* red, uint32_t partner, uint8_t* stage,
    uint32_t stage_s, const CUtensorMap* omap, int q0, int b) {
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int r = wl * 16 + g;  // this thread's rows: r and r + 8 of the tile
  const int col0 = 384 * half + 192 * w;
  const uint32_t red_peer = peer_addr(smem_u32(red), partner);
  float part[2] = {0.f, 0.f};
  if constexpr (ADD) {
    uint32_t xv[24][2];
#pragma unroll
    for (int j = 0; j < 24; ++j)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        xv[j][hi] = r + 8 * hi < valid
                        ? ldg32(xrows + (size_t)(r + 8 * hi) * HIDDEN + col0 + 8 * j + 2 * t)
                        : 0u;
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(bo + col0 + 8 * j + 2 * t);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const float2 xr = bf16x2_to_float2(xv[j][hi]);
        float& v0 = y[j / 12][4 * (j % 12) + 2 * hi];
        float& v1 = y[j / 12][4 * (j % 12) + 2 * hi + 1];
        v0 = (v0 + bb.x) + xr.x;
        v1 = (v1 + bb.y) + xr.y;
        part[hi] += v0 + v1;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 24; ++j)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        part[hi] += y[j / 12][4 * (j % 12) + 2 * hi] + y[j / 12][4 * (j % 12) + 2 * hi + 1];
  }
  float mean[2], rstd[2];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    float* rp = red + pass * 4 * 64;  // [half][w][row]
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float v = part[hi];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0) {
        const int i = (half * 2 + w) * 64 + r + 8 * hi;
        rp[i] = v;
        asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(red_peer +
                                                                4 * (pass * 4 * 64 + i)),
                     "f"(v)
                     : "memory");
      }
    }
    cluster_sync();
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) v += rp[q * 64 + r + 8 * hi];
      if (pass == 0) mean[hi] = v / HIDDEN;
      else rstd[hi] = rsqrtf(v / HIDDEN + eps);
    }
    if (pass == 0) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < 24; ++j) {
          const float d0 = y[j / 12][4 * (j % 12) + 2 * hi] - mean[hi];
          const float d1 = y[j / 12][4 * (j % 12) + 2 * hi + 1] - mean[hi];
          v += d0 * d0 + d1 * d1;
        }
        part[hi] = v;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 24; ++j) {
    const int col = col0 + 8 * j + 2 * t;
    const float2 gg = *reinterpret_cast<const float2*>(gamma + col);
    const float2 ee = *reinterpret_cast<const float2*>(beta + col);
    const int off = (3 * w + j / 8) * BOX + (((j & 7) ^ g) << 4) + 4 * t;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const float o0 = (y[j / 12][4 * (j % 12) + 2 * hi] - mean[hi]) * rstd[hi] * gg.x + ee.x;
      const float o1 = (y[j / 12][4 * (j % 12) + 2 * hi + 1] - mean[hi]) * rstd[hi] * gg.y + ee.y;
      if constexpr (KEEP) {
        y[j / 12][4 * (j % 12) + 2 * hi] = o0;
        y[j / 12][4 * (j % 12) + 2 * hi + 1] = o1;
      }
      *reinterpret_cast<uint32_t*>(stage + off + (r + 8 * hi) * 128) = pack2(o0, o1);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
  if (!KEEP && wl == 0 && lane == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) tma_store_3d(omap, stage_s + (3 * w + j) * BOX, col0 + 64 * j, q0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// The partial modes' end (#2's and #7's, tensor parallelism): warpgroup
// w's fp32 sums y of column half `half` for the 64-row query tile at q0 of
// batch row b, stored to out [B, L, 768] as float2 pairs, rows >= L
// skipped
__device__ __forceinline__ void store_partial(const float (&y)[2][48], int half, int w,
                                              float* __restrict__ out, int b, int L, int q0) {
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int r = wl * 16 + g, col0 = 384 * half + 192 * w;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = q0 + r + 8 * hi;
    if (row < L) {
      float* orow = out + ((size_t)b * L + row) * HIDDEN + col0 + 2 * t;
#pragma unroll
      for (int j = 0; j < 24; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(y[j / 12][4 * (j % 12) + 2 * hi], y[j / 12][4 * (j % 12) + 2 * hi + 1]);
    }
  }
}

// Publish a finished [64 x 64] box (written by this warpgroup's generic
// stores): to this block by an arrival on bar, and to block `partner` of
// the cluster by one bulk copy into the same offset of its shared memory
// that completes on its barrier at the same offset.
__device__ __forceinline__ void publish_box(uint32_t box, uint32_t bar, uint32_t partner,
                                            int w) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
  if ((threadIdx.x & 127) == 0) {
    mbar_arrive(bar);
    const uint32_t pbar = peer_addr(bar, partner);
    mbar_arrive_expect_tx_cluster(pbar, BOX);
    bulk_copy_to_peer(peer_addr(box, partner), box, BOX, pbar);
  }
}

}  // namespace blk
}  // namespace uc2
