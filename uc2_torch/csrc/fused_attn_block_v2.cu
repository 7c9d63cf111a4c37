// Fused attention block with the QKV projection inside the kernel, #7:
//   q_h, k_h, v_h = bf16(x . W_h^T + b_h)          (bias added in fp32)
//   out = LayerNorm(x + sum_h attention(q_h, k_h, v_h, bias) . Wo_h^T + bo)
//
// Replaces the TPU kernel uc2_tpu/ops/fused_block.py:_block2_kernel
// (launched by fused_attn_block_v2), which the reference's encoder runs on
// the fused inference route (L >= 128 under "pallas", every L under
// "fused-force") when UC2_ATTN_V2 is set. Its point there is that the
// [B, L, 3H] projection never reaches device memory; here it never leaves
// shared memory and registers either.
//
// Rounding is #7's, not the eager chain's: the projection's fp32 sum gets
// its fp32 bias before the bf16 rounding (the eager Dense rounds first).
// The rest is #2's (attn_block.cuh).
//
// Design, for Hopper, on #2's pieces. A cluster spans one batch row: block
// 2 i + half takes the row's 64-row query tile i (T = ceil(L / 64) tiles,
// so 2 T <= 16 blocks; above 8 a non-portable cluster size) and the heads
// and output columns of column half `half`, as in #2. Each K_h and V_h row
// is projected once, by the tile that owns it, and shared:
//   * the producer warp streams, for each of the block's six heads and each
//     64-input step, x's [64 x 64] box and W_h's three [64 x 64] boxes
//     (its q, k and v rows) into one 32 KB slot of a ring (TMA; x's rows
//     past L read as zeros), then the Wo slots as #2 does;
//   * consumer warpgroup 1 projects: [Q_h | K_h | V_h] of the tile, 64 x 192,
//     by wgmma m64n96k16 (96 fp32 accumulators a thread), adds the fp32
//     bias and rounds to bf16; it writes Q_h into the head's context box and
//     the K_h and V_h tiles into this block's row buffer of the head, then
//     sends those two tiles to the other T - 1 blocks of its half by bulk
//     copies into their row buffers (completing on their "K/V in"
//     barrier). It projects head k + 1 while warpgroup 0 attends head k,
//     and writes it once every block of its half has released head k
//     (a "K/V free" barrier each block arrives on remotely);
//   * consumer warpgroup 0 attends: #2's two sweeps (attend) over the whole
//     row held in shared memory, the context over the Q box;
//   * after the six heads each block sends its six context boxes into the
//     partner's (2 i + (half ^ 1)) row buffer, free by then; both
//     warpgroups compute ctx . Wo^T and run #2's epilogue.
// Shared memory: six context boxes (48 KB), the row buffer (2 T boxes,
// at least six: up to 128 KB at L = 512), and the ring: three slots up
// to L = 256, two up to L = 384, one above (no load then runs under a
// product: L > 384 is off the scoring path).
//
// What bounds it on an H100: operations. At (B, L) = (64, 162) the block
// needs 2 B L 768 3072 + 4 B 12 L^2 64 = 54.1 GFLOP (0.055 ms at 989
// TFLOP/s) against 32 MB of x and output. A block takes in 2.9 MB from L2
// (its six heads' W rows, x six times, its half of Wo): 64 rows a tile
// give 64 FLOP a weight byte, so the weight stream sets the pace, as in #3.
// Timed on the H100 (PERF.md): at most 17 clusters of six blocks are
// resident (102 of 132 SMs) at L = 162, 30 of four at L = 128; a second
// row buffer, so that head k + 1 is written while head k is attended,
// was no faster.
//
// The partial mode (PARTIAL, uc2_fused_attn_block_v2_partial; tensor
// parallelism over T processes): the same cluster over nh = 12 / T of the
// heads, W_qkv's rows of those heads ([q | k | v] of the shard, 3 nh 64
// rows) and Wo's matching nh 64 input columns, writing the fp32 partial
// ctx . Wo^T for the caller to sum over the model group (no bo, residual
// or LayerNorm). Column half `half` takes HeadSplit{nh}'s heads of its
// half (3 and 3 at T = 2, 2 and 1 at T = 4): the "K/V in" and "K/V free"
// barriers count the tiles of one half only, so each half runs its own
// head count, and the partner's context boxes arrive as that half's
// count. Bound by operations: at B = 64, L = 162, nh = 6 it is 27.0 GFLOP
// (0.027 ms) against 16 MB of x and 32 MB of the fp32 partial (0.015 ms).
#include "attn_block.cuh"

namespace uc2 {
namespace blk {

struct Cfg7 {
  // two consumer warpgroups + a producer warpgroup (one of its warps
  // works), whose registers setmaxnreg gives to the consumers
  static constexpr int THREADS = 384;
  static constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;
  static constexpr int SLOT = 4 * BOX;  // x, W_q, W_k, W_v boxes of one input step
  static constexpr int MAX_STAGES = 3;
  static constexpr int OFF_BIAS = 0;
  static constexpr int OFF_RED = OFF_BIAS + MAX_LEN * 4;
  static constexpr int OFF_BAR = OFF_RED + RED_BYTES;
  // kv in, kv free, partner ready, partner ctx, pfull/pempty[3], wfull/wempty[3]
  static constexpr int N_BARS = 4 + 4 * MAX_STAGES;
  static constexpr int OFF_CTX = 5 * 1024;  // 1024-aligned, after the barriers
  static constexpr int OFF_KV = OFF_CTX + 6 * BOX;
  static constexpr int SMEM_MAX = 232448;
  __host__ __device__ static int kv_bytes(int T) { return (2 * T > 6 ? 2 * T : 6) * BOX; }
  __host__ __device__ static int stages(int T) {
    const int s = (SMEM_MAX - 1024 - OFF_KV - kv_bytes(T)) / SLOT;
    return s < MAX_STAGES ? s : MAX_STAGES;
  }
  __host__ __device__ static int smem(int T) {
    return 1024 + OFF_KV + kv_bytes(T) + stages(T) * SLOT;
  }
};
static_assert(Cfg7::OFF_BAR + Cfg7::N_BARS * 8 <= Cfg7::OFF_CTX, "barriers before the boxes");
static_assert(WO_SLOT <= Cfg7::SLOT, "a Wo slot in a ring slot");

// PARTIAL: a launch over nh heads (a shard); pout [B, L, 768] receives the
// fp32 partial ctx . Wo^T, and omap, x, bo, gamma, beta are not read.
// Without it nh is 12.
template <bool PARTIAL>
__global__ void __launch_bounds__(Cfg7::THREADS, 1)
    fused_attn_block_v2_kernel(const __grid_constant__ CUtensorMap xmap,
                               const __grid_constant__ CUtensorMap wmap,
                               const __grid_constant__ CUtensorMap wom,
                               const __grid_constant__ CUtensorMap omap,
                               const bf16* __restrict__ x, const float* __restrict__ b_qkv,
                               const float* __restrict__ bias, const float* __restrict__ bo,
                               const float* __restrict__ gamma, const float* __restrict__ beta,
                               float* __restrict__ pout, int L, int T, int nh, float scale_log2,
                               float eps) {
  using C = Cfg7;
  // this half's heads h0 .. h0 + mine - 1 of the launch; part p (q, k, v)
  // of head h is W_qkv's rows rows_part p + 64 h
  const HeadSplit split{PARTIAL ? nh : 12};
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* sbias = reinterpret_cast<float*>(smem + C::OFF_BIAS);
  float* red = reinterpret_cast<float*>(smem + C::OFF_RED);
  const int NS = C::stages(T);
  const uint32_t kvin = base + C::OFF_BAR, kvfree = kvin + 8, pready = kvfree + 8,
                 pctx = pready + 8, pfull = pctx + 8, pempty = pfull + 8 * C::MAX_STAGES,
                 wfull = pempty + 8 * C::MAX_STAGES, wempty = wfull + 8 * C::MAX_STAGES;
  const uint32_t ctx = base + C::OFF_CTX, kv = base + C::OFF_KV;
  const uint32_t ring = kv + C::kv_bytes(T);
  const int rank = (int)cluster_rank(), half = rank & 1, tile = rank >> 1;
  const uint32_t partner = rank ^ 1;
  const int b = blockIdx.x / (2 * T), q0 = 64 * tile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h0 = split.half_first(half), mine = split.half_count(half);
  const int rows_part = 64 * split.nh;

  for (int i = threadIdx.x; i < 64 * T; i += C::THREADS)
    sbias[i] = i < L ? bias[(size_t)b * L + i] * LOG2E : -INFINITY;
  if (threadIdx.x == 0) {
    mbar_init(kvin, T);     // this block's projector + the other T - 1 tiles' (+ bytes)
    mbar_init(kvfree, T);   // the attending warpgroup of each tile of this half
    mbar_init(pready, 1);   // the partner: its row buffer is free for this block's context
    mbar_init(pctx, 1);     // the partner's six context boxes (+ bytes)
    for (int s = 0; s < C::MAX_STAGES; ++s) {
      mbar_init(pfull + 8 * s, 1);
      mbar_init(pempty + 8 * s, 4);  // the projecting warpgroup's warps
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, 8);  // both warpgroups' warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // every block's barriers exist before any remote arrive

  if (warp >= 8) {  // ------------------------------------------- producers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS));
    if (warp == 8 && lane == 0) {
      int s = 0;
      for (int k = 0; k < mine; ++k) {
        const int h = h0 + k;
        for (int ks = 0; ks < HIDDEN / 64; ++ks, ++s) {
          const int st = s % NS;
          mbar_wait(pempty + 8 * st, ((s / NS) & 1) ^ 1);
          mbar_arrive_expect_tx(pfull + 8 * st, C::SLOT);
          const uint32_t slot = ring + st * C::SLOT, bar = pfull + 8 * st;
          tma_load_3d(slot, &xmap, bar, 64 * ks, q0, b);
          for (int part = 0; part < 3; ++part)
            tma_load_2d(slot + (1 + part) * BOX, &wmap, bar, 64 * ks, rows_part * part + 64 * h);
        }
      }
      for (int e = s; e < s + NS; ++e)  // the ring given back, then Wo over it
        mbar_wait(pempty + 8 * (e % NS), ((e / NS) & 1) ^ 1);
      load_wo(&wom, ring, NS, C::SLOT, wfull, wempty, half, split.nh);
    }
    __syncwarp();
    cluster_sync();  // the consumers' two LayerNorm exchanges (PARTIAL: the end)
    if (!PARTIAL) cluster_sync();
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
  const int w = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const int r = wl * 16 + g;  // this thread's rows: r and r + 8 of the tile
  if (w == 1) {  // projector
    int s = 0;
    for (int k = 0; k < mine; ++k) {
      const int h = h0 + k;
      float acc[2][48];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int i = 0; i < 48; ++i) acc[p][i] = 0.f;
#pragma unroll 1
      for (int ks = 0; ks < HIDDEN / 64; ++ks, ++s) {
        const int st = s % NS;
        spin_wait(pfull + 8 * st, (s / NS) & 1);
        const uint32_t slot = ring + st * C::SLOT;
        const uint64_t da = sw128_desc(slot);
        wgmma_fence();
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint64_t db = sw128_desc(slot + BOX + p * WO_ROWS * 128);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_ss_n96(acc[p], da + 2 * kk, db + 2 * kk);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        __syncwarp();
        if (lane == 0) mbar_arrive(pempty + 8 * st);
      }
      // every tile of this half done with head k - 1 before its buffers
      // are written
      if (k > 0) spin_wait(kvfree, (k - 1) & 1);
      // + the fp32 bias, bf16: column c of the 192 is part c / 64 (q, k, v),
      // head dim c % 64; into Q_h's context box or the row buffer's tile
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int cc = 0; cc < 12; ++cc) {
          const int c = WO_ROWS * p + 8 * cc + 2 * t, part = c >> 6, d = c & 63;
          const float2 bb =
              *reinterpret_cast<const float2*>(b_qkv + rows_part * part + 64 * h + d);
          const uint32_t dst = part == 0 ? ctx + k * BOX
                                         : kv + ((part - 1) * T + tile) * BOX;
          uint8_t* dp = smem + (dst - base) + (((d >> 3) ^ g) << 4) + 4 * t;
          *reinterpret_cast<uint32_t*>(dp + r * 128) =
              pack2(acc[p][4 * cc] + bb.x, acc[p][4 * cc + 1] + bb.y);
          *reinterpret_cast<uint32_t*>(dp + (r + 8) * 128) =
              pack2(acc[p][4 * cc + 2] + bb.x, acc[p][4 * cc + 3] + bb.y);
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 2, 128;\n" ::: "memory");
      if (wl == 0 && lane == 0) {
        mbar_arrive(kvin);
        for (int j = 0; j < T; ++j) {
          if (j == tile) continue;
          const uint32_t peer = 2 * j + half, pbar = peer_addr(kvin, peer);
          mbar_arrive_expect_tx_cluster(pbar, 2 * BOX);
          for (int part = 0; part < 2; ++part) {
            const uint32_t src = kv + (part * T + tile) * BOX;
            bulk_copy_to_peer(peer_addr(src, peer), src, BOX, pbar);
          }
        }
      }
    }
  } else {  // attender
    for (int k = 0; k < mine; ++k) {
      spin_wait(kvin, k & 1);
      attend(ctx + k * BOX, smem + (ctx - base) + k * BOX, sbias, T, scale_log2,
             RowKV{kv, kv + T * BOX, T});
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (wl == 0 && lane == 0)  // head k's row buffers free in this block
        for (int j = 0; j < T; ++j) mbar_arrive_cluster(peer_addr(kvfree, 2 * j + half));
    }
    // the half's (six) context boxes into the partner's row buffer, once it
    // is free
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    if (wl == 0 && lane == 0) {
      mbar_arrive_cluster(peer_addr(pready, partner));
      spin_wait(pready, 0);
      const uint32_t pbar = peer_addr(pctx, partner);
      mbar_arrive_expect_tx_cluster(pbar, mine * BOX);
      for (int k = 0; k < mine; ++k)
        bulk_copy_to_peer(peer_addr(kv + k * BOX, partner), ctx + k * BOX, BOX, pbar);
    }
  }
  asm volatile("bar.sync 3, 256;\n" ::: "memory");  // this block's boxes are in

  float y[2][48];
  out_projection(
      y, ring, NS, C::SLOT, wfull, wempty, w,
      [&](int i) {
        if (i < mine) return ctx + i * BOX;
        if (i == mine) spin_wait(pctx, 0);
        return kv + (i - mine) * BOX;
      },
      split.nh);
  if constexpr (PARTIAL) {
    store_partial(y, half, w, pout, b, L, q0);
    cluster_sync();  // every copy between the blocks has landed
  } else {
    residual_ln_store(y, half, w, bo, x + ((size_t)b * L + q0) * HIDDEN, L - q0, gamma, beta,
                      eps, red, partner, smem + (ctx - base), ctx, &omap, q0, b);
  }
}

}  // namespace blk
}  // namespace uc2

// x, out: [B, L, 768] bf16 contiguous (16-byte aligned); w_qkv [2304, 768]
// bf16 as nn.Linear stores it (rows of q, then k, then v; head h's 64 rows
// at 64 h of each), 16-byte aligned; b_qkv [2304], bias [B, L], bo, gamma,
// beta [768] fp32; wo [768, 768] bf16 ([out, in]); n * 64 == 768,
// 1 <= L <= 512. Returns cudaGetLastError().
extern "C" int uc2_fused_attn_block_v2(const void* x, const void* w_qkv, const void* b_qkv,
                                       const void* bias, const void* wo, const void* bo,
                                       const void* gamma, const void* beta, void* out,
                                       int B, int L, int n, float scale, float eps,
                                       void* stream) {
  using namespace uc2;
  using namespace uc2::stream;
  using C = blk::Cfg7;
  if (B < 1 || L < 1 || L > MAX_LEN || n * HEAD_DIM != HIDDEN) return (int)cudaErrorInvalidValue;
  const int T = (L + 63) / 64;
  CUtensorMap xm, wm, wom, om;
  if (!rows_map_3d(&xm, x, B, L) || !map_2d(&wm, w_qkv, HIDDEN, 3 * HIDDEN, 64) ||
      !map_2d(&wom, wo, HIDDEN, HIDDEN, blk::WO_ROWS) || !rows_map_3d(&om, out, B, L))
    return (int)cudaErrorInvalidValue;
  return launch_clusters(blk::fused_attn_block_v2_kernel<false>, 2 * T * B, C::THREADS, 2 * T,
                         C::smem(T), static_cast<cudaStream_t>(stream), xm, wm, wom, om,
                         static_cast<const bf16*>(x), static_cast<const float*>(b_qkv),
                         static_cast<const float*>(bias), static_cast<const float*>(bo),
                         static_cast<const float*>(gamma), static_cast<const float*>(beta),
                         static_cast<float*>(nullptr), L, T, 12, scale * LOG2E, eps);
}

// #7's partial mode: x [B, L, 768] bf16 as above; w_qkv [3 n 64, 768] bf16
// (the shard's rows: q of its n heads, then k, then v), b_qkv [3 n 64]
// fp32, 1 <= n <= 12; bias [B, L] fp32; wo [768, n 64] bf16 (the shard's
// input columns of Wo, [out, in]), 16-byte aligned; out [B, L, 768] fp32
// contiguous, 8-byte aligned: ctx . Wo^T, no bias, residual or LayerNorm.
// Returns cudaGetLastError().
extern "C" int uc2_fused_attn_block_v2_partial(const void* x, const void* w_qkv,
                                               const void* b_qkv, const void* bias,
                                               const void* wo, void* out, int B, int L, int n,
                                               float scale, void* stream) {
  using namespace uc2;
  using namespace uc2::stream;
  using C = blk::Cfg7;
  if (B < 1 || L < 1 || L > MAX_LEN || n < 1 || n * HEAD_DIM > HIDDEN)
    return (int)cudaErrorInvalidValue;
  const int T = (L + 63) / 64;
  CUtensorMap xm, wm, wom, om;
  if (!rows_map_3d(&xm, x, B, L) || !map_2d(&wm, w_qkv, HIDDEN, 3 * n * HEAD_DIM, 64) ||
      !map_2d(&wom, wo, n * HEAD_DIM, HIDDEN, blk::WO_ROWS) || !rows_map_3d(&om, x, B, L))
    return (int)cudaErrorInvalidValue;
  return launch_clusters(blk::fused_attn_block_v2_kernel<true>, 2 * T * B, C::THREADS, 2 * T,
                         C::smem(T), static_cast<cudaStream_t>(stream), xm, wm, wom, om,
                         static_cast<const bf16*>(x), static_cast<const float*>(b_qkv),
                         static_cast<const float*>(bias), static_cast<const float*>(nullptr),
                         static_cast<const float*>(nullptr), static_cast<const float*>(nullptr),
                         static_cast<float*>(out), L, T, n, scale * LOG2E, 0.f);
}
