// Fused FFN block for inference, kernel #3:
//   out = LayerNorm(bf16(gelu_erf(x . W1^T + b1)) . W2^T + b2 + x) * gamma + beta
// with fp32 sums in both products, the GELU output rounded to bf16 where
// the TPU kernel rounds it, and fp32 two-pass LayerNorm statistics; and
// the training FFN block's forward, kernel #9 (DROP), the same function
// with the output dropout before the residual:
//   out = LayerNorm(dropout(bf16(gelu_erf(x . W1^T + b1)) . W2^T + b2) + x) ...
//
// Replaces the TPU kernels uc2_tpu/ops/fused_block.py:_ffn_kernel
// (launched by fused_ffn_block), which the encoder runs in every layer of
// every scored batch, and uc2_tpu/ops/ffn_train.py:_fwd_kernel (launched by
// _ffn_train_fwd / fused_ffn_block_train), which every layer of a training
// step runs under use_pallas_attention="pallas-train" with UC2_FFN_TRAIN=1
// (its backward, #10, is ffn_train_bwd.cu). The property kept from them:
// the [rows, F] intermediate never reaches device memory (the wrappers
// allocate only the output).
//
// #9's dropout: the keep bit of output (row, col) is Philox4x32-10 of its
// global index (philox.cuh ffn_keep_bits4), never of a tile, so #10 redraws
// the mask though it tiles differently. In the epilogue a thread's two
// columns 8 j + 2 t, + 1 lie in one 4-column group, which lanes t and t ^ 1
// share: each lane draws the group of one of its two rows and swaps the
// bits with its partner, 24 draws a thread; then y2 = keep ? (y + b2) /
// (1 - rate) : 0 before + x. Without DROP (#3, and #9 at rate 0) the
// epilogue is (y + b2) + x, so #9 at rate 0 is #3's launch, bit for bit.
//
// Design, for Hopper. A 64-row tile of x (wgmma's M) belongs to a cluster
// of two blocks on neighbouring SMs; block `rank` owns output columns
// 384 rank .. + 383. Each block has two consumer warpgroups (192 output
// columns each) and a producer warpgroup:
//   * the producer's warps 0 and 1 each feed one consumer warpgroup's ring
//     of STAGES 12 KB slots by TMA, from tensor maps over W1 and W2 as
//     nn.Linear stores them (128-byte swizzle), guarded by full/empty
//     mbarriers; warp 0 also stages the tile's x once (96 KB). A ring
//     carries, in its warpgroup's order, W1 boxes [64 rows x 64 inputs] of
//     the chunks whose h the warpgroup computes and W2 slots [96 rows x
//     the chunk's 64 columns];
//   * GEMM 1: the intermediate is walked in chunks of FC = 64 columns; the
//     four consumer warpgroups of the cluster take the chunks in turn
//     (chunk c: block c % 2, warpgroup (c / 2) % 2), each AHEAD = 3 chunks
//     before the cluster multiplies it, so the four work at once. The
//     chunk's warpgroup computes x . W1^T by wgmma m64n64k16, adds b1,
//     applies the exact erf GELU and writes the bf16 h tile (8 KB,
//     swizzled) into one of NH = 4 h buffers, publishes it to its own
//     block by an mbarrier arrival and to the peer by one bulk copy
//     (cp.async.bulk into distributed shared memory) that completes on the
//     peer's barrier;
//   * GEMM 2: every consumer warpgroup of the cluster waits for each
//     chunk's h, loads it into wgmma A fragments (ldmatrix), gives the
//     buffer back (an arrival on "h empty" in the writing block), and adds
//     h . W2^T for its 192 output columns by wgmma m64n96k16 with A from
//     registers; the 96 fp32 accumulators a thread stay in registers for
//     the whole walk. setmaxnreg gives the consumers 240 registers a
//     thread and the producer 24;
//   * epilogue: y + b2 + x (x read back from its shared tile), the row
//     sums of the four warpgroups merged through distributed shared memory
//     and two cluster barriers, LayerNorm, and the bf16 rows written over
//     the block's half of the x tile and stored by TMA, which clips the
//     rows past the end.
// Why this split (chosen by H100 timings of the alternatives, PERF.md):
//   * a whole 64 x 768 fp32 row tile in one block's registers (two
//     warpgroups of 384 columns, 192 accumulators a thread) leaves GEMM 1
//     too few registers and ran slower, and at L = 162 its 162 tiles are
//     1.23 waves of 132 SMs, two rounds of a whole tile.
//     Two half-tile blocks keep 96 accumulators a thread and run L = 162
//     as 324 blocks (2.45 waves of half the work);
//   * h crosses to the peer as one bulk copy per chunk: remote stores of
//     every thread with a cluster-scope fence and release cost more than
//     the products;
//   * the weights come from L2 once a row tile (9.4 MB): pairs of row
//     tiles sharing each slot by TMA multicast halve the L2 reads but were
//     no faster, since each block still takes in its 4.7 MB.
//
// What bounds it on an H100: operations. At B = 64, L = 162 (10368 rows),
// F = 3072 the two products are 97.8 GFLOP (0.099 ms at 989 TFLOP/s)
// against 41 MB of x, weights and output (0.012 ms at 3.35 TB/s). A
// block does 64 FLOP for each weight byte it takes in (64 rows a tile),
// and its rings (96 KB, what x and h leave of shared memory) do not bring
// the weights in as fast as the tensor cores would use them: with the
// products taken out the kernel keeps most of its time (PERF.md). x's
// 96 KB tile, which GEMM 1 reads whole, keeps the tile at 64 rows. #9 at
// the mix bucket's 20736 rows makes 196 GFLOP (0.198 ms); its Philox
// draws, 24 a thread in the epilogue, cost no time measurable beside #3's
// on the same rows (PERF.md).
#include "cluster.cuh"

namespace uc2 {
namespace ffn {

using namespace stream;

struct Cfg {
  static constexpr int BM = 64;                  // rows a tile (wgmma's M)
  static constexpr int CLUSTER = 2;              // blocks a tile: its two column halves
  static constexpr int NWG = 2;                  // consumer warpgroups a block
  // + a producer warpgroup: setmaxnreg moves registers within a block, so
  // the consumers' 240 come from the producer's whole warpgroup
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int FC = 64;                  // intermediate columns a chunk
  static constexpr int OUT_BLOCK = HIDDEN / 2;   // 384 output columns a block
  static constexpr int OUT_WG = OUT_BLOCK / NWG; // 192 a warpgroup
  static constexpr int BOX = 64 * 128;           // a [64 x 64] bf16 box
  static constexpr int W2_ROWS = 96;             // W2 rows a slot (GEMM 2's wgmma N)
  static constexpr int NW2 = OUT_WG / W2_ROWS;   // 2 W2 slots a chunk and warpgroup
  static constexpr int ACC = W2_ROWS / 2;        // accumulators a thread a W2 slot
  static constexpr int SLOT = W2_ROWS * 128;     // 12 KB: a W1 box, or 96 W2 rows
  static constexpr int STAGES = 4;               // slots of each warpgroup's ring
  static constexpr int KB = HIDDEN / 64;         // x's twelve 64-column boxes
  // chunk c's h is computed by warpgroup (c / 2) % 2 of block c % 2 while
  // the cluster multiplies chunk c - AHEAD: the four producers of h work at
  // once. NH buffers, buffer c % NH always written by chunk c's warpgroup.
  static constexpr int AHEAD = 3, NH = 4;
  static constexpr int OFF_H = KB * BOX;         // h buffers: [64 x 64] bf16, swizzled
  static constexpr int OFF_RING = OFF_H + NH * BOX;
  static constexpr int OFF_RED = OFF_RING + NWG * STAGES * SLOT;
  static constexpr int OFF_BAR = OFF_RED + 2 * 2 * NWG * BM * 4;  // [pass][block][wg][row]
  // full[wg][STAGES], empty[wg][STAGES], x, h full[NH], h empty[NH]
  static constexpr int N_BARS = 2 * NWG * STAGES + 1 + 2 * NH;
  static constexpr int USED = OFF_BAR + N_BARS * 8;
  // all a block may have: the layout starts at the first 1024-byte
  // boundary, and the kernel traps if that leaves less than USED
  static constexpr int SMEM = 232448;
  static constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;
};
static_assert(Cfg::AHEAD < Cfg::NH && Cfg::NH == 4, "buffer c % 4 has one writer");
static_assert(Cfg::USED <= Cfg::SMEM, "shared memory of one block");
static_assert(Cfg::W2_ROWS == 96, "GEMM 2 is m64n96k16");

// d += A . B^T, m64n96k16: A as bf16 fragments in registers, B K-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

template <bool DROP>
__global__ void __launch_bounds__(Cfg::THREADS, 1)
    fused_ffn_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap w1map,
                     const __grid_constant__ CUtensorMap w2map,
                     const __grid_constant__ CUtensorMap omap, const float* __restrict__ b1,
                     const float* __restrict__ b2, const float* __restrict__ gamma,
                     const float* __restrict__ beta, int F, float eps, Dropout dr) {
  using C = Cfg;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  if (base - raw + C::USED > C::SMEM) __trap();
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t xs = base, hs = base + C::OFF_H, ring = base + C::OFF_RING;
  float* red = reinterpret_cast<float*>(smem + C::OFF_RED);
  const uint32_t bars = base + C::OFF_BAR;
  // full[w][st] at bars + 8 (w STAGES + st), empty[w][st] after them
  const uint32_t full = bars, empty = bars + 8 * C::NWG * STAGES,
                 xbar = empty + 8 * C::NWG * STAGES, hfull = xbar + 8,
                 hempty = hfull + 8 * C::NH;
  // rank: this block's column half; peer: the other half of its tile
  const int rank = (int)cluster_rank(), peer = rank ^ 1;
  const int r0 = (int)(blockIdx.x / C::CLUSTER) * C::BM;
  const int n_chunks = F / C::FC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::NWG * STAGES; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer warp (+ the bytes)
      mbar_init(empty + 8 * s, 4);  // the consumer warpgroup's warps
    }
    mbar_init(xbar, 1);
    for (int b = 0; b < C::NH; ++b) {
      mbar_init(hfull + 8 * b, 1);                // the warpgroup that wrote the h buffer
      mbar_init(hempty + 8 * b, 4 * 2 * C::NWG);  // every consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // the peer's barriers exist before any remote arrive

  if (warp >= 4 * C::NWG) {  // ---------------------------- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS));
    const int w = warp - 4 * C::NWG;  // the consumer warpgroup whose ring this warp feeds
    if (w < C::NWG && lane == 0) {
      if (w == 0) {
        mbar_arrive_expect_tx(xbar, C::KB * C::BOX);
        for (int kb = 0; kb < C::KB; ++kb)
          tma_load_2d(xs + kb * C::BOX, &xmap, xbar, 64 * kb, r0);
      }
      const uint32_t my_full = full + 8 * w * STAGES, my_empty = empty + 8 * w * STAGES;
      const uint32_t my_ring = ring + w * STAGES * C::SLOT;
      int s = 0;
      auto next_slot = [&](uint32_t bytes) {  // wait for a free slot; returns it
        const int st = s % STAGES;
        mbar_wait(my_empty + 8 * st, ((s / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(my_full + 8 * st, bytes);
        return st;
      };
      auto load = [&](int st, const CUtensorMap* map, int c0, int c1) {
        tma_load_2d(my_ring + st * C::SLOT, map, my_full + 8 * st, c0, c1);
      };
      // the consumer warpgroup's order: W1 of chunk i + AHEAD where it
      // computes that chunk's h, then W2 of chunk i
      for (int i = -C::AHEAD; i < n_chunks; ++i) {
        const int j = i + C::AHEAD;
        if (j < n_chunks && (j & 3) == 2 * w + rank) {
          for (int q = 0; q < C::KB; ++q, ++s)  // the chunk's rows, inputs 64 q ..
            load(next_slot(C::BOX), &w1map, 64 * q, C::FC * j);
        }
        if (i < 0) continue;
        for (int h = 0; h < C::NW2; ++h, ++s)  // W2 rows 384 rank + 192 w + W2_ROWS h .., chunk i's columns
          load(next_slot(C::SLOT), &w2map, C::FC * i,
               C::OUT_BLOCK * rank + C::OUT_WG * w + C::W2_ROWS * h);
      }
      // the releases of the last slots: a consumer that never gets its
      // data shows as a trap here rather than as a hang
      for (int e = s; e < s + STAGES; ++e)
        mbar_wait(my_empty + 8 * (e % STAGES), ((e / STAGES) & 1) ^ 1);
    }
    __syncwarp();
    cluster_sync();  // the consumers' two LayerNorm exchanges
    cluster_sync();
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const int r = wl * 16 + g;  // this thread's rows: r and r + 8 of the tile
  const uint32_t my_full = full + 8 * wg * STAGES, my_empty = empty + 8 * wg * STAGES;
  const uint32_t my_ring = ring + wg * STAGES * C::SLOT;
  // output columns W2_ROWS h + 8 jj + 2 t (+1) of the warpgroup's 192
  float y[C::NW2][C::ACC];
#pragma unroll
  for (int h = 0; h < C::NW2; ++h)
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) y[h][i] = 0.f;

  int s = 0;  // this warpgroup's slots, in the producer's order
  auto wait_full = [&](int e) { spin_wait(my_full + 8 * (e % STAGES), (e / STAGES) & 1); };
  auto release = [&](int e) {  // this warp is done with slot e
    __syncwarp();
    if (lane == 0) mbar_arrive(my_empty + 8 * (e % STAGES));
  };

  spin_wait(xbar, 0);
  const int me = 2 * wg + rank;  // this warpgroup computes the h of chunks c % 4 == me
  for (int i = -C::AHEAD; i < n_chunks; ++i) {
    const int j = i + C::AHEAD;
    if (j < n_chunks && (j & 3) == me) {
      // GEMM 1: chunk j's 64 columns over the 768 inputs. The slots are
      // walked without unrolling, so that no descriptors of x's boxes are
      // kept across chunks; a descriptor plus (byte offset >> 4) moves its
      // start.
      float a1[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) a1[k] = 0.f;
#pragma unroll 1
      for (int q = 0; q < C::KB; ++q, ++s) {
        wait_full(s);
        const uint64_t da = sw128_desc(xs + q * C::BOX);
        const uint64_t db = sw128_desc(my_ring + (s % STAGES) * C::SLOT);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64(a1, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        if (q > 0) {
          wgmma_wait<1>();
          release(s - 1);
        }
      }
      wgmma_wait<0>();
      fence_regs(a1);
      release(s - 1);
      // the buffer's previous chunk (j - NH) read by all four warpgroups
      const int hb = j % C::NH, use = j / C::NH;
      const uint32_t hbuf = hs + hb * C::BOX;
      if (use > 0) spin_wait(hempty + 8 * hb, (use - 1) & 1);
      // + b1, GELU, bf16 into this block's h buffer (rows of 128 bytes,
      // 16-byte groups swizzled by the row's low three bits)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int col = 8 * cc + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(b1 + C::FC * j + col);
        const uint32_t v0 = pack2(gelu_erf(a1[4 * cc] + bb.x), gelu_erf(a1[4 * cc + 1] + bb.y));
        const uint32_t v1 =
            pack2(gelu_erf(a1[4 * cc + 2] + bb.x), gelu_erf(a1[4 * cc + 3] + bb.y));
        const uint32_t off0 = r * 128 + ((cc ^ g) << 4) + 4 * t, off1 = off0 + 8 * 128;
        *reinterpret_cast<uint32_t*>(smem + (hbuf - base) + off0) = v0;
        *reinterpret_cast<uint32_t*>(smem + (hbuf - base) + off1) = v1;
      }
      // published: to this block's readers by the arrival, to the peer's by
      // one bulk copy of the tile that completes on the peer's barrier
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      if (wl == 0 && lane == 0) {
        mbar_arrive(hfull + 8 * hb);
        const uint32_t peer_full = peer_addr(hfull + 8 * hb, peer);
        mbar_arrive_expect_tx_cluster(peer_full, C::BOX);
        bulk_copy_to_peer(peer_addr(hbuf, peer), hbuf, C::BOX, peer_full);
      }
    }
    if (i < 0) continue;

    // GEMM 2: y += h . W2^T of chunk i for this warpgroup's 192 columns
    const int hb = i % C::NH, use = i / C::NH;
    const uint32_t hbuf = hs + hb * C::BOX;
    spin_wait(hfull + 8 * hb, use & 1);
    uint32_t ha[4][4];  // the h tile's A fragments, k16 slices kk
    const int hr = wl * 16 + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldsm_x4(ha[kk], hbuf + hr * 128 + (((2 * kk + (lane >> 4)) ^ (hr & 7)) << 4));
    __syncwarp();
    // the buffer back to its writer, block i % 2
    if (lane == 0) mbar_arrive_cluster(peer_addr(hempty + 8 * hb, i & 1));
#pragma unroll
    for (int h = 0; h < C::NW2; ++h) {
      wait_full(s + h);
      const uint64_t db = sw128_desc(my_ring + ((s + h) % STAGES) * C::SLOT);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n96(y[h], ha[kk], db + 2 * kk);
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < C::NW2; ++h) {
      fence_regs(y[h]);
      release(s + h);
    }
    s += C::NW2;
  }

  // y + b2 + x (DROP: dropout(y + b2) + x); the row statistics over the
  // cluster's 768 columns. This thread's column 8 j + 2 t of the
  // warpgroup's 192 lies in x's box 6 rank + 3 wg + j / 8, 16-byte group
  // j % 8.
  const int col0 = C::OUT_BLOCK * rank + C::OUT_WG * wg;
  const uint32_t red_peer = peer_addr(smem_u32(red), peer);
  float part[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 24; ++j) {
    const int col = col0 + 8 * j + 2 * t;
    const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
    const int off = (col >> 6) * C::BOX + (((j & 7) ^ g) << 4) + 4 * t;
    uint32_t keep[2] = {0u, 0u};  // rows r, r + 8: the keep bits of col, col + 1
    if constexpr (DROP) {
      // this lane draws row r + 8 (t & 1); its partner t ^ 1 the other
      const uint32_t mine = ffn_keep_bits4(dr.seed, dr.thresh, (uint32_t)col >> 2,
                                           (uint32_t)(r0 + r + 8 * (t & 1)));
      const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
      keep[0] = ((t & 1) ? other : mine) >> (col & 3);
      keep[1] = ((t & 1) ? mine : other) >> (col & 3);
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const float2 xr =
          bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(smem + off + (r + 8 * hi) * 128));
      float& v0 = y[j / (C::ACC / 4)][4 * (j % (C::ACC / 4)) + 2 * hi];
      float& v1 = y[j / (C::ACC / 4)][4 * (j % (C::ACC / 4)) + 2 * hi + 1];
      if constexpr (DROP) {
        v0 = ((keep[hi] & 1u) ? (v0 + bb.x) * dr.keep_scale : 0.f) + xr.x;
        v1 = ((keep[hi] & 2u) ? (v1 + bb.y) * dr.keep_scale : 0.f) + xr.y;
      } else {
        v0 = (v0 + bb.x) + xr.x;
        v1 = (v1 + bb.y) + xr.y;
      }
      part[hi] += v0 + v1;
    }
  }
  float mean[2], rstd[2];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    // red[pass][block][wg][row], written in both blocks
    float* rp = red + pass * 2 * C::NWG * C::BM;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float v = part[hi];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0) {
        const int i = (rank * C::NWG + wg) * C::BM + r + 8 * hi;
        rp[i] = v;
        asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(
                         red_peer + 4 * (pass * 2 * C::NWG * C::BM + i)),
                     "f"(v)
                     : "memory");
      }
    }
    cluster_sync();
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < 2 * C::NWG; ++w) v += rp[w * C::BM + r + 8 * hi];
      if (pass == 0) mean[hi] = v / HIDDEN;
      else rstd[hi] = rsqrtf(v / HIDDEN + eps);
    }
    if (pass == 0) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < 24; ++j) {
          const float d0 = y[j / (C::ACC / 4)][4 * (j % (C::ACC / 4)) + 2 * hi] - mean[hi];
          const float d1 = y[j / (C::ACC / 4)][4 * (j % (C::ACC / 4)) + 2 * hi + 1] - mean[hi];
          v += d0 * d0 + d1 * d1;
        }
        part[hi] = v;
      }
    }
  }
  // the normalised rows over this warpgroup's three boxes of the x tile
  // (each element is read above and written here by the same thread; no
  // GEMM 1 reads x any more: every chunk's h was in before the last
  // GEMM 2), then TMA
#pragma unroll
  for (int j = 0; j < 24; ++j) {
    const int col = col0 + 8 * j + 2 * t;
    const float2 gg = *reinterpret_cast<const float2*>(gamma + col);
    const float2 ee = *reinterpret_cast<const float2*>(beta + col);
    const int off = (col >> 6) * C::BOX + (((j & 7) ^ g) << 4) + 4 * t;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const float o0 = (y[j / (C::ACC / 4)][4 * (j % (C::ACC / 4)) + 2 * hi] - mean[hi]) * rstd[hi] * gg.x + ee.x;
      const float o1 = (y[j / (C::ACC / 4)][4 * (j % (C::ACC / 4)) + 2 * hi + 1] - mean[hi]) * rstd[hi] * gg.y + ee.y;
      *reinterpret_cast<uint32_t*>(smem + off + (r + 8 * hi) * 128) = pack2(o0, o1);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (wl == 0 && lane == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int kb = (col0 >> 6) + j;
      tma_store_2d(&omap, xs + kb * C::BOX, 64 * kb, r0);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// The kernel on `rows` rows of x (DROP: with the output dropout dr)
template <bool DROP>
inline int run(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               const void* gamma, const void* beta, void* out, int rows, int F, float eps,
               Dropout dr, cudaStream_t stream) {
  using C = Cfg;
  if (rows < 1 || F < C::FC || F % C::FC) return (int)cudaErrorInvalidValue;
  CUtensorMap xm, w1m, w2m, om;
  if (!map_2d(&xm, x, HIDDEN, rows, 64) || !map_2d(&w1m, w1, HIDDEN, F, 64) ||
      !map_2d(&w2m, w2, F, HIDDEN, C::W2_ROWS) || !map_2d(&om, out, HIDDEN, rows, 64))
    return (int)cudaErrorInvalidValue;
  // two blocks a row tile
  return launch_clusters(fused_ffn_kernel<DROP>, (rows + C::BM - 1) / C::BM * C::CLUSTER,
                         C::THREADS, C::CLUSTER, C::SMEM, stream, xm, w1m, w2m, om,
                         static_cast<const float*>(b1), static_cast<const float*>(b2),
                         static_cast<const float*>(gamma), static_cast<const float*>(beta), F,
                         eps, dr);
}

}  // namespace ffn
}  // namespace uc2

// x, out: [rows, 768] bf16 (16-byte aligned); w1 [F, 768] and w2 [768, F]
// bf16 as nn.Linear stores them ([out, in]), F a positive multiple of 64;
// b1 [F], b2, gamma, beta [768] fp32. Returns cudaGetLastError().
extern "C" int uc2_fused_ffn_block(const void* x, const void* w1, const void* b1,
                                   const void* w2, const void* b2, const void* gamma,
                                   const void* beta, void* out, int rows, int F,
                                   float eps, void* stream) {
  using namespace uc2;
  return ffn::run<false>(x, w1, b1, w2, b2, gamma, beta, out, rows, F, eps, Dropout{},
                         static_cast<cudaStream_t>(stream));
}

// #9: as above, with the output dropout of rate 1 - 1 / keep_scale drawn
// from seed (keep where the Philox word >= thresh); drop = 0 skips the
// mask (rate 0), and the launch is then #3's. Returns cudaGetLastError().
extern "C" int uc2_ffn_train_fwd(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* gamma,
                                 const void* beta, void* out, int rows, int F, float eps,
                                 unsigned seed, unsigned thresh, float keep_scale, int drop,
                                 void* stream) {
  using namespace uc2;
  const Dropout dr{seed, thresh, keep_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return drop ? ffn::run<true>(x, w1, b1, w2, b2, gamma, beta, out, rows, F, eps, dr, st)
              : ffn::run<false>(x, w1, b1, w2, b2, gamma, beta, out, rows, F, eps, dr, st);
}
