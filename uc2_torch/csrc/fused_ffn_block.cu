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
// Design, for Hopper (the walk, ffn_walk.cuh, is shared with the whole-layer
// kernel #8). A 64-row tile of x (wgmma's M) belongs to a cluster
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
//
// The partial mode (PARTIAL, uc2_fused_ffn_block_partial; tensor
// parallelism over T processes): the same walk over F / T intermediate
// columns (W1's rows and W2's columns of the shard), the fp32 sums written
// straight from the accumulators, no epilogue. Bound by operations: at
// 10368 rows and F / T = 1536 it is 48.9 GFLOP (0.049 ms) against 52.5 MB
// (0.016 ms), and the walk's weight stream halves with F.
//
// #9's partial mode (DROP and PARTIAL, uc2_ffn_train_fwd_partial): the
// training forward on a shard. Dropout is elementwise and linear and its
// mask is keyed on the global (row, column of H), which every shard sees
// whole, so each shard applies the mask to its own partial: it writes
// keep ? (y [+ b2]) / (1 - rate) : 0, b2 added by one shard only (b2 may
// be null), and the sum over the shards is the masked whole product up
// to the order of fp32 sums. At rate 0 without b2 the launch is #3's
// partial mode, bit for bit.
#include "ffn_walk.cuh"

namespace uc2 {
namespace ffn {

// PARTIAL (#3's partial mode, for tensor parallelism): W1 and W2 hold F
// of the layer's intermediate columns, and the kernel writes the fp32
// partial product y = bf16(gelu_erf(x . W1^T + b1)) . W2^T (+ b2 where b2
// is not null) to pout [rows, 768] after the walk (the caller sums the
// partials over the model group, then adds b2 and the residual and
// normalises); with DROP (#9's partial mode) masked and scaled as the
// whole epilogue masks y + b2. omap, gamma and beta are not read.
template <bool DROP, bool PARTIAL = false>
__global__ void __launch_bounds__(Cfg::THREADS, 1)
    fused_ffn_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap w1map,
                     const __grid_constant__ CUtensorMap w2map,
                     const __grid_constant__ CUtensorMap omap, const float* __restrict__ b1,
                     const float* __restrict__ b2, const float* __restrict__ gamma,
                     const float* __restrict__ beta, int F, float eps, Dropout dr,
                     float* __restrict__ pout, int rows) {
  using C = Cfg;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  if (base - raw + C::USED > C::SMEM) __trap();
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t xs = base;
  float* red = reinterpret_cast<float*>(smem + C::OFF_RED);
  const Bars br(base);
  // rank: this block's column half; peer: the other half of its tile
  const int rank = (int)cluster_rank(), peer = rank ^ 1;
  const int r0 = (int)(blockIdx.x / C::CLUSTER) * C::BM;
  const int n_chunks = F / C::FC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    br.init(1);  // x: the producer's arrival (+ the bytes)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // the peer's barriers exist before any remote arrive

  if (warp >= 4 * C::NWG) {  // ---------------------------- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS));
    const int w = warp - 4 * C::NWG;  // the consumer warpgroup whose ring this warp feeds
    if (w < C::NWG && lane == 0) {
      if (w == 0) {
        mbar_arrive_expect_tx(br.x, C::KB * C::BOX);
        for (int kb = 0; kb < C::KB; ++kb)
          tma_load_2d(xs + kb * C::BOX, &xmap, br.x, 64 * kb, r0);
      }
      feed(w, rank, base, br, &w1map, &w2map, n_chunks, 0, INT_MAX);
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
  // output columns W2_ROWS h + 8 jj + 2 t (+1) of the warpgroup's 192
  float y[C::NW2][C::ACC];
#pragma unroll
  for (int h = 0; h < C::NW2; ++h)
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) y[h][i] = 0.f;
  walk(y, smem, base, br, rank, wg, b1, n_chunks);
  if constexpr (PARTIAL) {
    const int col0 = C::OUT_BLOCK * rank + C::OUT_WG * wg;
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const int col = col0 + 8 * j + 2 * t;
      uint32_t keep[2] = {3u, 3u};  // rows r, r + 8: the keep bits of col, col + 1
      if constexpr (DROP) {  // drawn as the whole epilogue draws them
        const uint32_t mine = ffn_keep_bits4(dr.seed, dr.thresh, (uint32_t)col >> 2,
                                             (uint32_t)(r0 + r + 8 * (t & 1)));
        const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
        keep[0] = ((t & 1) ? other : mine) >> (col & 3);
        keep[1] = ((t & 1) ? mine : other) >> (col & 3);
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = r0 + r + 8 * hi;
        float v0 = y[j / (C::ACC / 4)][4 * (j % (C::ACC / 4)) + 2 * hi];
        float v1 = y[j / (C::ACC / 4)][4 * (j % (C::ACC / 4)) + 2 * hi + 1];
        if (b2 != nullptr) {
          const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
          v0 += bb.x;
          v1 += bb.y;
        }
        if constexpr (DROP) {
          v0 = (keep[hi] & 1u) ? v0 * dr.keep_scale : 0.f;
          v1 = (keep[hi] & 2u) ? v1 * dr.keep_scale : 0.f;
        }
        if (row < rows)
          *reinterpret_cast<float2*>(pout + (size_t)row * HIDDEN + col) = make_float2(v0, v1);
      }
    }
    // the producers' two barriers; the peer's last arrivals on this
    // block's h buffers land before either block leaves
    cluster_sync();
    cluster_sync();
    return;
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

// The kernel on `rows` rows of x (DROP: with the output dropout dr;
// PARTIAL: the fp32 partial product into out, [rows, 768])
template <bool DROP, bool PARTIAL = false>
inline int run(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               const void* gamma, const void* beta, void* out, int rows, int F, float eps,
               Dropout dr, cudaStream_t stream) {
  using C = Cfg;
  if (rows < 1 || F < C::FC || F % C::FC) return (int)cudaErrorInvalidValue;
  CUtensorMap xm, w1m, w2m, om;
  if (!map_2d(&xm, x, HIDDEN, rows, 64) || !map_2d(&w1m, w1, HIDDEN, F, 64) ||
      !map_2d(&w2m, w2, F, HIDDEN, C::W2_ROWS) ||
      !map_2d(&om, PARTIAL ? x : out, HIDDEN, rows, 64))
    return (int)cudaErrorInvalidValue;
  // two blocks a row tile
  return launch_clusters(fused_ffn_kernel<DROP, PARTIAL>,
                         (rows + C::BM - 1) / C::BM * C::CLUSTER, C::THREADS, C::CLUSTER,
                         C::SMEM, stream, xm, w1m, w2m, om, static_cast<const float*>(b1),
                         static_cast<const float*>(b2), static_cast<const float*>(gamma),
                         static_cast<const float*>(beta), F, eps, dr,
                         PARTIAL ? static_cast<float*>(out) : nullptr, rows);
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

// #3's partial mode: x [rows, 768] bf16; w1 [F, 768] and w2 [768, F] bf16,
// F (a shard of the intermediate) a positive multiple of 64; b1 [F] fp32;
// out [rows, 768] fp32 contiguous, 8-byte aligned: bf16(gelu_erf(x . W1^T
// + b1)) . W2^T, no b2, residual or LayerNorm. Returns cudaGetLastError().
extern "C" int uc2_fused_ffn_block_partial(const void* x, const void* w1, const void* b1,
                                           const void* w2, void* out, int rows, int F,
                                           void* stream) {
  using namespace uc2;
  return ffn::run<false, true>(x, w1, b1, w2, nullptr, nullptr, nullptr, out, rows, F, 0.f,
                               Dropout{}, static_cast<cudaStream_t>(stream));
}

// #9's partial mode: as #3's, with b2 [768] fp32 added where it is not
// null and the output dropout of uc2_ffn_train_fwd on the sum: out =
// keep ? (y [+ b2]) * keep_scale : 0. drop = 0 skips the mask (rate 0).
// Returns cudaGetLastError().
extern "C" int uc2_ffn_train_fwd_partial(const void* x, const void* w1, const void* b1,
                                         const void* w2, const void* b2, void* out, int rows,
                                         int F, unsigned seed, unsigned thresh,
                                         float keep_scale, int drop, void* stream) {
  using namespace uc2;
  const Dropout dr{seed, thresh, keep_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return drop ? ffn::run<true, true>(x, w1, b1, w2, b2, nullptr, nullptr, out, rows, F, 0.f, dr,
                                     st)
              : ffn::run<false, true>(x, w1, b1, w2, b2, nullptr, nullptr, out, rows, F, 0.f,
                                      dr, st);
}
