// One whole post-LN encoder layer for inference, kernel #8:
//   x2  = LayerNorm1(x + attention(q, k, v, bias) . Wo^T + bo)       (fp32)
//   out = LayerNorm2(bf16(gelu_erf(bf16(x2) . W1^T + b1)) . W2^T + b2 + x2)
//
// Replaces the TPU kernel uc2_tpu/ops/fused_block.py:_layer_kernel
// (launched by fused_layer_block), which the reference runs only from its
// kernel lab (scripts/kernel_lab.py --mode layer): its gate,
// fused_layer_profitable, is always off. Rounding is the TPU kernel's: P
// rounded to bf16 after normalising, the context to Wo's dtype, the FFN's
// input bf16(x2), the GELU output to bf16, and the FFN's residual is x2 in
// fp32 (not the bf16 output of the attention block, as in #2 -> #3).
//
// What bounds it on an H100: operations. At (B, L) = (64, 162) the layer is
// 4 B 12 L^2 64 + 2 B L 768^2 + 4 B L 768 3072 = 115.2 GFLOP (0.117 ms at
// 989 TFLOP/s) against 90 MB of heads, x, weights and output (0.027 ms).
//
// Design: #2's attention half (fused_attn_block.cu, attn_block.cuh) and
// #3's FFN walk (fused_ffn_block.cu, ffn_walk.cuh) in one cluster of two
// blocks per (64 query rows, batch row). Block `half` (its cluster rank)
// owns output columns 384 half .. + 383 in both halves, and a consumer
// thread the same columns in both: warpgroup w, part p holds columns
// 384 half + 192 w + 96 p + 8 c + 2 t in #2's out-projection and in #3's
// GEMM 2, so x2 never leaves the registers.
//   1. #2's body: the producer loads the Q boxes of the block's six heads
//      and streams their K/V tiles (load_heads); each consumer warpgroup
//      runs attend for three heads and publishes each context box to both
//      blocks; the out-projection over the Wo ring into y[2][48];
//   2. the first LayerNorm (residual_ln_store, keeping its fp32 output in
//      y): + bo + x, the statistics across the cluster, bf16(x2) written
//      over the block's own six context boxes and copied in bulk into the
//      partner's boxes of the same index (after the cluster barriers that
//      show the partner's out-projection has read them). Each block then
//      holds the whole [64 x 768] bf16(x2) tile as twelve swizzled boxes,
//      #3's x tile, completing on the walk's x barrier;
//   3. y seeded with x2 + b2, then #3's walk: the W1/W2 rings and h buffers
//      over the drained K/V and Wo rings. The producer starts the rings'
//      first slots once the Wo ring is given back, under the first
//      LayerNorm, and the rest after its cluster barriers;
//   4. the second LayerNorm (residual_ln_store without the residual, which
//      the seed holds) and a bf16 TMA store that clips the rows past L.
// Shared memory is #3's layout (232448 bytes a block, one block a SM):
// twelve boxes, the h buffers and W rings, the reductions and barriers.
// #2's bias row, barriers, K/V rings and Wo ring lie under the h buffers
// and W rings, which nothing writes before they are drained: the h buffers
// are first written after the first LayerNorm's cluster barriers, and the
// W rings after the Wo ring is given back. #2's barriers are invalidated
// before the h buffers are written over them.
// The FFN half runs on the padded 64-row tiles of each batch row, as the
// reference's layout (B L rows) does: at L = 162, 192 rows for 162.
#include "attn_block.cuh"
#include "ffn_walk.cuh"

namespace uc2 {
namespace layer {

using namespace stream;
using blk::BOX;
using FW = ffn::Cfg;

struct Cfg {
  static constexpr int THREADS = FW::THREADS;  // two consumer warpgroups + a producer warpgroup
  static constexpr int KV_STAGES = 3;          // #2's K/V slots of each warpgroup's ring
  static constexpr int WO_STAGES = 4;          // #2's Wo slots, over the drained K/V rings
  // the attention half, under the FFN's h buffers and W rings [FW::OFF_H, FW::OFF_RED)
  static constexpr int OFF_BIAS = FW::OFF_H;                // [64 T] fp32
  static constexpr int OFF_ABAR = OFF_BIAS + MAX_LEN * 4;   // q[2], full[2][KV], empty[2][KV],
  static constexpr int N_ABARS = 2 + 4 * KV_STAGES + 12 + 2 * WO_STAGES;  // ctx[12], wfull, wempty
  static constexpr int OFF_RING = FW::OFF_H + 3 * 1024;     // K/V rings, then the Wo ring
  static constexpr int RING_WG = KV_STAGES * 2 * BOX;       // K slots, then V slots
};
static_assert(Cfg::OFF_ABAR + 8 * Cfg::N_ABARS <= Cfg::OFF_RING, "#2's barriers below its rings");
static_assert(Cfg::OFF_RING + 2 * Cfg::RING_WG <= FW::OFF_RED, "#2's rings in the FFN's region");
static_assert(Cfg::WO_STAGES * blk::WO_SLOT <= 2 * Cfg::RING_WG, "Wo ring over the K/V rings");
static_assert(FW::BOX == BOX && blk::RED_BYTES == 2 * 2 * FW::NWG * FW::BM * 4,
              "the two halves share the boxes and the reduction scratch");
static_assert(FW::NW2 == 2 && FW::ACC == 48, "GEMM 2 holds #2's y[2][48]");

__device__ __forceinline__ void mbar_inval(uint32_t bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__global__ void __launch_bounds__(Cfg::THREADS, 1)
    fused_layer_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap wom,
                       const __grid_constant__ CUtensorMap w1map,
                       const __grid_constant__ CUtensorMap w2map,
                       const __grid_constant__ CUtensorMap omap, const float* __restrict__ bias,
                       const bf16* __restrict__ x, const float* __restrict__ bo,
                       const float* __restrict__ g1, const float* __restrict__ be1,
                       const float* __restrict__ b1, const float* __restrict__ b2,
                       const float* __restrict__ g2, const float* __restrict__ be2, int L, int T,
                       int F, float scale_log2, float eps) {
  using C = Cfg;
  constexpr int KS = C::KV_STAGES, WS = C::WO_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  if (base - raw + FW::USED > FW::SMEM) __trap();
  uint8_t* smem = smem_raw + (base - raw);
  float* sbias = reinterpret_cast<float*>(smem + C::OFF_BIAS);
  float* red = reinterpret_cast<float*>(smem + FW::OFF_RED);
  const ffn::Bars br(base);
  const uint32_t qbar = base + C::OFF_ABAR, full = qbar + 16, empty = full + 16 * KS,
                 cbar = empty + 16 * KS, wfull = cbar + 8 * 12, wempty = wfull + 8 * WS;
  const int half = (int)cluster_rank(), partner = half ^ 1;
  const int tile = blockIdx.x >> 1, b = tile / T, q0 = 64 * (tile % T);
  const int n_chunks = F / FW::FC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < 64 * T; i += C::THREADS)
    sbias[i] = i < L ? bias[(size_t)b * L + i] * LOG2E : -INFINITY;
  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w) mbar_init(qbar + 8 * w, 1);
    for (int s = 0; s < 2 * KS; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer warp's lane 0 (+ the bytes)
      mbar_init(empty + 8 * s, 4);  // the consumer warpgroup's warps
    }
    for (int h = 0; h < 12; ++h) mbar_init(cbar + 8 * h, 1);  // the box's writer
    for (int s = 0; s < WS; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, 8);  // both warpgroups' warps
    }
    br.init(4);  // x2: both warpgroups of this block and (with the bytes) of the partner
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // the partner's barriers exist before any remote arrive

  if (warp >= 8) {  // ---------------------------------------------- producers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(FW::PRODUCER_REGS));
    const int w = warp - 8;  // the consumer warpgroup this warp feeds (0, 1)
    if (w == 1 && lane > 0) {  // x's rows of this half, for the first LayerNorm
      for (int rr = lane - 1; rr < 64 && q0 + rr < L; rr += 31)
        prefetch_l2(x + ((size_t)b * L + q0 + rr) * HIDDEN + 384 * half, 768);
    }
    if (w < 2) {
      if (lane == 0)
        blk::load_heads<KS>(&qmap, &kmap, &vmap, base, base + C::OFF_RING + w * C::RING_WG,
                            qbar + 8 * w, full + 8 * KS * w, empty + 8 * KS * w,
                            6 * half + 3 * w, 3, q0, b, T);
      __syncwarp();
      asm volatile("bar.sync 3, 64;\n" ::: "memory");  // both K/V rings given back
      if (w == 0 && lane == 0)  // the Wo ring over them
        blk::load_wo(&wom, base + C::OFF_RING, WS, blk::WO_SLOT, wfull, wempty, half);
      __syncwarp();
      asm volatile("bar.sync 3, 64;\n" ::: "memory");  // the Wo ring given back
      if (lane == 0)  // the W ring's first slots, under the first LayerNorm
        ffn::feed(w, half, base, br, &w1map, &w2map, n_chunks, 0, FW::STAGES);
    }
    __syncwarp();
    cluster_sync();  // the first LayerNorm's two exchanges
    cluster_sync();
    if (w < 2 && lane == 0)
      ffn::feed(w, half, base, br, &w1map, &w2map, n_chunks, FW::STAGES, INT_MAX);
    __syncwarp();
    cluster_sync();  // the second's
    cluster_sync();
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(FW::CONSUMER_REGS));
  const int w = warp >> 2, t = lane & 3;
  const uint32_t kring = base + C::OFF_RING + w * C::RING_WG;
  spin_wait(qbar + 8 * w, 0);
  for (int j = 0; j < 3; ++j) {
    const int h = 6 * half + 3 * w + j;
    const blk::RingKV<KS> src{kring, kring + KS * BOX, full + 8 * KS * w, empty + 8 * KS * w,
                              2 * T * j};
    blk::attend(base + h * BOX, smem + h * BOX, sbias, T, scale_log2, src);
    blk::publish_box(base + h * BOX, cbar + 8 * h, partner, w);
  }
  float y[2][48];
  blk::out_projection(y, base + C::OFF_RING, WS, blk::WO_SLOT, wfull, wempty, w, [&](int i) {
    const int kb = blk::kbox(i, half);
    spin_wait(cbar + 8 * kb, 0);
    return base + kb * BOX;
  });
  // y = x2 in fp32, bf16(x2) over the block's own six boxes
  blk::residual_ln_store<true, true>(y, half, w, bo, x + ((size_t)b * L + q0) * HIDDEN, L - q0,
                                     g1, be1, eps, red, partner, smem + 6 * half * BOX,
                                     base + 6 * half * BOX, nullptr, q0, b);
  if (threadIdx.x == 0)  // no one waits on the attention half's barriers any more
    for (int i = 0; i < C::N_ABARS; ++i) mbar_inval(qbar + 8 * i);
  if ((threadIdx.x & 127) == 0) {  // the warpgroup's three boxes, to this block and the partner
    const uint32_t boxes = base + (6 * half + 3 * w) * BOX;
    mbar_arrive(br.x);
    const uint32_t px = peer_addr(br.x, partner);
    mbar_arrive_expect_tx_cluster(px, 3 * BOX);
    bulk_copy_to_peer(peer_addr(boxes, partner), boxes, 3 * BOX, px);
  }
  // GEMM 2's accumulators seeded with x2 + b2: the residual stays in fp32
#pragma unroll
  for (int j = 0; j < 24; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(b2 + 384 * half + 192 * w + 8 * j + 2 * t);
    float* yj = &y[j / 12][4 * (j % 12)];
    yj[0] += bb.x;
    yj[1] += bb.y;
    yj[2] += bb.x;
    yj[3] += bb.y;
  }
  ffn::walk(y, smem, base, br, half, w, b1, n_chunks);
  blk::residual_ln_store<false>(y, half, w, nullptr, nullptr, 0, g2, be2, eps, red, partner,
                                smem + 6 * half * BOX, base + 6 * half * BOX, &omap, q0, b);
}

}  // namespace layer
}  // namespace uc2

// q, k, v: [B, L, n, 64] bf16, tokens rs elements apart (rs a multiple of
// 8, 16-byte-aligned bases; n * 64 == 768); bias [B, L] fp32; x, out
// [B, L, 768] bf16 contiguous, 16-byte aligned; wo [768, 768], w1 [F, 768],
// w2 [768, F] bf16 as nn.Linear stores them ([out, in]), 16-byte aligned,
// F a positive multiple of 64; bo, g1, be1, b2, g2, be2 [768] and b1 [F]
// fp32; 1 <= L <= 512. Returns cudaGetLastError().
extern "C" int uc2_fused_layer_block(const void* q, const void* k, const void* v,
                                     const void* bias, const void* x, const void* wo,
                                     const void* bo, const void* g1, const void* be1,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, const void* g2, const void* be2,
                                     void* out, int B, int L, int n, int rs, int F,
                                     float scale, float eps, void* stream) {
  using namespace uc2;
  using namespace uc2::stream;
  using FW = ffn::Cfg;
  if (B < 1 || L < 1 || L > MAX_LEN || n * HEAD_DIM != HIDDEN || F < FW::FC || F % FW::FC)
    return (int)cudaErrorInvalidValue;
  const int T = (L + 63) / 64;
  CUtensorMap qm, km, vm, wom, w1m, w2m, om;
  const size_t rb = (size_t)rs * 2;
  if (!heads_map(&qm, q, B, L, n, rb, 64) || !heads_map(&km, k, B, L, n, rb, 64) ||
      !heads_map(&vm, v, B, L, n, rb, 64) ||
      !map_2d(&wom, wo, HIDDEN, HIDDEN, blk::WO_ROWS) || !map_2d(&w1m, w1, HIDDEN, F, 64) ||
      !map_2d(&w2m, w2, F, HIDDEN, FW::W2_ROWS) || !rows_map_3d(&om, out, B, L))
    return (int)cudaErrorInvalidValue;
  return launch_clusters(
      layer::fused_layer_kernel, 2 * T * B, layer::Cfg::THREADS, 2, FW::SMEM,
      static_cast<cudaStream_t>(stream), qm, km, vm, wom, w1m, w2m, om,
      static_cast<const float*>(bias), static_cast<const bf16*>(x),
      static_cast<const float*>(bo), static_cast<const float*>(g1),
      static_cast<const float*>(be1), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<const float*>(g2),
      static_cast<const float*>(be2), L, T, F, scale * LOG2E, eps);
}
