// Fused attention block for inference, kernel #2:
//   out = LayerNorm(x + attention(q, k, v, bias) . Wo^T + bo) * gamma + beta
//
// Replaces the TPU kernel uc2_tpu/ops/fused_block.py:_block_kernel
// (launched by fused_attn_block), which the encoder runs at joint length
// L >= 128 (the L = 128 and L = 162 retrieval buckets at uc2-base). The
// property kept from it: the [rows, 768] context, the pre-LayerNorm sum and
// its statistics never reach device memory. Numbers: attn_block.cuh.
//
// Design, for Hopper. A 64-row query tile of one batch row belongs to a
// cluster of two blocks on neighbouring SMs; block `half` (its cluster
// rank) computes the context of heads 6 half .. 6 half + 5 and owns output
// columns 384 half .. + 383. A block holds the tile's [64 x 768] bf16
// context as twelve swizzled [64 x 64] boxes (96 KB), one a head, and has
// two consumer warpgroups (240 registers a thread by setmaxnreg) and a
// producer warpgroup:
//   * producer warp w loads the Q tiles of consumer warpgroup w's three
//     heads by TMA straight into their context boxes, then streams K (and
//     in the second sweep V) tiles of those heads through the warpgroup's
//     ring of three 16 KB slots (tensor maps over the strided [B, L, n, 64]
//     heads, so views into the fused QKV projection are read in place);
//     warp 0 then loads the Wo slots of the out-projection through a ring
//     of four 24 KB slots laid over the drained K/V rings;
//   * each consumer warpgroup runs the streamed core's two sweeps (attend)
//     for its three heads; each head's bf16 context lands over its Q box
//     and goes to the partner block as one bulk copy into its shared
//     memory, completing on the partner's barrier of that box (publish_box);
//   * both warpgroups then compute ctx . Wo^T for the block's 384 columns by
//     wgmma m64n96k16 (A: the context boxes, own heads first, each waited
//     for; B: the Wo slots), 96 fp32 accumulators a thread;
//   * epilogue (residual_ln_store): + bo + x (x's rows read from L2, where
//     the producer prefetched them), the row statistics merged with the
//     partner through distributed shared memory, LayerNorm, the bf16 rows
//     written over the block's own six context boxes and stored by TMA,
//     which clips the rows >= L.
//
// What bounds it on an H100: bytes. At B = 64, L = 162 it reads q, k, v and
// x and writes the output, 81 MB (0.024 ms at 3.35 TB/s), against 17 GFLOP
// of products counted once (0.017 ms at 989 TFLOP/s). A block takes in
// 0.59 MB of Wo (its column half) and its heads' K and V from L2; the two
// sweeps compute Q . K^T twice (6 L^2 d products a row and head). Timed on
// the H100 (PERF.md): the attention is about half the time, the Wo stream,
// which can only start once the K/V rings are drained, most of the rest;
// two K/V slots a warpgroup instead of three were slower.
//
// The partial mode (uc2_fused_attn_block_partial, tensor parallelism over
// T processes): the same cluster over n = 12 / T of the heads and Wo's
// matching n * 64 input columns, writing the fp32 partial ctx . Wo^T for
// the caller to sum over the model group. Bound by bytes as well: at
// B = 64, L = 162, n = 6 it reads q, k, v (23.9 MB) and writes the fp32
// partial (31.9 MB), 0.017 ms at 3.35 TB/s, against 8.7 GFLOP (0.009 ms).
#include "attn_block.cuh"

namespace uc2 {
namespace blk {

struct Cfg2 {
  // two consumer warpgroups + a producer warpgroup (two of its warps
  // work): setmaxnreg moves registers within a block, so the consumers'
  // 240 come from the producer's whole warpgroup
  static constexpr int THREADS = 384;
  static constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;
  static constexpr int KV_STAGES = 3;   // K/V slots of each warpgroup's ring
  static constexpr int WO_STAGES = 4;   // Wo slots, over the drained K/V rings
  static constexpr int OFF_RING = 12 * BOX;                     // after the context
  static constexpr int RING_WG = KV_STAGES * 2 * BOX;           // K slots, then V slots
  static constexpr int OFF_BIAS = OFF_RING + 2 * RING_WG;       // [64 T] fp32
  static constexpr int OFF_RED = OFF_BIAS + MAX_LEN * 4;
  static constexpr int OFF_BAR = OFF_RED + RED_BYTES;
  // q[2], full[2][KV], empty[2][KV], ctx[12], wfull[WO], wempty[WO]
  static constexpr int N_BARS = 2 + 4 * KV_STAGES + 12 + 2 * WO_STAGES;
  static constexpr int SMEM = OFF_BAR + N_BARS * 8 + 1024;  // + the 1024-byte alignment
};
static_assert(Cfg2::WO_STAGES * WO_SLOT <= 2 * Cfg2::RING_WG, "Wo ring over the K/V rings");
static_assert(Cfg2::SMEM <= 232448, "shared memory of one block");

__global__ void __launch_bounds__(Cfg2::THREADS, 1)
    fused_attn_block_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap wom,
                            const __grid_constant__ CUtensorMap omap,
                            const float* __restrict__ bias, const bf16* __restrict__ x,
                            const float* __restrict__ bo, const float* __restrict__ gamma,
                            const float* __restrict__ beta, int L, int T, float scale_log2,
                            float eps) {
  using C = Cfg2;
  constexpr int KS = C::KV_STAGES, WS = C::WO_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* sbias = reinterpret_cast<float*>(smem + C::OFF_BIAS);
  float* red = reinterpret_cast<float*>(smem + C::OFF_RED);
  const uint32_t qbar = base + C::OFF_BAR, full = qbar + 16, empty = full + 16 * KS,
                 cbar = empty + 16 * KS, wfull = cbar + 8 * 12, wempty = wfull + 8 * WS;
  const int half = (int)cluster_rank(), partner = half ^ 1;
  const int tile = blockIdx.x >> 1, b = tile / T, q0 = 64 * (tile % T);
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // the partner's barriers exist before any remote arrive

  if (warp >= 8) {  // ---------------------------------------------- producers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS));
    const int w = warp - 8;  // the consumer warpgroup this warp feeds (0, 1)
    if (w == 1 && lane > 0) {  // x's rows of this half, for the epilogue
      for (int rr = lane - 1; rr < 64 && q0 + rr < L; rr += 31)
        prefetch_l2(x + ((size_t)b * L + q0 + rr) * HIDDEN + 384 * half, 768);
    }
    if (w < 2) {
      if (lane == 0)
        load_heads<KS>(&qmap, &kmap, &vmap, base, base + C::OFF_RING + w * C::RING_WG, qbar + 8 * w,
                       full + 8 * KS * w, empty + 8 * KS * w, 6 * half + 3 * w, 3, q0, b, T);
      __syncwarp();
      asm volatile("bar.sync 3, 64;\n" ::: "memory");  // both rings given back
      if (w == 0 && lane == 0)  // the Wo ring over them
        load_wo(&wom, base + C::OFF_RING, WS, WO_SLOT, wfull, wempty, half);
    }
    __syncwarp();
    cluster_sync();  // the consumers' two LayerNorm exchanges
    cluster_sync();
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
  const int w = warp >> 2;
  const uint32_t kring = base + C::OFF_RING + w * C::RING_WG;
  spin_wait(qbar + 8 * w, 0);
  for (int j = 0; j < 3; ++j) {
    const int h = 6 * half + 3 * w + j;
    const RingKV<KS> src{kring, kring + KS * BOX, full + 8 * KS * w, empty + 8 * KS * w,
                         2 * T * j};
    attend(base + h * BOX, smem + h * BOX, sbias, T, scale_log2, src);
    publish_box(base + h * BOX, cbar + 8 * h, partner, w);
  }
  float y[2][48];
  out_projection(y, base + C::OFF_RING, WS, WO_SLOT, wfull, wempty, w, [&](int i) {
    const int kb = kbox(i, half);
    spin_wait(cbar + 8 * kb, 0);
    return base + kb * BOX;
  });
  residual_ln_store(y, half, w, bo, x + ((size_t)b * L + q0) * HIDDEN, L - q0, gamma, beta, eps,
                    red, partner, smem + 6 * half * BOX, base + 6 * half * BOX, &omap, q0, b);
}


// #2's partial mode, for tensor parallelism: a launch over nh (1..12) of
// the layer's heads and the matching nh * 64 input columns of Wo writes
// the fp32 partial product ctx . Wo^T [B, L, 768], without bo, the
// residual or the LayerNorm (the caller sums the partials over the model
// group and applies them). The same cluster of two blocks a query tile:
// the heads are split over the four consumer warpgroups as HeadSplit
// says (at nh = 6: two, one, two and one), the contexts cross to the
// partner as above, and the out-projection runs over nh k-boxes. Each
// thread stores its 96 sums of each row as float2 pairs, rows >= L
// skipped; a last cluster barrier keeps both blocks resident until every
// box copy between them has landed.
__global__ void __launch_bounds__(Cfg2::THREADS, 1)
    fused_attn_partial_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __grid_constant__ CUtensorMap wom,
                              const float* __restrict__ bias, float* __restrict__ out, int L,
                              int T, int nh, float scale_log2) {
  using C = Cfg2;
  constexpr int KS = C::KV_STAGES, WS = C::WO_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* sbias = reinterpret_cast<float*>(smem + C::OFF_BIAS);
  const uint32_t qbar = base + C::OFF_BAR, full = qbar + 16, empty = full + 16 * KS,
                 cbar = empty + 16 * KS, wfull = cbar + 8 * 12, wempty = wfull + 8 * WS;
  const int half = (int)cluster_rank(), partner = half ^ 1;
  const int tile = blockIdx.x >> 1, b = tile / T, q0 = 64 * (tile % T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const HeadSplit split{nh};

  for (int i = threadIdx.x; i < 64 * T; i += C::THREADS)
    sbias[i] = i < L ? bias[(size_t)b * L + i] * LOG2E : -INFINITY;
  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w) mbar_init(qbar + 8 * w, 1);
    for (int s = 0; s < 2 * KS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);
    }
    for (int h = 0; h < 12; ++h) mbar_init(cbar + 8 * h, 1);
    for (int s = 0; s < WS; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();

  if (warp >= 8) {  // ---------------------------------------------- producers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS));
    const int w = warp - 8;
    if (w < 2) {
      if (lane == 0)
        load_heads<KS>(&qmap, &kmap, &vmap, base, base + C::OFF_RING + w * C::RING_WG, qbar + 8 * w,
                       full + 8 * KS * w, empty + 8 * KS * w, split.first(half, w),
                       split.count(half, w), q0, b, T);
      __syncwarp();
      asm volatile("bar.sync 3, 64;\n" ::: "memory");
      if (w == 0 && lane == 0)
        load_wo(&wom, base + C::OFF_RING, WS, WO_SLOT, wfull, wempty, half, nh);
    }
    __syncwarp();
    cluster_sync();  // the end
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
  const int w = warp >> 2;
  const uint32_t kring = base + C::OFF_RING + w * C::RING_WG;
  spin_wait(qbar + 8 * w, 0);
  const int h0 = split.first(half, w), mine = split.count(half, w);
  for (int j = 0; j < mine; ++j) {
    const int h = h0 + j;
    const RingKV<KS> src{kring, kring + KS * BOX, full + 8 * KS * w, empty + 8 * KS * w,
                         2 * T * j};
    attend(base + h * BOX, smem + h * BOX, sbias, T, scale_log2, src);
    publish_box(base + h * BOX, cbar + 8 * h, partner, w);
  }
  float y[2][48];
  out_projection(
      y, base + C::OFF_RING, WS, WO_SLOT, wfull, wempty, w,
      [&](int i) {
        const int kb = split.kbox(i, half);
        spin_wait(cbar + 8 * kb, 0);
        return base + kb * BOX;
      },
      nh);
  store_partial(y, half, w, out, b, L, q0);
  cluster_sync();
}

}  // namespace blk
}  // namespace uc2

// q, k, v: [B, L, n, 64] bf16, tokens rs elements apart (rs a multiple of
// 8, 16-byte-aligned bases; n * 64 == 768); bias [B, L] fp32; x, out
// [B, L, 768] bf16 contiguous, 16-byte aligned; wo [768, 768] bf16 as
// nn.Linear stores it ([out, in]); bo, gamma, beta [768] fp32;
// 1 <= L <= 512. Returns cudaGetLastError().
extern "C" int uc2_fused_attn_block(const void* q, const void* k, const void* v,
                                    const void* bias, const void* x, const void* wo,
                                    const void* bo, const void* gamma,
                                    const void* beta, void* out, int B, int L,
                                    int n, int rs, float scale, float eps,
                                    void* stream) {
  using namespace uc2;
  using namespace uc2::stream;
  if (B < 1 || L < 1 || L > MAX_LEN || n * HEAD_DIM != HIDDEN) return (int)cudaErrorInvalidValue;
  const int T = (L + 63) / 64;
  CUtensorMap qm, km, vm, wom, om;
  const size_t rb = (size_t)rs * 2;
  if (!heads_map(&qm, q, B, L, n, rb, 64) || !heads_map(&km, k, B, L, n, rb, 64) ||
      !heads_map(&vm, v, B, L, n, rb, 64) ||
      !map_2d(&wom, wo, HIDDEN, HIDDEN, blk::WO_ROWS) || !rows_map_3d(&om, out, B, L))
    return (int)cudaErrorInvalidValue;
  return launch_clusters(blk::fused_attn_block_kernel, 2 * T * B, blk::Cfg2::THREADS, 2,
                         blk::Cfg2::SMEM, static_cast<cudaStream_t>(stream), qm, km, vm, wom,
                         om, static_cast<const float*>(bias), static_cast<const bf16*>(x),
                         static_cast<const float*>(bo), static_cast<const float*>(gamma),
                         static_cast<const float*>(beta), L, T, scale * LOG2E, eps);
}

// #2's partial mode: q, k, v [B, L, n, 64] bf16 as above with 1 <= n <= 12
// heads (a shard of the layer's); bias [B, L] fp32; wo [768, n * 64] bf16
// (the shard's input columns of Wo, [out, in]); out [B, L, 768] fp32
// contiguous, 8-byte aligned: ctx . Wo^T, no bias, residual or LayerNorm.
// Returns cudaGetLastError().
extern "C" int uc2_fused_attn_block_partial(const void* q, const void* k, const void* v,
                                            const void* bias, const void* wo, void* out, int B,
                                            int L, int n, int rs, float scale, void* stream) {
  using namespace uc2;
  using namespace uc2::stream;
  if (B < 1 || L < 1 || L > MAX_LEN || n < 1 || n * HEAD_DIM > HIDDEN)
    return (int)cudaErrorInvalidValue;
  const int T = (L + 63) / 64;
  CUtensorMap qm, km, vm, wom;
  const size_t rb = (size_t)rs * 2;
  if (!heads_map(&qm, q, B, L, n, rb, 64) || !heads_map(&km, k, B, L, n, rb, 64) ||
      !heads_map(&vm, v, B, L, n, rb, 64) ||
      !map_2d(&wom, wo, n * HEAD_DIM, HIDDEN, blk::WO_ROWS))
    return (int)cudaErrorInvalidValue;
  return launch_clusters(blk::fused_attn_partial_kernel, 2 * T * B, blk::Cfg2::THREADS, 2,
                         blk::Cfg2::SMEM, static_cast<cudaStream_t>(stream), qm, km, vm, wom,
                         static_cast<const float*>(bias), static_cast<float*>(out), L, T, n,
                         scale * LOG2E);
}
