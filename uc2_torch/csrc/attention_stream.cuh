// The streamed attention-forward core for Hopper that kernels #1, #4, #5
// and #11 share:
//   out = Pd . V,  P = softmax(q.k^T / sqrt(d) + bias),
//   Pd = P (#1, #4, and #5 at rate 0) or keep ? P / (1 - rate) : 0 (#5),
// with fp32 scores, the softmax normalised in fp32, Pd rounded to bf16
// after normalisation (where the TPU kernels round it) and fp32 sums of
// Pd . V. It replaces the bodies of the TPU kernels
// uc2_tpu/ops/flash_attention.py:_attn_kernel (#4, launched by
// _fwd_pallas), _attn_kernel_v3 (#1) and _attn_train_fwd_kernel (#5,
// launched by _fwd_train); at rate 0 they are one function, and here one
// kernel. The BF16P mode is #11's function (scripts/kernel_lab.py
// :_kernel_bf16): e = bf16(exp(s - max s)) unnormalised, out =
// bf16((e . V) / sum fp32(e)); it rounds before it normalises.
//
// Design. One block per (query tile of QT = 64 NWG rows, head, batch row),
// NWG consumer warpgroups and one producer warp:
//   * the producer warp starts TMA copies: the Q tile once, then a K tile
//     for each step of the first sweep and a K and a V tile for each step
//     of the second, into a ring of STAGES slots guarded by full/empty
//     mbarriers. Its 32 lanes also stage the tile's bias (times log2 e;
//     -inf for keys >= L, whose K and V rows TMA fills with zeros); the
//     bias row is not 16-byte aligned for odd L, so no bulk copy there.
//     A warp, not a warpgroup that gives its registers back by setmaxnreg:
//     ptxas fitted the consumers into the launch bound's registers either
//     way (PERF.md), so a whole producer warpgroup only cost registers;
//   * each consumer warpgroup, 64 query rows, computes S = Q . K^T by wgmma
//     (m64nKTk16, A and B from 128-byte-swizzled shared memory), then
//       sweep 1: a running max and sum of exp2 per row and lane (the four
//                lanes of a row merged after the last tile), two steps a
//                round so that the second product runs under the first's
//                statistics;
//       sweep 2: Pd = exp2(s - max) * (1 / sum) [dropped and rescaled],
//                rounded to bf16 straight into wgmma A fragments, and
//                O += Pd . V by wgmma with A from registers
//                and the V tile read transposed (MN-major) from shared
//                memory; P . V of one step runs under the next step's
//                exp2 and Philox.
//     The context goes back through this warpgroup's Q slot to a TMA
//     store, which clips rows >= L.
//   * with BF16P (#11) sweep 1 keeps only each row's max; sweep 2 rounds
//     the unnormalised exp2 to bf16 straight into the A fragments and the
//     same lanes sum the rounded values in fp32 (the four lanes of a row
//     merged after the last tile); the fp32 context is scaled by 1 / sum
//     before the bf16 store.
// The tiles (NWG = 1, KT = 64, three blocks a SM) were chosen from H100
// timings of NWG = 1 or 2, KT = 32, 64 or 128 at every main-path shape
// (PERF.md): 64-row query tiles waste least at L = 162 (192 rows against
// 256) and won at every length.
// A one-sweep online softmax would round exponentials against a running
// max that later grows, neither #4's normalised P nor #11's e of the exact
// max, so the keys are swept twice and Q . K^T is computed twice: 6 L^2 d
// products a row and head against the 4 L^2 d of the function.
//
// Dropout (#5): the keep bit of score (b, h, i, j) is word j % 4 of
// philox4x32_10((j / 4, i, b n_tot + h0 + h, 0), (seed, 0)) (philox.cuh),
// so the backward (#6) redraws it. A launch over all n heads has h0 = 0,
// n_tot = n; a launch over the heads h0 .. h0 + n - 1 of n_tot (a
// tensor-parallel shard) draws the masks of those heads of the whole. A thread holds columns 8c + 2t and 8c + 2t + 1
// of rows g and g + 8 (wgmma's accumulator layout, g = lane / 4,
// t = lane % 4): lanes t and t ^ 1 share one 4-key group. Lane t draws the
// group for row g + 8 (t & 1) and swaps the bits with its partner
// (__shfl_xor_sync 1), so every Philox call is made once.
//
// What bounds it on an H100: at B = 16, L = 512 it reads q, k, v and
// writes the context, 50 MB (15 us at 3.35 TB/s), against 12.9 GFLOP of
// products counted once (13 us at 989 TFLOP/s). The exp2 of two sweeps
// (100 M at that shape, on the 16-a-clock special-function unit) and, at
// rate 0.1, 12.6 M Philox calls of ten rounds on the integer pipes take
// longer than either; three blocks a SM overlap one warpgroup's exp2 and
// Philox with another's products.
//
// Inputs: q, k, v [B, L, n, 64] bf16 with one token stride rs (elements,
// a multiple of 8; 16-byte aligned bases), so views into the fused QKV
// projection are read in place; bias [B, L] fp32; out [B, L, n, 64] bf16
// contiguous. The tensor maps are encoded on the host by libcuda's
// cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPointByVersion,
// so the library needs no -lcuda.
#pragma once

#include <cuda.h>

#include "common.cuh"
#include "philox.cuh"

namespace uc2 {

struct Dropout {
  uint32_t seed;    // Philox key word 0
  uint32_t thresh;  // keep when bits >= thresh
  float keep_scale; // 1 / (1 - rate)
  uint32_t h0;      // the launch's first head among n_tot (the masks' head index)
  uint32_t n_tot;
};

namespace stream {

constexpr float LOG2E = 1.4426950408889634f;

// The tiles: NWG consumer warpgroups of 64 query rows, KT-key tiles,
// MIN_BLOCKS blocks a SM (what __launch_bounds__ asks ptxas to fit)
struct Cfg {
  static constexpr int NWG = 1, KT = 64, MIN_BLOCKS = 3;
  static constexpr int QT = 64 * NWG;                // query rows a block
  static constexpr int THREADS = 128 * NWG + 32;     // + the producer warp
  static constexpr int STAGES = 4;                   // slots of the K/V ring
  static constexpr int ROW_BYTES = HEAD_DIM * 2;     // 128: one swizzle row
  static constexpr int TILE_BYTES = KT * ROW_BYTES;  // one K or V tile
  static constexpr int Q_BYTES = QT * ROW_BYTES;
  // shared memory, from a 1024-byte-aligned base (the swizzle's period)
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * TILE_BYTES;
  static constexpr int OFF_BIAS = OFF_V + STAGES * TILE_BYTES;
  static constexpr int OFF_BAR = OFF_BIAS + STAGES * KT * 4;
  static constexpr int SMEM = OFF_BAR + (2 * STAGES + 1) * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// expect that many more bytes of copies in the barrier's current phase,
// without arriving
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of the given parity has completed. A barrier that
// never completes (a fault in the expected byte counts) traps after about
// ten seconds instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  if (done) return;
  const long long start = clock64();
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// TMA: box (64, 1, rows, 1) of a 4-D (d, head, token, batch) tensor map at
// (0, h, row, b) into shared memory, completing bytes on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(h), "r"(row), "r"(b)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int h, int row,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(0), "r"(h), "r"(row), "r"(b)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a tile of 128-byte rows in the
// 128-byte swizzle: 8-row groups 1024 bytes apart (the stride byte
// offset); the leading byte offset is unused for this tile width
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A . B^T, m64n64k16, A and B both K-major in shared memory: the
// first k slice, so d is only written
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "n"(0));
}

// d += A . B^T, m64n64k16: A and B both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(1));
}

// d += A . B, m64n64k16: A as bf16 fragments in registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// BF16P (kernel #11): e = bf16(exp2(s - max)) unnormalised, sum(fp32(e))
// taken from the rounded values, the context scaled by 1 / sum at the end
template <bool DROP, bool BF16P = false>
__global__ void __launch_bounds__(Cfg::THREADS, Cfg::MIN_BLOCKS)
    attn_stream_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap omap,
                       const float* __restrict__ bias, int L, int n, float scale_log2,
                       Dropout dr) {
  using C = Cfg;
  constexpr int NWG = C::NWG, KT = C::KT, STAGES = C::STAGES;
  constexpr int NC = KT / 8;  // 8-key column groups a tile
  static_assert(KT == 64, "the score products below are m64n64k16");
  static_assert(!(DROP && BF16P), "#11 has no dropout");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* sbias = reinterpret_cast<float*>(smem + C::OFF_BIAS);
  const uint32_t full = base + C::OFF_BAR, empty = full + 8 * STAGES,
                 qbar = empty + 8 * STAGES;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * C::QT;
  const int n_tiles = (L + KT - 1) / KT, steps = 2 * n_tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 32);        // the producer warp's lanes (+ the bytes)
      mbar_init(empty + 8 * s, 4 * NWG);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // -------------------------------------- producer
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, C::Q_BYTES);
      tma_load(base, &qmap, qbar, h, q0, b);
    }
    const float* brow = bias + (size_t)b * L;
    for (int s = 0; s < steps; ++s) {
      const int st = s % STAGES;
      mbar_wait(empty + 8 * st, ((s / STAGES) & 1) ^ 1);
      const int k0 = (s % n_tiles) * KT;
#pragma unroll
      for (int i = lane; i < KT; i += 32)
        sbias[st * KT + i] = k0 + i < L ? brow[k0 + i] * LOG2E : -INFINITY;
      if (lane == 0) {
        const bool with_v = s >= n_tiles;
        mbar_arrive_expect_tx(full + 8 * st, (with_v ? 2 : 1) * C::TILE_BYTES);
        tma_load(base + C::OFF_K + st * C::TILE_BYTES, &kmap, full + 8 * st, h, k0, b);
        if (with_v)
          tma_load(base + C::OFF_V + st * C::TILE_BYTES, &vmap, full + 8 * st, h, k0, b);
      } else {
        mbar_arrive(full + 8 * st);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const uint32_t qslot = base + wg * 64 * C::ROW_BYTES;
  const uint32_t ph = (uint32_t)(b * dr.n_tot + dr.h0 + h);  // the mask's head index
  // the query row whose keep bits this lane draws (row g + 8 (t & 1) of its warp)
  const uint32_t my_row = (uint32_t)(q0 + wg * 64 + wl * 16 + g + 8 * (t & 1));
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
  float o[32];  // the context, zeroed when the second sweep starts

  // S = Q . K^T of step s into acc, committed as one group and not waited
  // for: four k16 slices of the head dim, 32 bytes apart in the swizzled rows
  auto start_scores = [&](float(&acc)[KT / 2], int s) {
    const int st = s % STAGES;
    mbar_wait(full + 8 * st, (s / STAGES) & 1);
    const uint32_t kslot = base + C::OFF_K + st * C::TILE_BYTES;
    wgmma_fence();
    wgmma_ss_n64_first(acc, sw128_desc(qslot), sw128_desc(kslot));
#pragma unroll
    for (int kk = 1; kk < HEAD_DIM / 16; ++kk)
      wgmma_ss_n64(acc, sw128_desc(qslot + 32 * kk), sw128_desc(kslot + 32 * kk));
    wgmma_commit();
  };
  // O += Pd . V of step s, committed and not waited for
  auto start_pv = [&](const uint32_t(&pa)[KT / 16][4], int s) {
    const uint32_t vslot = base + C::OFF_V + (s % STAGES) * C::TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      wgmma_rs_n64(o, pa[kk], sw128_desc(vslot + kk * 16 * C::ROW_BYTES));
    wgmma_commit();
  };
  auto release = [&](int s) {  // this warp is done with step s's slot
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (s % STAGES));
  };
  // s * scale * log2 e + bias * log2 e: the scores of step s in base 2
  auto add_bias = [&](float(&acc)[KT / 2], int s) {
    fence_regs(acc);
    const float* sb = sbias + (s % STAGES) * KT;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float2 bb = *reinterpret_cast<const float2*>(sb + 8 * c + 2 * t);
      acc[4 * c + 0] = fmaf(acc[4 * c + 0], scale_log2, bb.x);
      acc[4 * c + 1] = fmaf(acc[4 * c + 1], scale_log2, bb.y);
      acc[4 * c + 2] = fmaf(acc[4 * c + 2], scale_log2, bb.x);
      acc[4 * c + 3] = fmaf(acc[4 * c + 3], scale_log2, bb.y);
    }
  };
  // sweep 1: the running max and sum of exp2 of this lane's columns (with
  // BF16P the max alone: the sum is taken in sweep 2 from the rounded e)
  auto fold = [&](const float(&acc)[KT / 2]) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float tm = -INFINITY;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tm = fmaxf(tm, fmaxf(acc[4 * c + 2 * hi], acc[4 * c + 2 * hi + 1]));
      const float mn = fmaxf(mx[hi], tm);
      if constexpr (BF16P) {
        mx[hi] = mn;
      } else if (mn != -INFINITY) {
        float add = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          add += ex2(acc[4 * c + 2 * hi] - mn) + ex2(acc[4 * c + 2 * hi + 1] - mn);
        sum[hi] = sum[hi] * ex2(mx[hi] - mn) + add;
        mx[hi] = mn;
      }
    }
  };

  mbar_wait(qbar, 0);
  // sweep 1, two steps a round: the second product runs under the first's
  // statistics, and nothing is in flight between rounds
  for (int s = 0; s < n_tiles; s += 2) {
    float sa[KT / 2], sb2[KT / 2];
    const bool two = s + 1 < n_tiles;
    start_scores(sa, s);
    if (two) {
      start_scores(sb2, s + 1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    add_bias(sa, s);
    release(s);
    fold(sa);
    if (two) {
      wgmma_wait<0>();
      add_bias(sb2, s + 1);
      release(s + 1);
      fold(sb2);
    }
  }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {  // merge the four lanes of each row; 1 / sum
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, mx[hi], off);
      if constexpr (BF16P) {
        mx[hi] = fmaxf(mx[hi], m2);
      } else {
        const float l2 = __shfl_xor_sync(0xffffffffu, sum[hi], off);
        const float mn = fmaxf(mx[hi], m2);
        sum[hi] = (mx[hi] == -INFINITY ? 0.f : sum[hi] * ex2(mx[hi] - mn)) +
                  (m2 == -INFINITY ? 0.f : l2 * ex2(m2 - mn));
        mx[hi] = mn;
      }
    }
    if constexpr (!BF16P) inv[hi] = 1.f / sum[hi];
  }
  const float ks0 = BF16P ? 1.f : DROP ? inv[0] * dr.keep_scale : inv[0];
  const float ks1 = BF16P ? 1.f : DROP ? inv[1] * dr.keep_scale : inv[1];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  fence_regs(o);  // zeroed here, before any product is in flight

  // sweep 2: Pd of step s computed while P . V of step s - 1 runs
  uint32_t pa[KT / 16][4];  // Pd of the step whose P . V starts next
  for (int s = n_tiles; s < steps; ++s) {
    float sc[KT / 2];
    start_scores(sc, s);
    if (s > n_tiles) {
      start_pv(pa, s - 1);
      wgmma_wait<1>();  // the scores; P . V still in flight
    } else {
      wgmma_wait<0>();
    }
    add_bias(sc, s);
    const int k0 = (s - n_tiles) * KT;
#pragma unroll
    for (int c = 0; c < NC; ++c) {  // Pd in place of the scores
      float p0 = ex2(sc[4 * c + 0] - mx[0]) * ks0, p1 = ex2(sc[4 * c + 1] - mx[0]) * ks0;
      float p2 = ex2(sc[4 * c + 2] - mx[1]) * ks1, p3 = ex2(sc[4 * c + 3] - mx[1]) * ks1;
      if constexpr (DROP) {
        const uint32_t mine =
            keep_bits4(dr.seed, dr.thresh, (uint32_t)(k0 >> 2) + 2 * c + (t >> 1), my_row, ph);
        const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
        const int sh = 2 * (t & 1);
        const uint32_t kg = ((t & 1) ? other : mine) >> sh;  // row g
        const uint32_t kh = ((t & 1) ? mine : other) >> sh;  // row g + 8
        p0 = kg & 1 ? p0 : 0.f;
        p1 = kg & 2 ? p1 : 0.f;
        p2 = kh & 1 ? p2 : 0.f;
        p3 = kh & 2 ? p3 : 0.f;
      }
      sc[4 * c + 0] = p0;
      sc[4 * c + 1] = p1;
      sc[4 * c + 2] = p2;
      sc[4 * c + 3] = p3;
    }
    if (s > n_tiles) {
      wgmma_wait<0>();
      fence_regs(o);
      release(s - 1);  // its V has been read
    }
    // rounded to bf16 into A fragments: keys 16 kk .. + 15 are column
    // groups 2 kk and 2 kk + 1
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      pa[c >> 1][2 * (c & 1) + 0] = pack2(sc[4 * c + 0], sc[4 * c + 1]);
      pa[c >> 1][2 * (c & 1) + 1] = pack2(sc[4 * c + 2], sc[4 * c + 3]);
      if constexpr (BF16P) {  // the row sums of the rounded e
        const float2 eg = bf16x2_to_float2(pa[c >> 1][2 * (c & 1) + 0]);
        const float2 eh = bf16x2_to_float2(pa[c >> 1][2 * (c & 1) + 1]);
        sum[0] += eg.x + eg.y;
        sum[1] += eh.x + eh.y;
      }
    }
  }
  start_pv(pa, steps - 1);
  if constexpr (BF16P) {  // merge the four lanes of each row, as sweep 1 does
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      sum[hi] += __shfl_xor_sync(0xffffffffu, sum[hi], 1);
      sum[hi] += __shfl_xor_sync(0xffffffffu, sum[hi], 2);
      inv[hi] = 1.f / sum[hi];
    }
  }
  wgmma_wait<0>();
  fence_regs(o);
  if constexpr (BF16P) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      o[4 * c + 0] *= inv[0];
      o[4 * c + 1] *= inv[0];
      o[4 * c + 2] *= inv[1];
      o[4 * c + 3] *= inv[1];
    }
  }

  // the context through this warpgroup's Q slot (swizzled as TMA reads it)
  uint8_t* so = smem + wg * 64 * C::ROW_BYTES;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int r = wl * 16 + g;
    *reinterpret_cast<uint32_t*>(so + r * 128 + ((c ^ g) << 4) + 4 * t) =
        pack2(o[4 * c], o[4 * c + 1]);
    *reinterpret_cast<uint32_t*>(so + (r + 8) * 128 + ((c ^ g) << 4) + 4 * t) =
        pack2(o[4 * c + 2], o[4 * c + 3]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (wl == 0 && lane == 0) tma_store(&omap, qslot, h, q0 + wg * 64, b);
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, fetched once through the runtime (a
// function-local static: initialised once, thread-safe)
static_assert(CUDART_VERSION >= 12050, "the streamed core needs CUDA 12.5 or later");
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// [B, L, n, 64] bf16 heads, tokens row_bytes apart, as a 4-D map (d, head,
// token, batch) read or written in boxes of (64, 1, rows, 1)
inline bool heads_map(CUtensorMap* map, const void* ptr, int B, int L, int n,
                      size_t row_bytes, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HEAD_DIM, (cuuint64_t)n, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HEAD_DIM * 2, (cuuint64_t)row_bytes,
                                 (cuuint64_t)row_bytes * L};
  const cuuint32_t box[4] = {(cuuint32_t)HEAD_DIM, 1u, (cuuint32_t)rows, 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The core at joint length L (1..512) on stream
template <bool DROP, bool BF16P = false>
inline int attention(const void* q, const void* k, const void* v, const void* bias, void* out,
                     int B, int L, int n, int rs, float scale, Dropout dr, cudaStream_t stream) {
  using C = Cfg;
  if (L < 1 || L > MAX_LEN) return (int)cudaErrorInvalidValue;
  auto kernel = attn_stream_kernel<DROP, BF16P>;
  // on every call: the attribute belongs to the current device
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap qm, km, vm, om;
  const size_t rb = (size_t)rs * 2;
  if (!heads_map(&qm, q, B, L, n, rb, C::QT) || !heads_map(&km, k, B, L, n, rb, C::KT) ||
      !heads_map(&vm, v, B, L, n, rb, C::KT) ||
      !heads_map(&om, out, B, L, n, (size_t)n * HEAD_DIM * 2, 64))
    return (int)cudaErrorInvalidValue;
  dim3 grid((L + C::QT - 1) / C::QT, n, B);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(qm, km, vm, om, static_cast<const float*>(bias),
                                               L, n, scale * LOG2E, dr);
  return (int)cudaGetLastError();
}

}  // namespace stream

}  // namespace uc2
