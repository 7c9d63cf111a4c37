// A bf16 matrix product for Hopper with a fused epilogue: the core of the
// training FFN backward (#10, ffn_train_bwd.cu), written so that the
// training FFN forward (#9) can be built on it next.
//
//   C[M, N] = A[M, K] . B[N, K]^T   (fp32 sums of bf16 operands)
//
// Each operand lies in device memory either K-major (a row-major [M, K] or
// [N, K] matrix: x, h, dy2 and da as rows, W1 and W2 as nn.Linear weights)
// or MN-major (a row-major [K, M] or [K, N] matrix: the weights read
// transposed in dh = dy2 . W2 and dx = da . W1, and every operand of the
// weight gradients dW1 = da^T x and dW2 = dy2^T h, whose K is the rows).
// wgmma reads bf16 operands of either order from shared memory (its
// transpose bits), so no operand is ever transposed in device memory.
//
// Design. One block per [BM x BN] = [128 x 128] output tile (and per split
// of K, where the grid has a z dimension), two blocks a SM, so that one
// block's epilogue runs under the other's products (two blocks with three
// slots each beat one block with four and two blocks with two: PERF.md
// §6): one producer warp starts the TMA
// copies of each 64-deep K step of A and B into a ring of STAGES slots
// guarded by full/empty mbarriers; two consumer warpgroups, 64 rows each,
// run wgmma m64n128k16 on the slots that have arrived, one step's group in
// flight while the next is issued, regroup their fp32 accumulators so that
// each lane holds 8 consecutive columns (quad_columns), and hand them to
// the epilogue (Epi), which reads and writes 16 or 32 bytes a lane. TMA zero-fills rows
// past the end of an operand, so any M and K are taken; N must be a
// multiple of BN.
//
// Shared-memory layout of a slot, 128-byte swizzle throughout (the TMA
// boxes are 64 bf16 = 128 bytes wide):
//   K-major: one box of [128 rows x 64 k]; 8-row groups 1024 bytes apart
//     (the descriptor's stride byte offset), k slices 32 bytes apart.
//   MN-major: two boxes of [64 k x 64 columns], 8 KB apart; inside a box
//     8-k groups 1024 bytes apart (stride byte offset), 16-k slices 2048
//     bytes apart; the two 64-column halves are the descriptor's leading
//     byte offset apart (8 KB), which only B needs: a warpgroup's 64 rows
//     of A are one half.
#pragma once

#include "cluster.cuh"

namespace uc2 {
namespace gemm {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int NWG = 2;                       // consumer warpgroups
constexpr int THREADS = 128 * NWG + 32;      // + the producer warp
constexpr int STAGES = 3;
constexpr int TILE_BYTES = BM * BK * 2;      // A or B of one slot: 16 KB
constexpr int HALF_BYTES = TILE_BYTES / 2;   // one 64-row (or 64-column) half
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int OFF_RED = STAGES * STAGE_BYTES;      // epilogue scratch [8][BN] fp32
constexpr int OFF_BAR = OFF_RED + 4 * NWG * BN * 4;
constexpr int SMEM = OFF_BAR + 2 * STAGES * 8 + 1024;
static_assert(BM == 64 * NWG && BN == 128, "the products below are m64n128k16");

// wgmma descriptor of a 128-byte-swizzled operand: stride byte offset 1024
// (8-row or 8-k groups), leading byte offset lbo (MN-major halves)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d += A . B^T, m64n128k16, A and B from shared memory; TA / TB: the
// operand is MN-major (wgmma's transpose bit)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(1), "n"(TA), "n"(TB));
}

// What the epilogue gets besides the product: v[k][hi][e] (quad_columns)
// holds row `row + 8 hi`, column col + 32 k + e, col = n0 + 8 t
struct Tile {
  int row, col, g, t;
  int cw;      // consumer warp 0 .. 7, in row order
  float* red;  // [8][BN] fp32 shared scratch
};

// wgmma leaves column 8 c + 2 t + j of a row in acc[4 c + 2 hi + j]: a
// quad's four lanes hold 8 consecutive columns two by two. A 4 x 4
// transpose over the quad's lanes regroups them so that each lane holds 8
// consecutive columns (16- and 32-byte loads and stores in the epilogue):
// v[k][hi][e] is row hi's column 32 k + 8 t + e. In round m lane t sends
// its pair of group 4 k + (t ^ m) and receives the pair of group 4 k + t
// that lane t ^ m holds; the lane-dependent picks are selects, so
// everything stays in registers.
__device__ __forceinline__ void quad_columns(const float (&acc)[64], float (&v)[BN / 32][2][8],
                                             int t) {
#pragma unroll
  for (int k = 0; k < BN / 32; ++k)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int other = t ^ m;
        float s0 = acc[16 * k + 2 * hi], s1 = acc[16 * k + 2 * hi + 1];
#pragma unroll
        for (int j = 1; j < 4; ++j)
          if (other == j) s0 = acc[16 * k + 4 * j + 2 * hi], s1 = acc[16 * k + 4 * j + 2 * hi + 1];
        const float r0 = __shfl_xor_sync(0xffffffffu, s0, m);
        const float r1 = __shfl_xor_sync(0xffffffffu, s1, m);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (other == j) v[k][hi][2 * j] = r0, v[k][hi][2 * j + 1] = r1;
      }
}

// the 256 consumer threads meet (named barrier 1; the producer warp has left)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NWG) : "memory");
}

// column totals over the 8 row groups of a warp (lanes t, t + 4, ..);
// lanes 0..3 hold them
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// The tile's column sums in a fixed order (within a warp, then warps 0..7):
// v[k][j] is this thread's sum over its rows of column col + 32 k + j;
// out[0 .. BN) receives the tile's totals. Every consumer thread calls it.
__device__ __forceinline__ void column_sums(float (&v)[BN / 32][8], const Tile& e,
                                            float* __restrict__ out) {
#pragma unroll
  for (int k = 0; k < BN / 32; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float s = group_sum(v[k][j]);
      if (e.g == 0) e.red[e.cw * BN + 32 * k + 8 * e.t + j] = s;
    }
  consumer_sync();
  const int i = threadIdx.x;
  if (i < BN) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 4 * NWG; ++w) s += e.red[w * BN + i];
    out[i] = s;
  }
}

// C = A . B^T for the tile (blockIdx.y, blockIdx.x) over K steps
// [blockIdx.z * k_per_split, + k_per_split) of K; epi(v, tile, M) writes
// it. amap / bmap: [*, 64]-wide boxes of 128 (K-major) or 64 (MN-major) rows.
template <int TA, int TB, class Epi>
__global__ void __launch_bounds__(THREADS, 2)
    gemm_kernel(const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap bmap, int M, int K, int k_per_split,
                const Epi epi) {
  using namespace stream;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t full = base + OFF_BAR, empty = full + 8 * STAGES;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int steps = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);         // the producer's arrival (+ the bytes)
      mbar_init(empty + 8 * s, 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // -------------------------------------- producer
    if (lane == 0) {
      for (int s = 0; s < steps; ++s) {
        const int st = s % STAGES, k0 = k_begin + s * BK;
        mbar_wait(empty + 8 * st, ((s / STAGES) & 1) ^ 1);
        const uint32_t a = base + st * STAGE_BYTES, b = a + TILE_BYTES, bar = full + 8 * st;
        mbar_arrive_expect_tx(bar, STAGE_BYTES);
        if (TA) {
          tma_load_2d(a, &amap, bar, m0, k0);
          tma_load_2d(a + HALF_BYTES, &amap, bar, m0 + 64, k0);
        } else {
          tma_load_2d(a, &amap, bar, k0, m0);
        }
        if (TB) {
          tma_load_2d(b, &bmap, bar, n0, k0);
          tma_load_2d(b + HALF_BYTES, &bmap, bar, n0 + 64, k0);
        } else {
          tma_load_2d(b, &bmap, bar, k0, n0);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = warp >> 2;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int s = 0; s < steps; ++s) {
    const int st = s % STAGES;
    mbar_wait(full + 8 * st, (s / STAGES) & 1);
    const uint32_t a = base + st * STAGE_BYTES + wg * HALF_BYTES;
    const uint32_t b = base + st * STAGE_BYTES + TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss_n128<TA, TB>(acc, sw128_desc(a + (TA ? 2048 : 32) * kk, 16),
                            sw128_desc(b + (TB ? 2048 : 32) * kk, TB ? HALF_BYTES : 16));
    wgmma_commit();
    wgmma_wait<1>();  // step s - 1's products are done: its slot is free
    if (s > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * ((s - 1) % STAGES));
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  float v[BN / 32][2][8];
  quad_columns(acc, v, lane & 3);
  const Tile tile{m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2), n0 + 8 * (lane & 3), lane >> 2,
                  lane & 3, warp, reinterpret_cast<float*>(smem + OFF_RED)};
  epi(v, tile, M);
}

// C = A . B^T on stream: M x N (N a multiple of BN) over K, K split into
// `splits` parts (grid z) of whole K steps
template <int TA, int TB, class Epi>
inline cudaError_t run(const CUtensorMap& amap, const CUtensorMap& bmap, int M, int N, int K,
                       int splits, const Epi& epi, cudaStream_t stream) {
  auto kernel = gemm_kernel<TA, TB, Epi>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const int steps = (K + BK - 1) / BK;
  const int per_split = (steps + splits - 1) / splits * BK;
  kernel<<<dim3(N / BN, (M + BM - 1) / BM, splits), THREADS, SMEM, stream>>>(amap, bmap, M, K,
                                                                             per_split, epi);
  return cudaGetLastError();
}

// the 2-D tensor map of a [outer, inner] bf16 row-major operand read
// K-major (boxes of 128 rows) or MN-major (boxes of 64 rows)
inline bool operand_map(CUtensorMap* map, const void* ptr, int inner, int outer, bool mn_major) {
  return stream::map_2d(map, ptr, inner, outer, mn_major ? 64 : BM);
}

}  // namespace gemm
}  // namespace uc2
