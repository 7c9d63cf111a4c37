// The pieces that the attention backward's passes share: #6's two passes
// (attention_train.cu) and #12b, the segment-masked keys pass
// (attention_segment.cu). Blocks of 64 rows (queries or keys), one
// consumer warpgroup and one producer warp feeding a ring of 64-row tiles,
// two blocks a SM; products by wgmma on 128-byte-swizzled tiles.
#pragma once

#include "attention_stream.cuh"

namespace uc2 {
namespace bwd {

using namespace stream;

// Both passes: 64-row blocks, one consumer warpgroup and one producer
// warp, 64-row tiles of the streamed operand, two blocks a SM
struct Cfg {
  static constexpr int T = 64;                     // rows of a block and of a tile
  static constexpr int THREADS = 128 + 32;
  static constexpr int MIN_BLOCKS = 2;
  static constexpr int STAGES = 4;                 // slots of the ring
  static constexpr int TILE = T * 128;             // one 64 x 64 bf16 tile, bytes
  static constexpr int WORDS = MAX_LEN / 64;       // keep-bit words of a row at most
  // pass 1: Q, G resident; the ring's K and V; the bias ring; the keep bits
  static constexpr int R_G = TILE, R_K = 2 * TILE, R_V = R_K + STAGES * TILE;
  static constexpr int R_BIAS = R_V + STAGES * TILE;
  static constexpr int R_BITS = R_BIAS + STAGES * T * 4;
  static constexpr int R_BAR = R_BITS + T * WORDS * 8;
  // pass 2: K, V resident; the ring's Q and G, statistics and keep bits
  static constexpr int K_V = TILE, K_Q = 2 * TILE, K_G = K_Q + STAGES * TILE;
  static constexpr int K_ST = K_G + STAGES * TILE;
  static constexpr int K_BITS = K_ST + STAGES * 3 * T * 4;
  static constexpr int K_BAR = K_BITS + STAGES * T * 8;
  static constexpr int BARS = (2 * STAGES + 1) * 8;
  static constexpr int SMEM_ROWS = R_BAR + BARS + 1024;  // + the alignment slack
  static constexpr int SMEM_KEYS = K_BAR + BARS + 1024;
};

// the 128-thread named barrier of the consumer warpgroup
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// acc = X . Y^T over the head dim (m64n64k16 x 4), X and Y 64-row K-major
// tiles; not committed
__device__ __forceinline__ void product_xyt(float (&acc)[32], uint32_t x, uint32_t y) {
  wgmma_ss_n64_first(acc, sw128_desc(x), sw128_desc(y));
#pragma unroll
  for (int kk = 1; kk < HEAD_DIM / 16; ++kk)
    wgmma_ss_n64(acc, sw128_desc(x + 32 * kk), sw128_desc(y + 32 * kk));
}

// acc += A . Y, A as bf16 fragments over 64 rows of Y, Y read MN-major; not
// committed
__device__ __forceinline__ void product_ay(float (&acc)[32], const uint32_t (&a)[4][4],
                                           uint32_t y) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(acc, a[kk], sw128_desc(y + kk * 16 * 128));
}

// accumulator columns 8c + 2t, + 1 of rows g, g + 8 rounded to A fragments
// (keys, or queries, 16 kk .. + 15 are column groups 2 kk, 2 kk + 1)
__device__ __forceinline__ void to_frags(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    a[c >> 1][2 * (c & 1) + 0] = pack2(x[4 * c + 0], x[4 * c + 1]);
    a[c >> 1][2 * (c & 1) + 1] = pack2(x[4 * c + 2], x[4 * c + 3]);
  }
}

// x * s rounded to bf16 into a 64-row tile of shared memory in the 128-byte
// swizzle (as TMA reads it): this warp's rows wl * 16 + g, + 8
__device__ __forceinline__ void to_tile(uint8_t* tile, const float (&x)[32], float s, int wl,
                                        int g, int t) {
  const int r = wl * 16 + g;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    *reinterpret_cast<uint32_t*>(tile + r * 128 + ((c ^ g) << 4) + 4 * t) =
        pack2(x[4 * c] * s, x[4 * c + 1] * s);
    *reinterpret_cast<uint32_t*>(tile + (r + 8) * 128 + ((c ^ g) << 4) + 4 * t) =
        pack2(x[4 * c + 2] * s, x[4 * c + 3] * s);
  }
}

// Launch kernel on grid (L / 64 rounded up, n, B) with smem bytes
template <typename Kernel, typename... Args>
inline int launch(Kernel kernel, int smem, int B, int L, int n, cudaStream_t stream,
                  Args... args) {
  // on every call: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + Cfg::T - 1) / Cfg::T, n, B);
  kernel<<<grid, Cfg::THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace bwd
}  // namespace uc2
