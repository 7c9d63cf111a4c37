// The mma.sync weight walk of the whole-layer block (#8,
// fused_layer_block.cu). The FFN blocks (#3 and the training forward #9,
// fused_ffn_block.cu) and the training FFN backward (#10,
// ffn_train_bwd.cu) have wgmma/TMA kernels of their own.
//
// One block of 8 warps owns a tile of 32 rows of x (staged in shared
// memory) and walks the intermediate width F in chunks of 64. Per chunk
// the weights stream through shared memory as 16 KB tiles: six [64 x 128]
// slices of W1 (rows of the chunk, 128 inputs each), then six [128 x 64]
// slices of W2 (128 outputs, the chunk's columns), in a ring of STAGES
// buffers filled by cp.async, so that the loads of the next tiles overlap
// the products on this one. Every product is mma.sync.m16n8k16 bf16 with
// fp32 sums.
#pragma once

#include "common.cuh"

namespace uc2 {

constexpr int FFN_WARPS = 8;
constexpr int FFN_THREADS = FFN_WARPS * 32;
constexpr int FFN_ROWS = 32;
constexpr int FFN_CHUNK = 64;               // intermediate columns per step
constexpr int H_STRIDE = FFN_CHUNK + 8;     // bf16 per row of the GELU tile
constexpr int K_SLICE = 128;                // W1 tile: 64 rows x 128 inputs
constexpr int W1_STRIDE = K_SLICE + 8;
constexpr int N_SLICE = 128;                // W2 tile: 128 rows x 64 inputs
constexpr int W2_STRIDE = FFN_CHUNK + 8;
constexpr int W1_TILES = HIDDEN / K_SLICE;  // 6
constexpr int CHUNK_TILES = W1_TILES + HIDDEN / N_SLICE;  // 12
constexpr int STAGES = 6;
static_assert(FFN_CHUNK * K_SLICE / 8 % FFN_THREADS == 0 &&
              N_SLICE * FFN_CHUNK / 8 % FFN_THREADS == 0, "tile copy split");
constexpr int STAGE_ELEMS = N_SLICE * W2_STRIDE > FFN_CHUNK * W1_STRIDE
                                ? N_SLICE * W2_STRIDE
                                : FFN_CHUNK * W1_STRIDE;
// Start the copies of weight tile `idx` of the forward walk into `stage`.
__device__ __forceinline__ void load_tile(bf16* stage, const bf16* __restrict__ w1,
                                          const bf16* __restrict__ w2, int F,
                                          int idx) {
  const int c = idx / CHUNK_TILES, r = idx % CHUNK_TILES;
  if (r < W1_TILES) {  // W1 rows [64c, 64c + 64), inputs [128r, 128r + 128)
#pragma unroll
    for (int i = 0; i < FFN_CHUNK * K_SLICE / 8 / FFN_THREADS; ++i) {
      const int s = threadIdx.x + i * FFN_THREADS;
      const int row = s / (K_SLICE / 8), seg = s % (K_SLICE / 8);
      cp_async16(stage + row * W1_STRIDE + seg * 8,
                 w1 + (size_t)(c * FFN_CHUNK + row) * HIDDEN + r * K_SLICE + seg * 8);
    }
  } else {  // W2 rows [128(r - 6), +128), intermediate [64c, 64c + 64)
    const int n0 = (r - W1_TILES) * N_SLICE;
#pragma unroll
    for (int i = 0; i < N_SLICE * FFN_CHUNK / 8 / FFN_THREADS; ++i) {
      const int s = threadIdx.x + i * FFN_THREADS;
      const int row = s / (FFN_CHUNK / 8), seg = s % (FFN_CHUNK / 8);
      cp_async16(stage + row * W2_STRIDE + seg * 8,
                 w2 + (size_t)(n0 + row) * F + c * FFN_CHUNK + seg * 8);
    }
  }
}

// Start loading the first STAGES - 1 tiles of the forward walk (before x
// is staged, so that the two overlap).
__device__ __forceinline__ void ffn_walk_prologue(bf16* ring, const bf16* __restrict__ w1,
                                                  const bf16* __restrict__ w2, int F) {
  const int n_tiles = (F / FFN_CHUNK) * CHUNK_TILES;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) load_tile(ring + i * STAGE_ELEMS, w1, w2, F, i);
    cp_async_commit();
  }
}

// The forward walk, after ffn_walk_prologue and with x staged in xs:
// acc += gelu_erf(x . W1^T + b1) . W2^T (acc holds the whole-layer block's
// x2 + b2), fp32, the GELU output rounded to bf16 where the TPU kernels
// round it. acc[m][j] holds rows m*16 + g (+8) and columns out_col(warp,
// j) + 2t (+1) (common.cuh). Ends with every copy landed.
__device__ __forceinline__ void ffn_forward_walk(const bf16* xs, bf16* hs, bf16* ring,
                                                 const bf16* __restrict__ w1,
                                                 const float* __restrict__ b1,
                                                 const bf16* __restrict__ w2, int F,
                                                 float (&acc)[2][12][4]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (F / FFN_CHUNK) * CHUNK_TILES;
  float hacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  const uint32_t* Xw = reinterpret_cast<const uint32_t*>(xs);
  const uint32_t* Hw = reinterpret_cast<const uint32_t*>(hs);
  constexpr int XW = ROW_STRIDE / 2, HWS = H_STRIDE / 2;
  constexpr int T1 = W1_STRIDE / 2, T2 = W2_STRIDE / 2;
  // first product: warp -> m-tile (warp & 1), chunk columns jp*8 .. jp*8+15
  const int m1 = warp & 1, jp = (warp >> 1) * 2;
  const int xa = (m1 * 16 + g) * XW, xb = xa + 8 * XW;

  for (int idx = 0; idx < n_tiles; ++idx) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile idx landed
    __syncthreads();              // everyone's did; tile idx - 1 is consumed
    if (idx + STAGES - 1 < n_tiles)
      load_tile(ring + ((idx + STAGES - 1) % STAGES) * STAGE_ELEMS, w1, w2, F,
                idx + STAGES - 1);
    cp_async_commit();
    const uint32_t* Tw = reinterpret_cast<const uint32_t*>(ring + (idx % STAGES) * STAGE_ELEMS);
    const int c = idx / CHUNK_TILES, r = idx % CHUNK_TILES;
    if (r < W1_TILES) {
      if (r == 0) {
#pragma unroll
        for (int p = 0; p < 2; ++p) hacc[p][0] = hacc[p][1] = hacc[p][2] = hacc[p][3] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < K_SLICE / 16; ++ks) {
        const int xk = r * (K_SLICE / 2) + ks * 8 + t;
        uint32_t a[4];
        a[0] = Xw[xa + xk];
        a[1] = Xw[xb + xk];
        a[2] = Xw[xa + xk + 4];
        a[3] = Xw[xb + xk + 4];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint32_t* br = Tw + ((jp + p) * 8 + g) * T1 + ks * 8 + t;
          mma16816(hacc[p], a, br[0], br[4]);
        }
      }
      if (r == W1_TILES - 1) {  // the chunk's GELU tile, read after the next barrier
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int col = (jp + p) * 8 + t * 2;
          const float c0 = b1[c * FFN_CHUNK + col], c1 = b1[c * FFN_CHUNK + col + 1];
          bf16* hr = hs + (m1 * 16 + g) * H_STRIDE + col;
          const uint32_t h0 = pack2(gelu_erf(hacc[p][0] + c0), gelu_erf(hacc[p][1] + c1));
          const uint32_t h1 = pack2(gelu_erf(hacc[p][2] + c0), gelu_erf(hacc[p][3] + c1));
          *reinterpret_cast<uint32_t*>(hr) = h0;
          *reinterpret_cast<uint32_t*>(hr + 8 * H_STRIDE) = h1;
        }
      }
    } else {
      // second product on W2 rows [128s, 128s + 128): this warp's two
      // accumulator tiles 2s, 2s + 1 (static indices, so they stay in registers)
      const int s = r - W1_TILES;
#pragma unroll
      for (int ss = 0; ss < HIDDEN / N_SLICE; ++ss) {
        if (ss != s) continue;
#pragma unroll
        for (int ks = 0; ks < FFN_CHUNK / 16; ++ks) {
          uint32_t a[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int hr = (m * 16 + g) * HWS + ks * 8 + t;
            a[m][0] = Hw[hr];
            a[m][1] = Hw[hr + 8 * HWS];
            a[m][2] = Hw[hr + 4];
            a[m][3] = Hw[hr + 8 * HWS + 4];
          }
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const uint32_t* br = Tw + (warp * 16 + p * 8 + g) * T2 + ks * 8 + t;
            mma16816(acc[0][2 * ss + p], a[0], br[0], br[4]);
            mma16816(acc[1][2 * ss + p], a[1], br[0], br[4]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

}  // namespace uc2
