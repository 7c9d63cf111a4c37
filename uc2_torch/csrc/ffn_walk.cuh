// The FFN walk that the cluster kernels share: #3 and #9
// (fused_ffn_block.cu) and the whole-layer kernel #8 (fused_layer_block.cu).
// A 64-row tile belongs to a cluster of two blocks; block `rank` owns
// output columns 384 rank .. + 383, two consumer warpgroups 192 each, and
// a producer warpgroup whose warps 0 and 1 feed one consumer warpgroup's
// ring each. The [64 x 768] bf16 input tile sits in twelve swizzled boxes
// at offset 0 of shared memory. fused_ffn_block.cu explains the design:
//   feed   producer warp w's loads, in its warpgroup's order: W1 boxes of
//          the chunks whose h the warpgroup computes, W2 slots of every
//          chunk;
//   walk   GEMM 1 (h = gelu_erf(x . W1^T + b1) in bf16, one chunk of 64
//          columns a warpgroup in turn, published to both blocks) and
//          GEMM 2 (y += h . W2^T for the warpgroup's 192 columns, 96 fp32
//          accumulators a thread), after the input tile's barrier.
#pragma once

#include <climits>

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

// The walk's barriers: full[wg][STAGES], empty[wg][STAGES], the input
// tile's x, h full[NH], h empty[NH]
struct Bars {
  uint32_t full, empty, x, hfull, hempty;
  __device__ __forceinline__ explicit Bars(uint32_t base)
      : full(base + Cfg::OFF_BAR),
        empty(full + 8 * Cfg::NWG * Cfg::STAGES),
        x(empty + 8 * Cfg::NWG * Cfg::STAGES),
        hfull(x + 8),
        hempty(hfull + 8 * Cfg::NH) {}
  // by one thread; x_arrivals: the arrivals that complete the input tile
  __device__ __forceinline__ void init(uint32_t x_arrivals) const {
    for (int s = 0; s < Cfg::NWG * Cfg::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer warp (+ the bytes)
      mbar_init(empty + 8 * s, 4);  // the consumer warpgroup's warps
    }
    mbar_init(x, x_arrivals);
    for (int b = 0; b < Cfg::NH; ++b) {
      mbar_init(hfull + 8 * b, 1);                  // the warpgroup that wrote the h buffer
      mbar_init(hempty + 8 * b, 4 * 2 * Cfg::NWG);  // every consumer warp of the cluster
    }
  }
};

// Producer warp w's loads (one lane): the slots from <= s < to of its
// warpgroup's order, F / 64 chunks. With to = INT_MAX (the order's end),
// it then waits for the last slots to be given back (a consumer that never
// gets its data shows as a trap here rather than as a hang).
__device__ __forceinline__ void feed(int w, int rank, uint32_t base, const Bars& br,
                                     const CUtensorMap* w1map, const CUtensorMap* w2map,
                                     int n_chunks, int from, int to) {
  using C = Cfg;
  constexpr int STAGES = C::STAGES;
  const uint32_t my_full = br.full + 8 * w * STAGES, my_empty = br.empty + 8 * w * STAGES;
  const uint32_t my_ring = base + C::OFF_RING + w * STAGES * C::SLOT;
  int s = 0;
  auto load = [&](uint32_t bytes, const CUtensorMap* map, int c0, int c1) {
    if (s >= from && s < to) {
      const int st = s % STAGES;
      mbar_wait(my_empty + 8 * st, ((s / STAGES) & 1) ^ 1);
      mbar_arrive_expect_tx(my_full + 8 * st, bytes);
      tma_load_2d(my_ring + st * C::SLOT, map, my_full + 8 * st, c0, c1);
    }
    ++s;
  };
  // the consumer warpgroup's order: W1 of chunk i + AHEAD where it
  // computes that chunk's h, then W2 of chunk i
  for (int i = -C::AHEAD; i < n_chunks; ++i) {
    const int j = i + C::AHEAD;
    if (j < n_chunks && (j & 3) == 2 * w + rank) {
      for (int q = 0; q < C::KB; ++q)  // the chunk's rows, inputs 64 q ..
        load(C::BOX, w1map, 64 * q, C::FC * j);
    }
    if (i < 0) continue;
    for (int h = 0; h < C::NW2; ++h)  // W2 rows 384 rank + 192 w + W2_ROWS h .., chunk i's columns
      load(C::SLOT, w2map, C::FC * i, C::OUT_BLOCK * rank + C::OUT_WG * w + C::W2_ROWS * h);
  }
  if (to == INT_MAX)
    for (int e = s; e < s + STAGES; ++e)
      mbar_wait(my_empty + 8 * (e % STAGES), ((e / STAGES) & 1) ^ 1);
}

// Consumer warpgroup wg's walk: y[h] += h . W2^T over every chunk, for
// output columns 384 rank + 192 wg + W2_ROWS h + 8 jj + 2 t (+1), after
// the input tile's barrier (phase 0)
__device__ __forceinline__ void walk(float (&y)[Cfg::NW2][Cfg::ACC], uint8_t* smem,
                                     uint32_t base, const Bars& br, int rank, int wg,
                                     const float* __restrict__ b1, int n_chunks) {
  using C = Cfg;
  constexpr int STAGES = C::STAGES;
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int r = wl * 16 + g;  // this thread's rows: r and r + 8 of the tile
  const int peer = rank ^ 1;
  const uint32_t xs = base, hs = base + C::OFF_H;
  const uint32_t my_full = br.full + 8 * wg * STAGES, my_empty = br.empty + 8 * wg * STAGES;
  const uint32_t my_ring = base + C::OFF_RING + wg * STAGES * C::SLOT;
  int s = 0;  // this warpgroup's slots, in the producer's order
  auto wait_full = [&](int e) { spin_wait(my_full + 8 * (e % STAGES), (e / STAGES) & 1); };
  auto release = [&](int e) {  // this warp is done with slot e
    __syncwarp();
    if (lane == 0) mbar_arrive(my_empty + 8 * (e % STAGES));
  };

  spin_wait(br.x, 0);
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
      if (use > 0) spin_wait(br.hempty + 8 * hb, (use - 1) & 1);
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
        mbar_arrive(br.hfull + 8 * hb);
        const uint32_t peer_full = peer_addr(br.hfull + 8 * hb, peer);
        mbar_arrive_expect_tx_cluster(peer_full, C::BOX);
        bulk_copy_to_peer(peer_addr(hbuf, peer), hbuf, C::BOX, peer_full);
      }
    }
    if (i < 0) continue;

    // GEMM 2: y += h . W2^T of chunk i for this warpgroup's 192 columns
    const int hb = i % C::NH, use = i / C::NH;
    const uint32_t hbuf = hs + hb * C::BOX;
    spin_wait(br.hfull + 8 * hb, use & 1);
    uint32_t ha[4][4];  // the h tile's A fragments, k16 slices kk
    const int hr = wl * 16 + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldsm_x4(ha[kk], hbuf + hr * 128 + (((2 * kk + (lane >> 4)) ^ (hr & 7)) << 4));
    __syncwarp();
    // the buffer back to its writer, block i % 2
    if (lane == 0) mbar_arrive_cluster(peer_addr(br.hempty + 8 * hb, i & 1));
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
}

}  // namespace ffn
}  // namespace uc2
