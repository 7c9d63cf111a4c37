// Attention with unnormalised bf16 probabilities (the kernel lab's "v4bf16"):
//   s = q.k^T * scale + bias (fp32);  e = bf16(exp(s - max s));
//   out = (e . v, fp32 sums) / sum(fp32(e)), rounded to bf16
//
// Replaces the TPU kernel scripts/kernel_lab.py:_kernel_bf16 (launched by
// _fwd_v4), the lab's candidate that keeps the [L, L] probabilities in
// bf16 and divides after the product. It differs from #1 (attention.cu),
// which normalises in fp32 and then rounds, by up to 2^-8 of a probability.
//
// What bounds it on an H100: bytes, as #1. At B = 64, L = 162, 12 heads of
// 64 it reads q, k, v and the bias and writes the output, 63.7 MB (0.019 ms
// at 3.35 TB/s), against 5.2 GFLOP of products (0.005 ms).
//
// Design: #1's. One block of 4 warps per (query tile of 64 rows, head,
// batch row); attn_scores (common.cuh) puts the fp32 score rows of the
// tile in shared memory; each warp turns its rows into bf16 e in place and
// keeps each row's sum of the rounded e in the row's first padding float;
// V^T replaces K, and each warp's P.V product divides its fp32 sums by the
// row's sum before the bf16 store. Inputs are read in their [B, L, n, d]
// layout, tokens rs apart (views into one QKV projection).
#include "common.cuh"

namespace uc2 {

// Softmax phase: e = bf16(exp(s - max s)) over the front of each score row,
// the row's sum of fp32(e) at float Lp of the row (past the scores).
template <int WARPS, int QT, int NC>
__device__ void attn_exp_bf16(int L, uint8_t* smem) {
  const int Lp = padded_len(L);
  const int SF = score_stride(Lp);
  const AttnSmem sm = attn_smem(smem, Lp, QT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < QT; r += WARPS) {
    float* srow = sm.S + r * SF;
    float s[NC];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      s[i] = c < Lp ? srow[c] : -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
    mx = warp_max(mx);
    bf16 e[NC];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      e[i] = __float2bfloat16(c < Lp ? expf(s[i] - mx) : 0.f);
      sum += __bfloat162float(e[i]);
    }
    sum = warp_sum(sum);
    __syncwarp();
    bf16* prow = reinterpret_cast<bf16*>(srow);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < Lp) prow[c] = e[i];
    }
    if (lane == 0) srow[Lp] = sum;
  }
}

// V^T into the K region, then out = (e . V) / row sum for the tile's rows
// (attn_pv's staging and product, with the division before the store).
template <int WARPS, int QT>
__device__ void attn_pv_divide(const bf16* __restrict__ vh, int rs, int L,
                               uint8_t* smem, bf16* out, int out_rs, int out_rows) {
  constexpr int MT = QT / 16;
  constexpr int WPM = WARPS / MT;
  constexpr int NPW = 8 / WPM;
  static_assert(WARPS % MT == 0 && 8 % WPM == 0, "warp layout");
  const int Lp = padded_len(L);
  const int SF = score_stride(Lp);
  const int VS = vt_stride(Lp);
  const AttnSmem sm = attn_smem(smem, Lp, QT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m = warp % MT, wj = warp / MT;

  for (int i = tid; i < Lp * 8; i += WARPS * 32) {
    const int key = i >> 3, c = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (key < L) val = *reinterpret_cast<const uint4*>(vh + (size_t)key * rs + c);
    const bf16* pv = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int u = 0; u < 8; ++u) sm.KV[(c + u) * VS + key] = pv[u];
  }
  __syncthreads();

  float acc[NPW][4];
#pragma unroll
  for (int p = 0; p < NPW; ++p) acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.f;
  const uint32_t* Pw = reinterpret_cast<const uint32_t*>(sm.S);
  const uint32_t* Vw = reinterpret_cast<const uint32_t*>(sm.KV);
  const int pa = (m * 16 + g) * SF, pb = pa + 8 * SF;
  for (int kk = 0; kk < Lp / 16; ++kk) {
    uint32_t a[4];
    a[0] = Pw[pa + kk * 8 + t];
    a[1] = Pw[pb + kk * 8 + t];
    a[2] = Pw[pa + kk * 8 + t + 4];
    a[3] = Pw[pb + kk * 8 + t + 4];
#pragma unroll
    for (int p = 0; p < NPW; ++p) {
      const uint32_t* vr = Vw + ((wj + p * WPM) * 8 + g) * (VS / 2) + kk * 8 + t;
      mma16816(acc[p], a, vr[0], vr[4]);
    }
  }
  const int ra = m * 16 + g, rb = ra + 8;
  const float da = sm.S[ra * SF + Lp], db = sm.S[rb * SF + Lp];
#pragma unroll
  for (int p = 0; p < NPW; ++p) {
    const int col = (wj + p * WPM) * 8 + t * 2;
    if (ra < out_rows)
      *reinterpret_cast<uint32_t*>(out + (size_t)ra * out_rs + col) =
          pack2(acc[p][0] / da, acc[p][1] / da);
    if (rb < out_rows)
      *reinterpret_cast<uint32_t*>(out + (size_t)rb * out_rs + col) =
          pack2(acc[p][2] / db, acc[p][3] / db);
  }
}

template <int WARPS, int QT, int NC>
__global__ void __launch_bounds__(WARPS * 32)
    attn_bf16_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ bias,
                         bf16* __restrict__ out, int L, int n, int rs, float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const size_t base = (size_t)b * L * rs + (size_t)h * HEAD_DIM;
  bf16* o = out + ((size_t)b * L + q0) * n * HEAD_DIM + (size_t)h * HEAD_DIM;
  attn_scores<WARPS, QT>(q + base, k + base, rs, bias + (size_t)b * L, L, q0, scale, smem);
  attn_exp_bf16<WARPS, QT, NC>(L, smem);
  attn_pv_divide<WARPS, QT>(v + base, rs, L, smem, o, n * HEAD_DIM, min(QT, L - q0));
}

}  // namespace uc2

// q, k, v: [B, L, n, 64] bf16, tokens rs elements apart; bias [B, L] fp32;
// out [B, L, n, 64] bf16 contiguous; 1 <= L <= 512. Returns
// cudaGetLastError().
extern "C" int uc2_attn_bf16_fwd(const void* q, const void* k, const void* v,
                                 const void* bias, void* out, int B, int L, int n,
                                 int rs, float scale, void* stream) {
  using namespace uc2;
  constexpr int WARPS = 4, QT = 64;
  if (L < 1 || L > MAX_LEN) return (int)cudaErrorInvalidValue;
  const size_t smem = attend_smem_bytes(QT, L);
  return with_score_chunks(L, [&](auto nc) {
    constexpr int NC = decltype(nc)::value;
    auto kernel = attn_bf16_fwd_kernel<WARPS, QT, NC>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((L + QT - 1) / QT, n, B);
    kernel<<<grid, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const float*>(bias),
        static_cast<bf16*>(out), L, n, rs, scale);
    return (int)cudaGetLastError();
  });
}
