// Attention with unnormalised bf16 probabilities, kernel #11 (the kernel
// lab's "v4bf16"):
//   s = q.k^T * scale + bias (fp32);  e = bf16(exp(s - max s));
//   out = (e . v, fp32 sums) / sum(fp32(e)), rounded to bf16
//
// Replaces the TPU kernel scripts/kernel_lab.py:_kernel_bf16 (launched by
// _fwd_v4), the lab's candidate that keeps the [L, L] probabilities in
// bf16 and divides after the product. It differs from #1 (attention.cu),
// which normalises in fp32 and then rounds, by up to 2^-8 of a probability.
//
// Design: this file is only the C entry. The kernel is the streamed
// wgmma/TMA core of attention_stream.cuh (#1, #4 and #5 share it) in its
// BF16P mode: one block per (64 query rows, head, batch row), a producer
// warp feeding K and V tiles by TMA, sweep 1 the row max, sweep 2 the
// unnormalised exp2 rounded to bf16 in the wgmma A fragments with the
// row sums of the rounded values, the context scaled by 1 / sum before
// the bf16 TMA store. Inputs are read in their [B, L, n, d] layout,
// tokens rs apart (views into one QKV projection).
//
// What bounds it on an H100: bytes, as #1. At B = 64, L = 162, 12 heads of
// 64 it reads q, k, v and the bias and writes the output, 63.7 MB (0.019 ms
// at 3.35 TB/s), against 5.2 GFLOP of products (0.005 ms). Like #1 it
// makes the two sweeps' exp2 and computes Q . K^T twice, and the card
// runs it at #1's pace (PERF.md).
#include "attention_stream.cuh"

// q, k, v: [B, L, n, 64] bf16, tokens rs elements apart; bias [B, L] fp32;
// out [B, L, n, 64] bf16 contiguous; 1 <= L <= 512. Returns
// cudaGetLastError().
extern "C" int uc2_attn_bf16_fwd(const void* q, const void* k, const void* v,
                                 const void* bias, void* out, int B, int L, int n,
                                 int rs, float scale, void* stream) {
  using namespace uc2;
  return stream::attention<false, true>(q, k, v, bias, out, B, L, n, rs, scale,
                                        Dropout{0u, 0u, 1.f},
                                        static_cast<cudaStream_t>(stream));
}
