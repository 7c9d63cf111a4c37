// Attention forward for long joint lengths, kernel #4:
// out = softmax(q.k^T / sqrt(d) + bias) . v
//
// Replaces the TPU kernel uc2_tpu/ops/flash_attention.py:_attn_kernel
// (launched by _fwd_pallas), which the reference's flash_attention runs in
// place of the batch-blocked kernel when n * L^2 * 4 bytes > 8 MiB, that is
// joint L >= 419 at 12 heads: a training step at dropout 0 under "pallas"
// on long captions (its backward is the eager recompute).
//
// What it computes is _attn_kernel's: fp32 scores * (1 / sqrt(d)) + bias, a
// max-shifted softmax normalised in fp32 and rounded to bf16, P . V with
// fp32 sums, a bf16 context in the [B, L, n, d] layout; q, k, v may be
// strided views into the fused QKV projection. That is the training
// forward's function at rate 0, so both launch the streamed wgmma/TMA core
// of attention_stream.cuh (design, bound and tiles there).
#include "attention_stream.cuh"

// q, k, v: [B, L, n, 64] bf16, tokens rs elements apart; bias [B, L] fp32;
// out [B, L, n, 64] bf16 contiguous; 1 <= L <= 512. Returns
// cudaGetLastError().
extern "C" int uc2_attn_long_fwd(const void* q, const void* k, const void* v,
                                 const void* bias, void* out, int B, int L, int n,
                                 int rs, float scale, void* stream) {
  using namespace uc2;
  return stream::attention<false>(q, k, v, bias, out, B, L, n, rs, scale,
                                  Dropout{0u, 0u, 1.f}, static_cast<cudaStream_t>(stream));
}
