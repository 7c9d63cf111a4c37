// Attention forward for inference, kernels #1 and #4:
// out = softmax(q.k^T / sqrt(d) + bias) . v
//
// Replaces two TPU kernels of uc2_tpu/ops/flash_attention.py that the
// reference's flash_attention chooses between in _fwd_dispatch:
// * #1, _attn_kernel_v3 (launched by _fwd_pallas_v3), while one batch
//   row's fp32 scores fit 8 MiB: the L = 98 scoring bucket at uc2-base,
//   and the long-caption buckets L = 174 and 339 at dropout 0. The lab's
//   v3, v3bb1, v3bb4 and v4qs racers run it too.
// * #4, _attn_kernel (launched by _fwd_pallas), above that: joint
//   L >= 419 at 12 heads, a training step at dropout 0 under "pallas" on
//   long captions (its backward is the eager recompute).
//
// The two compute one function: fp32 scores * (1 / sqrt(d)) + bias, a
// max-shifted softmax normalised in fp32 and rounded to bf16, P . V with
// fp32 sums, a bf16 context in the [B, L, n, d] layout; q, k, v may be
// strided views into the fused QKV projection. Only the TPU kernels' batch
// blocking differs, and a GPU has no use for it. So both wrappers
// (flash_attention_v3 and flash_attention_long) launch this one entry into
// the streamed wgmma/TMA core of attention_stream.cuh, as #5 does at rate
// 0, and give the same bits. What bounds it on an H100 is bytes (at B = 64,
// L = 98: q, k, v and the context, 38.5 MB, 11.5 us at 3.35 TB/s, against
// 1.9 GFLOP); the core's design is in its header.
#include "attention_stream.cuh"

extern "C" const char* uc2_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v: [B, L, n, 64] bf16, tokens rs elements apart; bias [B, L] fp32;
// out [B, L, n, 64] bf16 contiguous; 1 <= L <= 512. Returns
// cudaGetLastError().
extern "C" int uc2_attn_fwd(const void* q, const void* k, const void* v,
                            const void* bias, void* out, int B, int L, int n,
                            int rs, float scale, void* stream) {
  using namespace uc2;
  return stream::attention<false>(q, k, v, bias, out, B, L, n, rs, scale,
                                  Dropout{0u, 0u, 1.f}, static_cast<cudaStream_t>(stream));
}
