// Shared device code of the uc2_torch kernels (sm_90a): the widths they
// take, bf16 packing, the exact GELU and warp sums. The products are
// wgmma on TMA-fed shared memory (attention_stream.cuh, cluster.cuh,
// gemm.cuh and the kernels' own sources).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace uc2 {

typedef __nv_bfloat16 bf16;

constexpr int HEAD_DIM = 64;            // d of every head the kernels take
constexpr int MAX_LEN = 512;            // joint-length limit of the encoder
constexpr int HIDDEN = 768;             // H of the fused blocks (uc2-base)

// two floats rounded to bf16, lo in the low half (the lower address)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the exact (erf) GELU of the FFN blocks
__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace uc2
