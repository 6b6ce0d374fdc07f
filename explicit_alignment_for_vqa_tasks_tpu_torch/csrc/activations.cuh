// The fp32 activations of the port's GEMM epilogues, one copy for every
// kernel that uses them (gpt2_block.cu, t5_ffn.cu, vit_block.cu,
// vit_block_q8.cu, int8_encoder.cu), in the JAX functions' order of
// rounding. Every multiply and add is written with __fmul_rn / __fadd_rn so
// that nvcc cannot contract them into FMAs that the plain PyTorch versions
// do not have; the exponential and tanh are expf and tanhf (the build has
// no --use_fast_math).
//
//   quick_gelu       z * (1 / (1 + exp(-1.702 z))), the division correctly
//                    rounded
//   quick_gelu_fast  the same through rcp_rn_normal, branch-free, with a
//                    flag for the rare z whose denominator is out of its
//                    range (the caller redoes those with quick_gelu), and
//                    equal to quick_gelu wherever z >= QUICK_GELU_FAST_FLOOR;
//                    vit_block_q8.cu's quick_gelu_check holds both over all
//                    2^32 floats
//   tanh_gelu        0.5 z (1 + tanh(0.7978845608028654 (z + 0.044715 z z
//                    z))), left to right as the JAX _tanh_gelu writes it

#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace activations {

__device__ inline float quick_gelu(float z) {
  // z * sigmoid(1.702 z), the sigmoid as 1 / (1 + exp(-x))
  const float e = expf(-__fmul_rn(1.702f, z));
  return __fmul_rn(z, __fdiv_rn(1.0f, __fadd_rn(1.0f, e)));
}

// 1 / d correctly rounded for d in [1, 2^126): the reciprocal's estimate and
// two Newton steps on the FMA. There it equals __fdiv_rn(1.0f, d), without
// the division's slow-path branch, which keeps an epilogue's elements from
// overlapping: with it the int8 ViT-L up-GEMM at B=256 took 2.16 ms on an
// H100, without it 1.56.
__device__ __forceinline__ float rcp_rn_normal(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  const float y = __fmaf_rn(r, __fmaf_rn(-d, r, 1.0f), r);
  return __fmaf_rn(y, __fmaf_rn(-d, y, 1.0f), y);
}

// quick_gelu(z) through rcp_rn_normal; sets `slow` where 1 + exp(-1.702 z)
// is not in [1, 2^126) (z below about -51, or NaN), whose value the caller
// computes again with quick_gelu. It never does for z >= -50 (where the
// sum is below e^85.1 < 2^123): a caller may instead test z against this
// floor before it computes anything.
constexpr float QUICK_GELU_FAST_FLOOR = -50.0f;

__device__ __forceinline__ float quick_gelu_fast(float z, bool& slow) {
  const float d = __fadd_rn(1.0f, expf(-__fmul_rn(1.702f, z)));
  slow |= !(d < 0x1p126f);
  return __fmul_rn(z, rcp_rn_normal(d));
}

__device__ inline float tanh_gelu(float z) {
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, z), z), z);
  const float t = tanhf(__fmul_rn(0.7978845608028654f, __fadd_rn(z, cube)));
  return __fmul_rn(__fmul_rn(0.5f, z), __fadd_rn(1.0f, t));
}

}  // namespace activations
